"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one (the condition is a
string, evaluated when each test is set up, so every worker collects the same
tests). The file imports no JAX, so it runs on the GPU machine, which has
none; tests/conftest.py imports jax, so run it there with

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Tolerances: kernel vs plain version relative 1e-5 (max-abs error over
max-abs value) on arrays, 1e-4 on the front's scalars, the same TA bin (the
f32 sums run in another order; the TA is a discrete bin); the whole CUDA estimator
against the float64 CPU run of the same port at channel NMSE < 4e-11, the JAX
package's serve bound, and < 1e-12 in the reference layout (its ref bound);
bfloat16 grids within 1e-2 of the float32 grid's scale (bf16 keeps 8 bits).
The front's finish (`front_finish`) against its plain version: relative 1e-6
on the profiles and scalars, 2e-7 absolute on the rotation.
"""
import numpy as np
import pytest
import torch

from srsran_ce_tpu_torch.models import estimator as est
from srsran_ce_tpu_torch.models.plan import make_plan, plan_tensors
from srsran_ce_tpu_torch.ops.kernels import fill_rotate as k6
from srsran_ce_tpu_torch.ops.kernels import fill_rotate_serve as k2
from srsran_ce_tpu_torch.ops.kernels import front as k1
from srsran_ce_tpu_torch.ops.kernels import front_finish as kf
from srsran_ce_tpu_torch.ops.kernels import rc_smooth as k5
from srsran_ce_tpu_torch.utils import synthetic

NEEDS_GPU = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="needs a CUDA device: the kernels run only on the card"
)
FRONT_CASES = [
    ("nL4_2cdm", dict(n_prbs=106, n_layers=4, comb=2, snr_db=30.0)),
    ("nL1_cfo_off", dict(n_prbs=24, n_layers=1, comb=2, snr_db=25.0, cfo_compensate=False)),
    ("nL2_two_hops", dict(n_prbs=12, n_layers=2, comb=2, snr_db=30.0, two_hops=True)),
    ("nL3", dict(n_prbs=16, n_layers=3, comb=2, snr_db=30.0)),
    ("nL1_one_dmrs_sym", dict(n_prbs=8, n_layers=1, comb=2, snr_db=30.0, n_dmrs_syms=1)),
    # bands of one and two PRBs (as many REs as virtual pilots), a PRB hole, 8 layers
    ("one_prb", dict(n_prbs=1, n_layers=2, comb=2, snr_db=30.0)),
    ("one_prb_comb4_odd_band", dict(n_prbs=1, n_layers=4, comb=4, snr_db=30.0)),
    ("two_prbs", dict(n_prbs=2, n_layers=4, comb=2, snr_db=30.0)),
    ("prb_hole", dict(n_prbs=20, n_layers=3, comb=2, snr_db=30.0, prb_start=6, n_prb_total=30,
                      prb_hole=(5, 8))),
    ("nL8_comb4", dict(n_prbs=16, n_layers=8, comb=4, snr_db=30.0)),
]


def rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def case_inputs(kw, batch, dtype, device, seed=0):
    case = synthetic.make_case(seed=31, **kw)
    rng = np.random.default_rng(seed)
    rg = est.split_ri(case.received_rg)
    rg = np.broadcast_to(rg, (batch,) + rg.shape) + 1e-3 * rng.standard_normal((batch,) + rg.shape)
    pil = np.broadcast_to(est.split_ri(case.pilots), (batch, 2) + case.pilots.shape)
    t = lambda a: torch.as_tensor(np.array(a), dtype=dtype, device=device)
    return case, t(rg), t(pil), t(np.full(batch, case.beta))


@NEEDS_GPU
@pytest.mark.parametrize("name,kw", FRONT_CASES, ids=[c[0] for c in FRONT_CASES])
def test_fused_front_kernel_matches_plain(name, kw):
    dev = torch.device("cuda")
    case, rg, pil, beta = case_inputs(kw, 33, torch.float32, dev)
    nL = case.pilots.shape[2]
    plan = make_plan(case.hop1, case.hop2, case.config, nL)
    pt = plan_tensors(plan, dev, torch.float32)
    d0 = 0
    for hp, ht in zip([plan.hop1, plan.hop2], pt["hops"]):
        rx = est._gather_rx(hp, ht, rg)
        pil_h = pil[:, :, :, d0 : d0 + hp.n_dsym].permute(0, 1, 4, 3, 2).contiguous()
        d0 += hp.n_dsym
        mats = ht["front"]
        kw_ = dict(n_samples=hp.n_samples, half_cp_len=hp.half_cp_len, fft_size=hp.fft_size,
                   scs_hz=case.config.scs_hz, cfo_possible=hp.cfo_possible,
                   cfo_compensate=case.config.cfo_compensate)
        n0 = k1.launches
        h_k, s_k = k1.fused_front(rx, pil_h, beta, mats, **kw_)
        assert k1.launches == n0 + 1
        h_p, s_p = k1.fused_front_plain(rx, pil_h, beta, mats, **kw_)
        torch.cuda.synchronize()
        assert rel(h_k, h_p) <= 1e-5, name
        s_k, s_p = s_k.cpu().numpy(), s_p.cpu().numpy()
        # TA: the same bin (PyTorch divides a CUDA tensor by a scalar through
        # its reciprocal, the kernel divides: the seconds may differ by an ulp)
        to_bin = hp.fft_size * case.config.scs_hz
        np.testing.assert_array_equal(np.rint(s_k[:, 1] * to_bin), np.rint(s_p[:, 1] * to_bin))
        np.testing.assert_allclose(s_k[:, 1], s_p[:, 1], rtol=1e-6)
        np.testing.assert_allclose(s_k[:, [0, 2, 3, 4]], s_p[:, [0, 2, 3, 4]], rtol=1e-4, atol=1e-12)


@NEEDS_GPU
@pytest.mark.parametrize(
    "nL,slices", [(4, ((0, 2), (2, 4))), (3, ((0, 2), (2, 3))), (4, ((0, 4),)), (1, ((0, 1),))]
)
@pytest.mark.parametrize("batch,n_re,n_sc,n_sym", [(13, 52, 200, 14), (128, 636, 1272, 7),
                                                  (1, 144, 288, 14), (5, 37, 301, 3)])
def test_fill_rotate_serve_kernel_matches_plain(nL, slices, batch, n_re, n_sc, n_sym):
    rng = np.random.default_rng(nL)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")
    h = t(rng.standard_normal((batch, 2, nL, n_re)))
    w = t(0.1 * rng.standard_normal((len(slices), n_re, n_sc)))
    ph = rng.uniform(-np.pi, np.pi, (batch, n_sym))
    rot = t(np.stack([np.cos(ph), np.sin(ph)], 1))
    n0 = k2.launches
    got = k2.fused_fill_rotate_serve(h, w, rot, layer_slices=slices)
    assert k2.launches == n0 + 1
    want = k2.fused_fill_rotate_serve_plain(h, w, rot, layer_slices=slices)
    torch.cuda.synchronize()
    assert rel(got, want) <= 1e-5


@NEEDS_GPU
@pytest.mark.parametrize("layout", ["serve", "factored"])
@pytest.mark.parametrize("name,kw", FRONT_CASES[:4], ids=[c[0] for c in FRONT_CASES[:4]])
def test_estimator_on_cuda_matches_float64_cpu(name, kw, layout):
    case, rg, pil, beta = case_inputs(kw, 8, torch.float32, "cuda", seed=3)
    nL = case.pilots.shape[2]
    fn = est.build_ri(case.hop1, case.hop2, case.config, nL, batched=True,
                      out_layout=layout, kernels="pallas_front")
    n1, n2 = k1.launches, k2.launches
    got = fn(rg, pil, beta)
    torch.cuda.synchronize()
    assert k1.launches > n1 and (layout == "factored" or k2.launches > n2)
    want = fn(rg.double().cpu(), pil.double().cpu(), beta.double().cpu())
    key = "channel_est_rg" if layout == "serve" else "profiles"
    a, b = getattr(got, key).double().cpu(), getattr(want, key)
    assert float(((a - b) ** 2).sum() / (b**2).sum()) < 4e-11, name
    for f in ("noise_est", "rsrp", "epre", "time_alignment"):
        np.testing.assert_allclose(getattr(got, f).cpu(), getattr(want, f), rtol=1e-3, err_msg=f)


def random_front(B, nL, nd, n_re, n_pils, hcp, cfo_possible, cfo_compensate, seed=0):
    """Seeded random fused-front inputs on the card (any shape the kernel takes):
    (args, kwargs) of `fused_front`."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device="cuda")
    n_cdm = (nL + 1) // 2
    k_ta = n_re - n_re // 7
    taps = rng.uniform(0.0, 1.0, 15)
    ph = 2 * np.pi * np.outer(np.arange(k_ta), np.arange(-hcp, hcp)) / (4 * n_re)
    mats = dict(
        taps=t(taps / taps.sum()), vp=t(rng.standard_normal((n_pils, n_pils)) / n_pils),
        ta_c=t(np.cos(ph)), ta_s=t(np.sin(ph)),
        two_pi_sst_d=t(2 * np.pi * (2.0 + 7.0 * np.arange(nd))),
    )
    rx = t(rng.standard_normal((B, 2, n_cdm, nd, n_re)))
    pil = t(np.sign(rng.standard_normal((B, 2, nL, nd, n_re))) / np.sqrt(2))
    beta = t(1.0 + 0.1 * rng.uniform(size=B))
    kw = dict(n_samples=4096 + 288, half_cp_len=hcp, fft_size=4096, scs_hz=30e3,
              cfo_possible=cfo_possible, cfo_compensate=cfo_compensate)
    return (rx, pil, beta, mats), kw


def assert_front_matches_plain(args, kw, label):
    n0 = k1.launches
    h_k, s_k = k1.fused_front(*args, **kw)
    assert k1.launches == n0 + 1
    h_p, s_p = k1.fused_front_plain(*args, **kw)
    torch.cuda.synchronize()
    assert rel(h_k, h_p) <= 1e-5, label
    s_k, s_p = s_k.cpu().numpy(), s_p.cpu().numpy()
    to_bin = kw["fft_size"] * kw["scs_hz"]
    np.testing.assert_array_equal(np.rint(s_k[:, 1] * to_bin), np.rint(s_p[:, 1] * to_bin), label)
    np.testing.assert_allclose(s_k[:, [0, 2, 3, 4]], s_p[:, [0, 2, 3, 4]], rtol=1e-4, atol=1e-12,
                               err_msg=label)


@NEEDS_GPU
@pytest.mark.parametrize("B,nL,nd,n_re,n_pils,cfo_possible,cfo_compensate", [
    (1, 4, 4, 636, 7, True, True),     # B=1: one problem a cluster of 8
    (37, 4, 4, 636, 7, True, True),    # B not a multiple of P=4
    (130, 1, 2, 144, 7, True, True),   # nL=1, P=16, ragged last cluster
    (40, 2, 2, 300, 7, True, False),   # CFO estimated, not compensated
    (29, 3, 4, 400, 7, True, True),    # nL=3, unequal CDM groups, P=5 of 30 rows
    (19, 8, 4, 636, 12, True, True),   # nL=8, P=2 of 32 rows
    (17, 2, 1, 96, 1, False, False),   # n_pils=1 (no fit), CFO off, one DM-RS symbol
    (3, 5, 2, 1024, 16, True, True),   # the widest fused-smoothing band, 16 pilots
    (4, 4, 2, 7, 7, True, True),       # as many REs as virtual pilots, an odd band
])
def test_fused_front_kernel_matches_plain_at_every_plan_shape(
        B, nL, nd, n_re, n_pils, cfo_possible, cfo_compensate):
    args, kw = random_front(B, nL, nd, n_re, n_pils, 144, cfo_possible, cfo_compensate, seed=B)
    lp = k1.launch_plan(B, n_re, nL, n_pils, 144, args[3]["ta_c"].shape[0], k1.kernel_caps("cuda"),
                        15)
    assert_front_matches_plain(args, kw, f"B={B} nL={nL} {lp}")


@NEEDS_GPU
def test_fused_front_kernel_both_hops_of_c4():
    """c4 (24 PRB, 1 layer, two hops) at the bench's batch of 256."""
    kw = dict(n_prbs=24, n_layers=1, comb=2, scs_hz=30e3, snr_db=30.0, two_hops=True)
    case, rg, pil, beta = case_inputs(kw, 256, torch.float32, "cuda", seed=5)
    plan = make_plan(case.hop1, case.hop2, case.config, 1)
    pt = plan_tensors(plan, "cuda", torch.float32)
    d0 = 0
    for i, (hp, ht) in enumerate(zip([plan.hop1, plan.hop2], pt["hops"])):
        rx = est._gather_rx(hp, ht, rg).contiguous()
        pil_h = pil[:, :, :, d0 : d0 + hp.n_dsym].permute(0, 1, 4, 3, 2).contiguous()
        d0 += hp.n_dsym
        kw_ = dict(n_samples=hp.n_samples, half_cp_len=hp.half_cp_len, fft_size=hp.fft_size,
                   scs_hz=case.config.scs_hz, cfo_possible=hp.cfo_possible,
                   cfo_compensate=case.config.cfo_compensate)
        assert_front_matches_plain((rx, pil_h, beta, ht["front"]), kw_, f"c4 hop {i + 1}")


STAGED_CASES = [
    ("cell_shape", dict(n_prbs=106, n_layers=4, comb=2, scs_hz=30e3, snr_db=20.0), 128),
    ("c4_both_hops", dict(n_prbs=24, n_layers=1, comb=2, scs_hz=30e3, snr_db=30.0,
                          two_hops=True), 256),
    ("partial_prb_gap", dict(n_prbs=20, n_layers=3, comb=2, snr_db=30.0, prb_start=6,
                             n_prb_total=30, prb_hole=(5, 8)), 33),
]


@NEEDS_GPU
@pytest.mark.parametrize("name,kw,batch", STAGED_CASES, ids=[c[0] for c in STAGED_CASES])
def test_fused_front_kernel_staged_equals_gathered(name, kw, batch):
    """K1 on the staged grid and each hop's view of the staged pilots (hop 2
    from its symbol offset d0 > 0) gives, bit for bit, what it gives on the
    gathered inputs (`_gather_rx`, the pilots' permute): only the addresses
    differ. `ce40_closed4`'s shape (B=128, nd=nL=4, n_re=636), both hops of
    c4, and an RE table with a gap (a partial-PRB allocation with a hole).
    Each launch is counted by its form."""
    case, rg, pil, beta = case_inputs(kw, batch, torch.float32, "cuda", seed=7)
    plan = make_plan(case.hop1, case.hop2, case.config, case.pilots.shape[2])
    pt = plan_tensors(plan, "cuda", torch.float32)
    d0 = 0
    for hp, ht in zip([plan.hop1, plan.hop2], pt["hops"]):
        pil_h = pil[:, :, :, d0 : d0 + hp.n_dsym]
        kw_ = dict(n_samples=hp.n_samples, half_cp_len=hp.half_cp_len, fft_size=hp.fft_size,
                   scs_hz=case.config.scs_hz, cfo_possible=hp.cfo_possible,
                   cfo_compensate=case.config.cfo_compensate)
        r0 = dict(k1.route_launches)
        h_s, s_s = k1.fused_front(rg, pil_h, beta, ht["front"], re_idx=ht["re_idx"],
                                  dmrs_sym_idx=ht["dmrs_sym_idx"], **kw_)
        rx = est._gather_rx(hp, ht, rg)
        pil_g = pil_h.permute(0, 1, 4, 3, 2).contiguous()
        h_g, s_g = k1.fused_front(rx, pil_g, beta, ht["front"], **kw_)
        assert {r: n - r0[r] for r, n in k1.route_launches.items()} == {"staged": 1, "gathered": 1}
        torch.cuda.synchronize()
        assert torch.equal(h_s, h_g) and torch.equal(s_s, s_g), (name, d0)
        d0 += hp.n_dsym
    assert (d0 > plan.hop1.n_dsym) == (plan.hop2 is not None)


@NEEDS_GPU
def test_fill_rotate_serve_kernel_at_the_c3_operator():
    """c3 (273 PRB, cnn): one layer through the 1638 x 3276 inpainting operator,
    batch 16 (the split over K of a cluster carries this shape)."""
    rng = np.random.default_rng(3)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")
    h = t(rng.standard_normal((16, 2, 1, 1638)))
    w = t(0.05 * rng.standard_normal((1, 1638, 3276)))
    ph = rng.uniform(-np.pi, np.pi, (16, 14))
    rot = t(np.stack([np.cos(ph), np.sin(ph)], 1))
    lp = k2.launch_plan(16, k2.chunks_of(None, 1, 1), 1638, 3276, sm_count())
    assert lp.KS > 1, lp
    got = k2.fused_fill_rotate_serve(h, w, rot)
    want = k2.fused_fill_rotate_serve_plain(h, w, rot)
    torch.cuda.synchronize()
    assert rel(got, want) <= 1e-5


@NEEDS_GPU
def test_front_launch_plan_mirrors_the_kernels_plan():
    """`front.launch_plan` against `make_plan` of csrc/front.cu (`srs_front_plan`)
    at batches around the SM count, every layer count, both pilot-count ends,
    band widths up to the widest fused-smoothing band and two filter lengths,
    with the card's cluster capacities and with capacities that hold fewer
    clusters."""
    caps = k1.kernel_caps("cuda")
    assert len(caps) == 8 and caps[0] >= sm_count() and all(c >= 1 for c in caps), caps
    n_cases = 0
    for cap in (caps, tuple(max(1, c // 3) for c in caps)):
        for B in (1, 2, 5, 33, 128, 256, 1000):
            for nL in range(1, 9):
                for n_pils in (1, 7, 16):
                    for n_re in (16, 144, 636, 1024):
                        for hcp, n_taps in ((36, 5), (144, 15)):
                            lp = k1.launch_plan(B, n_re, nL, n_pils, hcp, n_re - n_re // 7, cap,
                                                n_taps)
                            assert k1.kernel_plan(B, n_re, nL, n_pils, hcp, n_re - n_re // 7,
                                                  cap, n_taps) == lp
                            n_cases += 1
    assert n_cases == 2 * 7 * 8 * 3 * 4 * 2


@NEEDS_GPU
def test_fill_launch_plan_mirrors_the_kernels_plan():
    n_cases = 0
    for n_sm in (sm_count(), 66):
        for B in (1, 16, 128, 256, 1000):
            for nL, slices in ((1, ((0, 1),)), (3, ((0, 2), (2, 3))), (4, ((0, 2), (2, 4))),
                               (4, ((0, 4),)), (8, ((0, 2), (2, 4), (4, 6), (6, 8)))):
                chunks = k2.chunks_of(slices, nL, len(slices))
                for n_re, n_sc in ((52, 200), (144, 288), (636, 1272), (1638, 3276), (7, 13)):
                    lp = k2.launch_plan(B, chunks, n_re, n_sc, n_sm)
                    assert k2.kernel_plan(B, nL, chunks, n_re, n_sc, n_sm) == lp
                    n_cases += 1
    assert n_cases == 250


@NEEDS_GPU
def test_wrappers_reject_what_the_kernels_do_not_take():
    t = lambda *s, **k: torch.zeros(*s, device="cuda", **k)
    w = t(2, 16, 32)
    rot = t(3, 2, 14)
    with pytest.raises(TypeError, match="float32"):
        k2.fused_fill_rotate_serve(t(3, 2, 4, 16, dtype=torch.float64), w, rot, ((0, 2), (2, 4)))
    with pytest.raises(ValueError, match="contiguous"):
        k2.fused_fill_rotate_serve(t(3, 2, 16, 4).transpose(2, 3), w, rot, ((0, 2), (2, 4)))
    with pytest.raises(ValueError, match="shape"):
        k2.fused_fill_rotate_serve(t(3, 2, 4, 15), w, rot, ((0, 2), (2, 4)))
    with pytest.raises(ValueError, match="layer_slices"):
        k2.fused_fill_rotate_serve(t(3, 2, 4, 16), w, rot, ((0, 2),))


@NEEDS_GPU
def test_unbatched_single_problem_on_cuda():
    """B=1 (the unbatched build) runs both kernels; no batch padding needed."""
    case, rg, pil, beta = case_inputs(FRONT_CASES[0][1], 1, torch.float32, "cuda", seed=4)
    fn = est.build_ri(case.hop1, case.hop2, case.config, 4, out_layout="serve",
                      kernels="pallas_front")
    n1, n2 = k1.launches, k2.launches
    got = fn(rg[0], pil[0], beta[0])
    torch.cuda.synchronize()
    assert (k1.launches, k2.launches) == (n1 + 1, n2 + 1)
    want = fn(rg[0].double().cpu(), pil[0].double().cpu(), beta[0].double().cpu())
    a, b = got.channel_est_rg.double().cpu(), want.channel_est_rg
    assert a.shape == b.shape == (2, 4, 14, 1272)
    assert float(((a - b) ** 2).sum() / (b**2).sum()) < 4e-11


@NEEDS_GPU
@pytest.mark.parametrize("batch,C,n_ext,K", [
    (128, 8, 650, 15), (128, 32, 650, 15), (3, 2, 20, 5), (1, 1, 1, 1),
    (4, 2, 651, 15), (7, 3, 1203, 32), (2, 32, 2050, 7), (3, 1, 32, 32),
])
def test_rc_smooth_kernel_matches_plain(batch, C, n_ext, K):
    rng = np.random.default_rng(K)
    x = torch.as_tensor(rng.standard_normal((batch, C, n_ext)), dtype=torch.float32, device="cuda")
    taps = rng.standard_normal(K)
    n0 = k5.launches
    got = k5.rc_smooth(x, taps)
    assert k5.launches == n0 + 1
    want = k5.rc_smooth_plain(x, taps)
    torch.cuda.synchronize()
    assert got.shape == (batch, C, n_ext - K + 1)
    assert rel(got, want) <= 1e-5


@NEEDS_GPU
def test_rc_smooth_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((2, 4, 30), device="cuda")
    taps = np.ones(5)
    with pytest.raises(TypeError, match="float32"):
        k5.rc_smooth(x.double(), taps)
    with pytest.raises(ValueError, match="contiguous"):
        k5.rc_smooth(x.transpose(0, 1), taps)
    with pytest.raises(ValueError, match=r"\(B, C, n_ext\)"):
        k5.rc_smooth(x[0], taps)
    with pytest.raises(ValueError, match="1..32 taps"):
        k5.rc_smooth(x, np.ones(33))
    with pytest.raises(ValueError, match="at least K"):
        k5.rc_smooth(x[..., :4].contiguous(), taps)


@NEEDS_GPU
@pytest.mark.parametrize(
    "nL,slices", [(4, ((0, 2), (2, 4))), (3, ((0, 2), (2, 3))), (1, ((0, 1),)), (8, ((0, 4), (4, 8)))]
)
@pytest.mark.parametrize("batch,n_re,n_sc,n_sym", [(13, 52, 200, 14), (128, 636, 1272, 7)])
def test_fill_rotate_kernel_matches_plain(nL, slices, batch, n_re, n_sc, n_sym):
    rng = np.random.default_rng(nL)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")
    h = t(rng.standard_normal((batch, 2, nL, n_re)))
    w = t(0.1 * rng.standard_normal((len(slices), n_re, n_sc)))
    ph = rng.uniform(-np.pi, np.pi, (batch, n_sym))
    rot = t(np.stack([np.cos(ph), np.sin(ph)], 1))
    n0 = k6.launches
    got = k6.fused_fill_rotate(h, w, rot, layer_slices=slices)
    assert k6.launches == n0 + 1
    want = k6.fused_fill_rotate_plain(h, w, rot, layer_slices=slices)
    torch.cuda.synchronize()
    assert got.shape == (batch, 2, n_sc, n_sym, nL)
    assert rel(got, want) <= 1e-5
    # the same block written into a larger grid leaves the rest untouched
    grid = torch.full((batch, 2, n_sc + 40, 14, nL), 3.0, device="cuda")
    k6.fused_fill_rotate(h, w, rot, layer_slices=slices, out=grid, sc_start=12, sym_start=14 - n_sym)
    torch.cuda.synchronize()
    assert rel(grid[:, :, 12 : 12 + n_sc, 14 - n_sym :], want) <= 1e-5
    assert (grid[:, :, :12] == 3.0).all() and (grid[:, :, 12 + n_sc :] == 3.0).all()
    assert (grid[:, :, :, : 14 - n_sym] == 3.0).all()


K6_LAYERS = [(1, ((0, 1),)), (2, ((0, 2),)), (3, ((0, 2), (2, 3))), (4, ((0, 2), (2, 4))),
             (5, ((0, 2), (2, 4), (4, 5))), (6, ((0, 2), (2, 4), (4, 6))), (7, ((0, 4), (4, 7))),
             (8, ((0, 4), (4, 8)))]


def k6_inputs(batch, nL, n_groups, n_re, n_sc, n_sym, seed):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")
    ph = rng.uniform(-np.pi, np.pi, (batch, n_sym))
    return (t(rng.standard_normal((batch, 2, nL, n_re))),
            t(0.1 * rng.standard_normal((n_groups, n_re, n_sc))),
            t(np.stack([np.cos(ph), np.sin(ph)], 1)))


def assert_k6_into_grid(h, w, rot, slices, grid, sc0, sy0):
    """K6 writes its block at (sc0, sy0) of `grid` (filled with 3.0 first)
    within relative 1e-5 of the plain version and leaves the rest as it was."""
    n_sc, n_sym = w.shape[2], rot.shape[2]
    grid.fill_(3.0)
    n0 = k6.launches
    assert k6.fused_fill_rotate(h, w, rot, slices, out=grid, sc_start=sc0, sym_start=sy0) is grid
    assert k6.launches == n0 + 1
    want = torch.full_like(grid, 3.0)
    want[:, :, sc0:sc0 + n_sc, sy0:sy0 + n_sym] = k6.fused_fill_rotate_plain(h, w, rot, slices)
    torch.cuda.synchronize()
    assert rel(grid, want) <= 1e-5
    outside = torch.ones_like(grid, dtype=torch.bool)
    outside[:, :, sc0:sc0 + n_sc, sy0:sy0 + n_sym] = False
    assert (grid[outside] == 3.0).all()


@NEEDS_GPU
@pytest.mark.parametrize("nL,slices", K6_LAYERS, ids=[f"nL{n}" for n, _ in K6_LAYERS])
@pytest.mark.parametrize("batch", [1, 15, 16, 17, 128, 256])
def test_fill_rotate_kernel_every_batch_and_layer_count(nL, slices, batch):
    """K6 against plain at batches around its tiles of P problems and every
    layer count, CDM groups equal and not: the whole block, then written
    into a larger grid twice, at symbol 0 (14 symbols) and at symbol 7 (7
    symbols, the second hop of a slot), where the spans are 16-byte aligned
    only for some layer counts."""
    h, w, rot = k6_inputs(batch, nL, len(slices), 52, 200, 14, seed=batch + nL)
    got = k6.fused_fill_rotate(h, w, rot, layer_slices=slices)
    want = k6.fused_fill_rotate_plain(h, w, rot, layer_slices=slices)
    torch.cuda.synchronize()
    assert got.shape == (batch, 2, 200, 14, nL)
    assert rel(got, want) <= 1e-5
    grid = torch.empty((batch, 2, 237, 14, nL), device="cuda")
    assert_k6_into_grid(h, w, rot, slices, grid, 5, 0)
    assert_k6_into_grid(h, w, rot[:, :, :7].contiguous(), slices, grid, 30, 7)


@NEEDS_GPU
@pytest.mark.parametrize("nL,slices", [(3, ((0, 2), (2, 3))), (1, ((0, 1),)), (8, ((0, 8),))])
def test_fill_rotate_kernel_unaligned_spans(nL, slices):
    """Spans off the 16-byte boundaries: an odd symbol count at an odd first
    symbol of a 13-symbol grid (no span aligned for nL 1 and 3), odd n_re and
    n_sc (4-byte W copies), and a grid whose data starts 4 bytes past an
    aligned address (no span aligned for any nL)."""
    h, w, rot = k6_inputs(17, nL, len(slices), 37, 301, 5, seed=nL)
    grid = torch.empty((17, 2, 330, 13, nL), device="cuda")
    assert_k6_into_grid(h, w, rot, slices, grid, 11, 3)
    flat = torch.empty(grid.numel() + 1, device="cuda")
    shifted = flat[1:].view(grid.shape)
    assert shifted.data_ptr() % 16 == 4 and shifted.is_contiguous()
    assert_k6_into_grid(h, w, rot, slices, shifted, 0, 8)


@NEEDS_GPU
def test_fill_rotate_kernel_at_the_c3_operator_and_the_c4_hop():
    """The c3 inpainting operator (1638 x 3276, B=16, one layer: K split over
    a cluster) and the c4 second hop (B=256, 288 subcarriers from n_re 144,
    written at subcarrier 336 and symbol 7 of the (624, 14) grid)."""
    h, w, rot = k6_inputs(16, 1, 1, 1638, 3276, 14, seed=3)
    lp = k6.launch_plan(16, 1, k6.fill_chunks(None, 1, 1), 1638, 3276, 14, sm_count())
    assert lp.KS > 1, lp
    got = k6.fused_fill_rotate(h, w, rot)
    want = k6.fused_fill_rotate_plain(h, w, rot)
    torch.cuda.synchronize()
    assert rel(got, want) <= 1e-5
    h, w, rot = k6_inputs(256, 1, 1, 144, 288, 7, seed=4)
    grid = torch.empty((256, 2, 624, 14, 1), device="cuda")
    assert_k6_into_grid(h, w, rot, ((0, 1),), grid, 336, 7)


@NEEDS_GPU
def test_fill_rotate_launch_plan_mirrors_the_kernels_plan():
    n_cases = 0
    for n_sm in (sm_count(), 66):
        for B in (1, 15, 16, 17, 128, 256, 1000):
            for nL, slices in K6_LAYERS + [(8, ((0, 8),)), (4, ((0, 4),))]:
                chunks = k6.fill_chunks(slices, nL, len(slices))
                for n_re, n_sc, n_sym in ((52, 200, 14), (144, 288, 7), (636, 1272, 14),
                                          (1638, 3276, 14), (7, 13, 1)):
                    lp = k6.launch_plan(B, nL, chunks, n_re, n_sc, n_sym, n_sm)
                    assert k6.kernel_plan(B, nL, chunks, n_re, n_sc, n_sym, n_sm) == lp
                    n_cases += 1
    assert n_cases == 2 * 7 * 10 * 5
    with pytest.raises(ValueError, match="refused"):
        k6.kernel_plan(4, 4, [(0, 0, 2), (1, 1, 2)], 636, 1272, 14, sm_count())
    with pytest.raises(ValueError, match="refused"):
        k6.kernel_plan(4, 4, k6.fill_chunks(((0, 2), (2, 4)), 4, 2), 636, 1272, 33, sm_count())


@NEEDS_GPU
@pytest.mark.parametrize("name,kw", FRONT_CASES[:4], ids=[c[0] for c in FRONT_CASES[:4]])
def test_pallas_ref_on_cuda_matches_float64_cpu(name, kw):
    """kernels="pallas" in the reference layout: K5 and K6 on the card."""
    case, rg, pil, beta = case_inputs(kw, 8, torch.float32, "cuda", seed=5)
    nL = case.pilots.shape[2]
    fn = est.build_ri(case.hop1, case.hop2, case.config, nL, batched=True, kernels="pallas")
    n5, n6 = k5.launches, k6.launches
    got = fn(rg, pil, beta)
    torch.cuda.synchronize()
    assert k5.launches > n5 and k6.launches > n6
    want = fn(rg.double().cpu(), pil.double().cpu(), beta.double().cpu())
    a, b = got.channel_est_rg.double().cpu(), want.channel_est_rg
    assert a.shape == b.shape == (8, 2, case.received_rg.shape[0], 14, nL)
    assert float(((a - b) ** 2).sum() / (b**2).sum()) < 1e-12, name
    for f in ("noise_est", "rsrp", "epre", "time_alignment"):
        np.testing.assert_allclose(getattr(got, f).cpu(), getattr(want, f), rtol=1e-3, err_msg=f)


@NEEDS_GPU
@pytest.mark.parametrize("kernels,layout", [("xla", "ref"), ("xla", "serve"), ("pallas", "serve")])
def test_other_tiers_on_cuda(kernels, layout):
    """The "xla" tier (float32 and float64) and the deferred pallas serve route
    on the card against the float64 CPU run."""
    case, rg, pil, beta = case_inputs(FRONT_CASES[0][1], 4, torch.float32, "cuda", seed=6)
    fn = est.build_ri(case.hop1, case.hop2, case.config, 4, batched=True, kernels=kernels,
                      out_layout=layout)
    want = fn(rg.double().cpu(), pil.double().cpu(), beta.double().cpu()).channel_est_rg
    got32 = fn(rg, pil, beta).channel_est_rg.double().cpu()
    assert float(((got32 - want) ** 2).sum() / (want**2).sum()) < 4e-11
    if kernels == "xla":
        got64 = fn(rg.double(), pil.double(), beta.double()).channel_est_rg.cpu()
        assert float(((got64 - want) ** 2).sum() / (want**2).sum()) < 1e-24
    else:
        with pytest.raises(TypeError, match="float32"):
            fn(rg.double(), pil.double(), beta.double())


@NEEDS_GPU
@pytest.mark.parametrize("kernels", ["pallas_front", "pallas", "xla"])
def test_bf16_and_cnn_serve_on_cuda(kernels):
    kw = dict(n_prbs=24, n_layers=2, comb=2, snr_db=30.0, interp="cnn")
    case, rg, pil, beta = case_inputs(kw, 4, torch.float32, "cuda", seed=7)
    f32 = est.build_ri(case.hop1, case.hop2, case.config, 2, batched=True, kernels=kernels,
                       out_layout="serve")
    bf = est.build_ri(case.hop1, case.hop2, case.config, 2, batched=True, kernels=kernels,
                      out_layout="serve", out_dtype="bfloat16")
    want = f32(rg.double().cpu(), pil.double().cpu(), beta.double().cpu()).channel_est_rg
    a = f32(rg, pil, beta).channel_est_rg.double().cpu()
    assert float(((a - want) ** 2).sum() / (want**2).sum()) < 4e-11
    b = bf(rg, pil, beta).channel_est_rg
    assert b.dtype == torch.bfloat16
    assert rel(b.float(), want) <= 1e-2


# ---------------------------------------------------------------------------
# K4 (ldpc_posterior) and K3 (ldpc_stream_posterior): the kernels keep the
# plain versions' order of operations (adds, subtracts and products by +-1,
# no FMA pair, no atomics), so they are held to them bit for bit.
# ---------------------------------------------------------------------------

from srsran_ce_tpu_torch.ops import ldpc as tl  # noqa: E402
from srsran_ce_tpu_torch.ops import nr_ldpc as tnr  # noqa: E402
from srsran_ce_tpu_torch.ops.kernels import ldpc as k4  # noqa: E402
from srsran_ce_tpu_torch.ops.kernels import ldpc_stream as k3  # noqa: E402

LDPC_CODES = {
    "n976": lambda: tl.array_code(6, 16, 61),
    "bg2_z208": lambda: tnr.nr_base_graph(2, 208),
    "bg1_z52": lambda: tnr.nr_base_graph(1, 52),
    "bg2_z144": lambda: tnr.nr_base_graph(2, 144),
    "bg1_z384": lambda: tnr.nr_base_graph(1, 384),
}


def awgn_llrs(code, batch, snr_db=3.5, seed=0):
    """(info bits, float32 LLRs) of `batch` encoded words through BPSK + AWGN."""
    plan = tl.make_ldpc_plan(code)
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (batch, plan.k), dtype=np.uint8)
    cw = tl.encode(code, u)
    snr = 10.0 ** (snr_db / 10)
    llr = 4 * snr * ((1 - 2.0 * cw) + rng.normal(0, np.sqrt(0.5 / snr), cw.shape))
    return u, torch.as_tensor(llr.astype(np.float32), device="cuda")


@NEEDS_GPU
@pytest.mark.parametrize("name,batch,schedule,group,n_iters", [
    ("n976", 37, "flooding", 1, 6), ("n976", 37, "layered", 1, 4),
    ("bg2_z208", 19, "flooding", 1, 4), ("bg2_z208", 19, "layered", 8, 3),
    ("bg1_z52", 11, "flooding", 1, 4), ("bg1_z52", 11, "layered", 2, 3),
    ("bg1_z52", 3, "layered", 4, 2), ("bg1_z52", 5, "layered", 3, 2),
    ("n976", 1, "layered", 2, 3),
])
def test_ldpc_posterior_kernel_bit_identical(name, batch, schedule, group, n_iters):
    code = LDPC_CODES[name]()
    plan = tl.make_ldpc_plan(code)
    _, ch = awgn_llrs(code, batch, seed=batch)
    n0 = k4.launches
    got = k4.ldpc_posterior(ch, plan, n_iters, 0.75, schedule=schedule, group=group)
    assert k4.launches == n0 + 1
    want = k4.ldpc_posterior_plain(ch, plan, n_iters, 0.75, schedule=schedule, group=group)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.equal(got, want), float((got - want).abs().max())


@NEEDS_GPU
@pytest.mark.parametrize("name,batch,group,c2v", [
    ("bg1_z384", 5, 1, None), ("bg1_z384", 5, 1, "bfloat16"), ("bg2_z144", 7, 3, None),
    ("bg2_z144", 7, 3, "bfloat16"), ("bg1_z52", 9, 2, "bfloat16"), ("bg2_z208", 3, 8, None),
])
def test_ldpc_stream_kernel_bit_identical(name, batch, group, c2v):
    code = LDPC_CODES[name]()
    plan = tl.make_ldpc_plan(code)
    u, ch = awgn_llrs(code, batch, seed=group)
    n0 = k3.launches
    got = k3.ldpc_stream_posterior(ch, plan, 4, 0.75, group=group, c2v_dtype=c2v)
    assert k3.launches == n0 + 1
    want = k3.ldpc_stream_posterior_plain(ch, plan, 4, 0.75, group=group, c2v_dtype=c2v)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.equal(got, want), float((got - want).abs().max())


@NEEDS_GPU
@pytest.mark.parametrize("name,schedule,tier,launched", [
    ("n976", "flooding", "pallas", "k4"), ("bg1_z52", "layered", "pallas", "k4"),
    ("bg1_z384", "layered", "pallas_stream", "k3"), ("bg1_z384", "flooding", "xla_gather", None),
])
def test_auto_on_cuda_launches_the_kernel(name, schedule, tier, launched):
    code = LDPC_CODES[name]()
    u, ch = awgn_llrs(code, 6, snr_db=4.0, seed=3)
    dec = tl.build_decoder(code, n_iters=12, kernels="auto", schedule=schedule,
                           layered_group=tl.default_layered_group(code), device="cuda")
    assert dec.tier == tier
    n3, n4 = k3.launches, k4.launches
    res = dec(ch.reshape(2, 3, -1))
    torch.cuda.synchronize()
    assert (k3.launches - n3, k4.launches - n4) == {"k3": (1, 0), "k4": (0, 1), None: (0, 0)}[launched]
    assert res.bits.device.type == "cuda" and res.info.shape == (2, 3, u.shape[1])
    assert bool(res.ok.all()) and np.array_equal(res.info.reshape(6, -1).cpu().numpy(), u)


@NEEDS_GPU
def test_ldpc_wrappers_reject_what_the_kernels_do_not_take():
    code = LDPC_CODES["n976"]()
    plan = tl.make_ldpc_plan(code)
    ch = torch.zeros((4, code.n), device="cuda")
    for wrapper in (lambda x: k4.ldpc_posterior(x, plan, 2, 0.75),
                    lambda x: k3.ldpc_stream_posterior(x, plan, 2, 0.75)):
        with pytest.raises(TypeError, match="float32"):
            wrapper(ch.double())
        with pytest.raises(ValueError, match="contiguous"):
            wrapper(torch.zeros((code.n, 4), device="cuda").t())
        with pytest.raises(ValueError, match="n="):
            wrapper(ch[:, :-1].contiguous())
    with pytest.raises(ValueError, match="CUDA tensors"):
        k4.check_args(ch.cpu(), plan, 1)
    dec = tl.build_decoder(code, n_iters=2, kernels="pallas", device="cuda")
    with pytest.raises(TypeError, match="float32"):
        dec(ch.double())


def bits_equal(got, want):
    """Bit-identity of two float32 tensors (-0.0 and +0.0 told apart)."""
    return torch.equal(got.view(torch.int32), want.view(torch.int32))


def sm_count():
    return torch.cuda.get_device_properties(0).multi_processor_count


@NEEDS_GPU
@pytest.mark.parametrize("name,batch,sweeps,c2v", [
    ("bg1_z384", 24, 16, "bfloat16"), ("bg1_z384", 1, 4, "bfloat16"), ("bg1_z384", 1, 4, None),
    ("bg1_z384", 200, 2, "bfloat16"), ("bg1_z384", 200, 2, None), ("bg1_z384", 24, 4, None),
    ("bg1_z384", 96, 16, "bfloat16"), ("bg1_z384", 96, 16, None), ("bg1_z384", 132, 2, "bfloat16"),
    ("bg1_z384", 132, 2, None), ("bg1_z384", 133, 2, "bfloat16"), ("bg1_z384", 133, 2, None),
    ("bg1_z384", 512, 2, "bfloat16"),
])
def test_ldpc_stream_kernel_at_the_e2e_and_edge_batches(name, batch, sweeps, c2v):
    """K3 at the e2e decode shape (24 words, 16 sweeps), the served call's
    (96 words: 8 slots of 12 blocks), one word, the last one-wave batch (an
    SM a word), more words than SMs (a second wave of blocks) and the host
    decode path's 512 words: the pair route at every batch, bit for bit,
    one launch counted on its route."""
    code = LDPC_CODES[name]()
    plan = tl.make_ldpc_plan(code)
    _, ch = awgn_llrs(code, batch, seed=batch)
    w = k4.wiring(plan, ch.device)
    route = "pair"
    assert k4.launch_plan(w, batch, 2 if c2v else 4, True, 1, sm_count()).route == route
    r0 = dict(k3.route_launches)
    got = k3.ldpc_stream_posterior(ch, plan, sweeps, 0.75, c2v_dtype=c2v)
    assert {r: n - r0[r] for r, n in k3.route_launches.items()} == {
        r: int(r == route) for r in k4.ROUTES}
    want = k3.ldpc_stream_posterior_plain(ch, plan, sweeps, 0.75, c2v_dtype=c2v)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and bits_equal(got, want), float((got - want).abs().max())


@NEEDS_GPU
@pytest.mark.parametrize("c2v", [None, "bfloat16"])
@pytest.mark.parametrize("kind", ["straddle", "upper_first", "few_values"])
def test_ldpc_stream_pair_route_ties(kind, c2v):
    """The pair route's merge of its two half folds on ties, at NR BG1 Z=384
    (row 0: 21 slots, halves [0, 11) and [11, 21)): the first sweep sees equal
    least magnitudes on slots 10 and 11, straddling the halves' boundary
    (the lower half's slot must win), or the least magnitude on the upper
    half's first slot; or LLRs drawn from a few values with zeros of both
    signs, so that ties fall everywhere. Bit for bit to the plain version."""
    code = LDPC_CODES["bg1_z384"]()
    plan = tl.make_ldpc_plan(code)
    z, B = code.z, 8
    rng = np.random.default_rng(11)
    if kind == "few_values":
        vals = np.array([-2.0, -1.0, -0.5, -0.0, 0.0, 0.5, 1.0, 2.0], np.float32)
        llr = vals[rng.integers(0, vals.size, (B, code.n))]
    else:
        llr = np.where(rng.random((B, code.n)) < 0.3, -2.0, 2.0).astype(np.float32)
        blocks = [j for i, t, j, s in plan.edges if i == 0]
        h = (len(blocks) + 1) // 2
        for t, mag in ((h - 1, 0.5), (h, 0.5)) if kind == "straddle" else ((h, 0.25),):
            j = blocks[t]
            llr[:, j * z:(j + 1) * z] = np.copysign(mag, llr[:, j * z:(j + 1) * z])
    ch = torch.as_tensor(llr, device="cuda")
    w = k4.wiring(plan, ch.device)
    assert k4.launch_plan(w, B, 2 if c2v else 4, True, 1, sm_count()).route == "pair"
    got = k3.ldpc_stream_posterior(ch, plan, 4, 0.75, c2v_dtype=c2v)
    want = k3.ldpc_stream_posterior_plain(ch, plan, 4, 0.75, c2v_dtype=c2v)
    torch.cuda.synchronize()
    assert bits_equal(got, want), float((got - want).abs().max())


@NEEDS_GPU
@pytest.mark.parametrize("c2v", [None, "bfloat16"])
def test_ldpc_stream_pair_route_on_saturated_llrs(c2v):
    """K3's pair route at NR BG1 Z=384 on LLRs of which 30 % sit at and
    above the mask value (1e30 .. 3e33, finite through the sweeps), where
    the pair fold's second minimum is min(BIG, ...) as the plain version's:
    bit for bit."""
    code = LDPC_CODES["bg1_z384"]()
    plan = tl.make_ldpc_plan(code)
    rng = np.random.default_rng(5)
    llr = rng.normal(0.0, 2.0, (8, code.n)).astype(np.float32)
    hit = rng.random(llr.shape) < 0.3
    big = np.array([1e30, 2e30, 1e31, 3e33], np.float32)
    llr[hit] = np.copysign(big[rng.integers(0, big.size, int(hit.sum()))], llr[hit])
    ch = torch.as_tensor(llr, device="cuda")
    assert k4.launch_plan(k4.wiring(plan, ch.device), 8, 2 if c2v else 4, True, 1,
                          sm_count()).route == "pair"
    got = k3.ldpc_stream_posterior(ch, plan, 4, 0.75, c2v_dtype=c2v)
    want = k3.ldpc_stream_posterior_plain(ch, plan, 4, 0.75, c2v_dtype=c2v)
    torch.cuda.synchronize()
    assert torch.isfinite(want).all() and bits_equal(got, want), float((got - want).abs().max())


@NEEDS_GPU
@pytest.mark.parametrize("batch", [133, 512])
def test_ldpc_posterior_pair_route_over_one_wave(batch):
    """K4 (float32 records) at NR BG1 Z=384, layered, groups of one row,
    over one wave of blocks (133 words) and at 512: the pair route, as the
    launch plan is shared with K3, bit for bit, one launch."""
    code = LDPC_CODES["bg1_z384"]()
    plan = tl.make_ldpc_plan(code)
    _, ch = awgn_llrs(code, batch, seed=batch)
    lp = k4.launch_plan(k4.wiring(plan, ch.device), batch, 4, True, 1, sm_count())
    assert lp.route == "pair" and lp.blocks == batch > sm_count()
    n0 = k4.launches
    got = k4.ldpc_posterior(ch, plan, 2, 0.75, schedule="layered", group=1)
    assert k4.launches == n0 + 1
    want = k4.ldpc_posterior_plain(ch, plan, 2, 0.75, schedule="layered", group=1)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and bits_equal(got, want), float((got - want).abs().max())


@NEEDS_GPU
@pytest.mark.parametrize("schedule,group", [("flooding", 1), ("layered", 1), ("layered", 2)])
def test_ldpc_posterior_kernel_several_codewords_a_block_ragged(schedule, group):
    """n976 at B=513: several codewords a block (layered) and a ragged last block."""
    code = LDPC_CODES["n976"]()
    plan = tl.make_ldpc_plan(code)
    _, ch = awgn_llrs(code, 513, seed=7)
    lp = k4.launch_plan(k4.wiring(plan, ch.device), 513, 4, schedule == "layered", group, sm_count())
    assert lp.route == "chip" and (lp.cpb > 1 or schedule == "flooding")
    got = k4.ldpc_posterior(ch, plan, 5, 0.75, schedule=schedule, group=group)
    want = k4.ldpc_posterior_plain(ch, plan, 5, 0.75, schedule=schedule, group=group)
    torch.cuda.synchronize()
    assert bits_equal(got, want), float((got - want).abs().max())


# every route of the table: (kernel, code, schedule, group, message type, route)
ROUTE_CASES = [
    ("k4", "bg2_z208", "flooding", 1, None, "chip"), ("k4", "bg2_z208", "layered", 8, None, "chip"),
    ("k4", "bg1_z384", "flooding", 1, None, "stream"), ("k4", "bg1_z384", "layered", 1, None, "pair"),
    ("k4", "bg1_z384", "layered", 3, None, "stream"), ("k3", "bg1_z52", "layered", 2, "bfloat16", "chip"),
    ("k3", "bg2_z144", "layered", 3, None, "chip"), ("k3", "bg1_z384", "layered", 3, "bfloat16", "stream"),
    ("k3", "bg1_z384", "layered", 2, None, "stream"), ("k3", "bg1_z384", "layered", 1, "bfloat16", "pair"),
]


@NEEDS_GPU
@pytest.mark.parametrize("kern,name,schedule,group,c2v,route", ROUTE_CASES)
def test_ldpc_kernels_on_each_route(kern, name, schedule, group, c2v, route):
    code = LDPC_CODES[name]()
    plan = tl.make_ldpc_plan(code)
    _, ch = awgn_llrs(code, 6, seed=group)
    w = k4.wiring(plan, ch.device)
    lp = k4.launch_plan(w, 6, 2 if c2v else 4, schedule == "layered", group, sm_count())
    assert lp.route == route and lp.smem <= k4.SMEM_LIMIT
    assert lp.threads <= (k4.PAIR_THREADS if route == "pair" else k4.MAX_THREADS)
    if kern == "k4":
        got = k4.ldpc_posterior(ch, plan, 3, 0.75, schedule=schedule, group=group)
        want = k4.ldpc_posterior_plain(ch, plan, 3, 0.75, schedule=schedule, group=group)
    else:
        got = k3.ldpc_stream_posterior(ch, plan, 3, 0.75, group=group, c2v_dtype=c2v)
        want = k3.ldpc_stream_posterior_plain(ch, plan, 3, 0.75, group=group, c2v_dtype=c2v)
    torch.cuda.synchronize()
    assert bits_equal(got, want), float((got - want).abs().max())


@NEEDS_GPU
def test_ldpc_launch_plan_mirrors_the_kernels_plan():
    """`launch_plan` against `ldpc::make_plan` through `srs_ldpc_plan` of both
    libraries, at every code of these tests, both schedules, groups and
    message types, and batches around the SM count (every route taken)."""
    import ctypes

    from srsran_ce_tpu_torch.ops.kernels import bind

    n_sm = sm_count()
    fns = [bind(src, "srs_ldpc_plan", k4.PLAN_ARGTYPES) for src in ("ldpc", "ldpc_stream")]
    out = (ctypes.c_longlong * 7)()
    n_cases = 0
    routes = set()
    for name, make in LDPC_CODES.items():
        w = k4.wiring(tl.make_ldpc_plan(make()), "cuda")
        for layered, group in ((False, 1), (True, 1), (True, 2), (True, 8), (True, 16)):
            for msg_bytes in (2, 4):
                for batch in (1, 24, 96, n_sm - 1, n_sm, n_sm + 1, 3 * n_sm + 1, 513):
                    rcs = [fn(out, batch, w.n_edges, w.mb, w.nb, w.z, msg_bytes, int(layered),
                              group, n_sm) for fn in fns]
                    try:
                        lp = k4.launch_plan(w, batch, msg_bytes, layered, group, n_sm)
                    except ValueError:
                        assert all(rc != 0 for rc in rcs), (name, layered, group, msg_bytes)
                        continue
                    assert rcs == [0, 0]
                    assert list(out) == [k4.ROUTES.index(lp.route), lp.cpb, lp.threads, lp.blocks,
                                         lp.smem, lp.scratch, lp.per_cw], (name, layered, group)
                    n_cases += 1
                    routes.add(lp.route)
    assert n_cases > 100 and routes == set(k4.ROUTES)


@NEEDS_GPU
def test_ldpc_wrappers_refuse_what_no_route_takes():
    ch = torch.zeros((2, 28 * 29), device="cuda")
    wide = tl.make_ldpc_plan(tl.array_code(3, 28, 29))  # rows of degree 28 > MAX_DEGREE
    with pytest.raises(ValueError, match=f"degree <= {k4.MAX_DEGREE}"):
        k4.ldpc_posterior(ch, wide, 2, 0.75)
    with pytest.raises(ValueError, match=f"degree <= {k4.MAX_DEGREE}"):
        k3.ldpc_stream_posterior(ch, wide, 2, 0.75)
    plan = tl.make_ldpc_plan(LDPC_CODES["bg1_z384"]())
    ch = torch.zeros((2, plan.code.n), device="cuda")
    with pytest.raises(ValueError, match="does not fit"):  # 16 rows of f32 buffers beside L
        k3.ldpc_stream_posterior(ch, plan, 2, 0.75, group=16)


# ---------------------------------------------------------------------------
# K7 (inpaint_stack): the kernel keeps the plain version's order of
# operations (products by 1/4 and 1/2 are exact), bit-identical; the
# receiver on the card against the float64 CPU run of the same port (x NMSE
# 1e-9, SINR relative 1e-4 over max |SINR|); decoded serving host vs device.
# ---------------------------------------------------------------------------

from srsran_ce_tpu_torch import serving, transport  # noqa: E402
from srsran_ce_tpu_torch.models import receiver as rcv  # noqa: E402
from srsran_ce_tpu_torch.ops.kernels import inpaint as k7  # noqa: E402

K7_SHAPES = [  # name, B, C, n, comb, n_iters
    ("jax_48_comb2", 2, 4, 48, 2, 6), ("jax_96_comb4", 2, 4, 96, 4, 12),
    ("chain_11prb_nL4", 128, 8, 132, 2, 16), ("c3_273prb_nL1", 16, 2, 3276, 2, 409),
]


def k7_inputs(B, C, n, comb, seed=0):
    known = np.zeros(n, dtype=bool)
    known[::comb] = True
    x = np.where(known, np.random.default_rng(seed).standard_normal((B, C, n)), 0.0)
    return known, torch.as_tensor(x, dtype=torch.float32, device="cuda")


@NEEDS_GPU
@pytest.mark.parametrize("name,B,C,n,comb,n_iters", K7_SHAPES, ids=[s[0] for s in K7_SHAPES])
def test_inpaint_stack_kernel_matches_plain(name, B, C, n, comb, n_iters):
    known, x = k7_inputs(B, C, n, comb)
    n0 = k7.launches
    got = k7.inpaint_stack(x, known, n_iters)
    assert k7.launches == n0 + 1
    want = k7.inpaint_stack_plain(x, known, n_iters)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.equal(got, want)
    assert torch.equal(got[..., ::comb], x[..., ::comb])  # known positions pinned


# every route boundary (the last n a route holds, the first it hands on), n = 3, an odd n
K7_EDGE_NS = sorted({k7.capacity(r) + d for r in range(len(k7.ROUTES)) for d in (0, 1)
                     if k7.capacity(r) + d <= k7.MAX_N} | {3, 1001})


@NEEDS_GPU
@pytest.mark.parametrize("n", K7_EDGE_NS)
def test_inpaint_stack_kernel_bit_identical_at_route_edges(n):
    known, x = k7_inputs(2, 2, n, 2 + n % 3, seed=n)
    got = k7.inpaint_stack(x, known, max(6, n // 8))
    want = k7.inpaint_stack_plain(x, known, max(6, n // 8))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@NEEDS_GPU
@pytest.mark.parametrize("rows", [2, 44, 140])
def test_inpaint_stack_kernel_bit_identical_at_c3_row_counts(rows):
    """c3 rows (n = 3276, 409 iterations, one block a row) fewer than and more
    than the SMs."""
    known, x = k7_inputs(rows // 2, 2, 3276, 2, seed=rows)
    got = k7.inpaint_stack(x, known, 409)
    want = k7.inpaint_stack_plain(x, known, 409)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@NEEDS_GPU
def test_inpaint_stack_all_known_row_comes_back_as_it_was():
    x = torch.randn(2, 4, 48, device="cuda")
    assert torch.equal(k7.inpaint_stack(x, np.ones(48, bool), 6), x)


@NEEDS_GPU
def test_inpaint_route_table_matches_the_built_kernel():
    from srsran_ce_tpu_torch.ops.kernels import _build

    lib = _build.load("inpaint")
    assert lib.srs_inpaint_num_routes() == len(k7.ROUTES)
    assert [lib.srs_inpaint_capacity(r) for r in range(len(k7.ROUTES))] == [
        k7.capacity(r) for r in range(len(k7.ROUTES))]


@NEEDS_GPU
def test_inpaint_stack_rejects_what_the_kernel_does_not_take():
    known, x = k7_inputs(2, 4, 48, 2)
    with pytest.raises(TypeError, match="float32"):
        k7.inpaint_stack(x.double(), known, 6)
    with pytest.raises(ValueError, match="contiguous"):
        k7.inpaint_stack(x.transpose(0, 1), known, 6)
    with pytest.raises(ValueError, match="known_mask"):
        k7.inpaint_stack(x, known[:-1], 6)
    n = k7.MAX_N + 1
    with pytest.raises(ValueError, match="rows of 3"):
        k7.inpaint_stack(torch.zeros((1, 1, n), device="cuda"), np.arange(n) % 2 == 0, 6)
    with pytest.raises(ValueError, match="rows of 3"):
        k7.inpaint_stack(torch.zeros((1, 1, 2), device="cuda"), np.array([True, False]), 6)


@NEEDS_GPU
@pytest.mark.parametrize("kernels", ["xla", "pallas"])
@pytest.mark.parametrize("mode", ["auto", "dense"])
def test_receiver_on_card_matches_cpu_f64(mode, kernels):
    cases = [synthetic.make_mimo_case(seed=s, n_rx=4, modulation="qpsk", n_prbs=12, n_layers=2)
             for s in (3, 4)]
    c = cases[0]
    rg = np.stack([est.split_ri(k.received_rg) for k in cases])
    pil = np.stack([est.split_ri(k.pilots) for k in cases])
    beta = np.ones(2)
    fn = rcv.build_receiver_ri(c.hop1, c.hop2, c.config, 2, 4, batched=True, mode=mode,
                               kernels=kernels)
    want = fn(torch.as_tensor(rg), torch.as_tensor(pil), torch.as_tensor(beta))  # CPU, float64
    n2, n5 = k2.launches, k5.launches
    t32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")
    got = fn(t32(rg), t32(pil), t32(beta))
    torch.cuda.synchronize()
    assert (k5.launches - n5 >= 1) == (kernels == "pallas")
    assert (k2.launches - n2 >= 1) == (kernels == "pallas" and mode == "dense")
    x, xw = got.x.double().cpu(), want.x
    assert float(((x - xw) ** 2).sum() / (xw**2).sum()) <= 1e-9
    assert rel(got.sinr, want.sinr) <= 1e-4


@NEEDS_GPU
def test_decoded_serving_host_and_device_on_card():
    code = tl.array_code(8, 16, 61)
    plan = tl.make_ldpc_plan(code)
    coding = transport.TransportCoding(code=code, n_iters=30, interleave_seed=77, crc="crc16",
                                       early_iters=None)
    probe = synthetic.make_mimo_case(seed=5100, n_rx=2, modulation="16qam", scramble=False,
                                     n_prbs=12, n_layers=2, snr_db=20.0)
    n_sc, n_sym = probe.data_mask.shape
    lay = transport.layout(coding, probe.hop1, probe.hop2, n_sc, n_sym, 2, 4)
    rng = np.random.default_rng(1)
    u = rng.integers(0, 2, (lay.c_words, transport.payload_bits(coding, plan.k)), dtype=np.uint8)
    bits = transport.place_codewords(lay, tl.encode(code, transport.crc_attach(u, "crc16")), 2, 4,
                                     fill_rng=rng)
    case = synthetic.make_mimo_case(seed=5100, n_rx=2, modulation="16qam", scramble=False,
                                    n_prbs=12, n_layers=2, snr_db=20.0, bits=bits)
    prob = serving.Problem(case.received_rg.astype(np.complex64), case.pilots.astype(np.complex64),
                           case.beta, case.hop1, case.hop2, case.config)
    kw = dict(batch_size=2, out="decoded", modulation="16qam", coding=coding)
    out = {}
    for on_device in (False, True):
        n4 = k4.launches
        out[on_device] = serving.process([prob] * 3, decode_on_device=on_device, **kw)
        assert k4.launches - n4 == (2 if on_device else 1)  # one decode per chunk / per call
    for rh, rd in zip(out[False], out[True]):
        assert rd.soft is None and np.array_equal(rh.info, rd.info) and np.array_equal(rh.ok, rd.ok)
        assert np.array_equal(rd.info, u) and bool(np.all(rd.ok))


# --- multi-slot tracking and the denoisers on the card (plain torch and cuDNN,
# with K2 / K6 behind learned smoothing on the pallas tier) -------------------


def _ri_batch(cases, dtype, device):
    t = lambda a: torch.as_tensor(np.stack(a), dtype=dtype, device=device)
    return (t([est.split_ri(c.received_rg) for c in cases]),
            t([est.split_ri(c.pilots) for c in cases]), t([c.beta for c in cases]))


@NEEDS_GPU
@pytest.mark.parametrize("layout", ["serve", "factored"])
def test_tracked_estimator_on_card_matches_cpu_f64(layout):
    """Four soundings of a static channel, two problems: the card (float32)
    against the CPU (float64) at grid NMSE <= 1e-9, states and weights within
    relative 1e-5."""
    from srsran_ce_tpu_torch.models import tracking

    kw = dict(n_prbs=24, n_layers=2, snr_db=5.0, cfo_hz=200.0)
    c0 = synthetic.make_case(seed=5, **kw)
    fn = tracking.build_tracked_ri(c0.hop1, c0.hop2, c0.config, 2, batched=True,
                                   out_layout=layout)
    s_gpu = tracking.init_state(c0.hop1, c0.hop2, c0.config, 2, batch=2)
    s_cpu = tracking.init_state(c0.hop1, c0.hop2, c0.config, 2, batch=2, dtype=torch.float64,
                                device="cpu")
    field = "profiles" if layout == "factored" else "channel_est_rg"
    for s in range(4):
        cases = [synthetic.make_case(seed=5 + k, noise_seed=100 + s, **kw) for k in range(2)]
        rg, pil, beta = _ri_batch(cases, torch.float32, "cuda")
        got, *s_gpu = fn(rg, pil, beta, *s_gpu)
        want, *s_cpu = fn(*(a.double().cpu() for a in (rg, pil, beta)), *s_cpu)
        g, w = getattr(got, field).double().cpu(), getattr(want, field)
        assert float(((g - w) ** 2).sum() / (w**2).sum()) <= 1e-9
        assert rel(s_gpu[1], s_cpu[1]) <= 1e-5
        assert all(rel(a, b) <= 1e-5 for a, b in zip(s_gpu[0], s_cpu[0]))
    assert s_gpu[1].device.type == "cuda" and float(s_gpu[1].min()) > 3.0


@NEEDS_GPU
def test_tracked_receiver_on_card_matches_cpu_f64():
    from srsran_ce_tpu_torch.models import tracking

    mk = dict(n_rx=4, modulation="qpsk", n_prbs=12, n_layers=2, snr_db=5.0)
    c0 = synthetic.make_mimo_case(seed=3, **mk)
    fn = rcv.build_tracked_receiver_ri(c0.hop1, c0.hop2, c0.config, 2, 4, batched=True,
                                       modulation="qpsk")
    h0, w0 = tracking.init_state(c0.hop1, c0.hop2, c0.config, 2, batch=4, device="cpu")
    st = lambda dt, dev: (tuple(torch.stack([h] * 2).to(dev, dt) for h in h0),
                          torch.stack([w0] * 2).to(dev, dt))
    s_gpu, s_cpu = st(torch.float32, "cuda"), st(torch.float64, "cpu")
    for s in range(3):
        cases = [synthetic.make_mimo_case(seed=3 + k, noise_seed=40 + s, **mk) for k in range(2)]
        rg, pil, beta = _ri_batch(cases, torch.float32, "cuda")
        got, *s_gpu = fn(rg, pil, beta, *s_gpu)
        want, *s_cpu = fn(*(a.double().cpu() for a in (rg, pil, beta)), *s_cpu)
        d = torch.stack([(a.cpu().to(torch.int16) - b.to(torch.int16)).abs()
                         for a, b in zip(got.llr, want.llr)])
        assert int(d.max()) <= 1 and float((d > 0).double().mean()) <= 1e-3
        assert rel(got.sinr, want.sinr) <= 1e-4
        assert rel(s_gpu[1], s_cpu[1]) <= 1e-5
    assert float(s_gpu[1].min()) > 2.0


@NEEDS_GPU
@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_denoiser_on_card_matches_cpu_with_tf32_allowed(kind):
    """The module pins cudnn.allow_tf32 off around its convolutions: with
    TF32 allowed by the caller the card still agrees with the CPU to float32
    rounding (TF32 would leave ~1e-3), and the caller's flag comes back."""
    from srsran_ce_tpu_torch.models import denoiser as dn

    rng = np.random.default_rng(5)
    shape = (64, 636) if kind == "1d" else (8, 4, 636)
    h = torch.as_tensor(rng.standard_normal(shape) + 1j * rng.standard_normal(shape),
                        dtype=torch.complex64)
    apply = dn.apply_complex if kind == "1d" else dn.apply_complex_2d
    want = apply(dn.load_shipped(kind, device="cpu"), h)
    prev = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        got = apply(dn.load_shipped(kind), h.cuda())
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    err = float((got.cpu() - want).abs().max() / want.abs().max())
    assert got.device.type == "cuda" and err <= 1e-5, err


@NEEDS_GPU
@pytest.mark.parametrize("layout", ["serve", "ref"])
def test_learned_pallas_launches_k2_k6_and_matches_cpu_f64(layout):
    """Learned smoothing with the shipped params on kernels="pallas": the
    serve layout takes the deferred fill, K2 once a hop; the reference layout
    K6 once a hop. Against the float64 CPU run at NMSE <= 1e-9."""
    from srsran_ce_tpu_torch.models import denoiser as dn

    for kw in (dict(n_prbs=24, n_layers=2), dict(n_prbs=12, n_layers=1, two_hops=True)):
        cases = [synthetic.make_case(seed=s, snr_db=10.0, smoothing="learned", **kw)
                 for s in (7, 8)]
        c = cases[0]
        n_hops = 2 if kw.get("two_hops") else 1
        fn = est.build_ri(c.hop1, c.hop2, c.config, kw["n_layers"], batched=True,
                          kernels="pallas", out_layout=layout)
        rg, pil, beta = _ri_batch(cases, torch.float32, "cuda")
        n2, n6 = k2.launches, k6.launches
        got = fn(rg, pil, beta, dn.load_shipped("1d"))
        torch.cuda.synchronize()
        assert (k2.launches - n2, k6.launches - n6) == (
            (n_hops, 0) if layout == "serve" else (0, n_hops))
        want = fn(*(a.double().cpu() for a in (rg, pil, beta)), dn.load_shipped("1d", device="cpu"))
        g, w = got.channel_est_rg.double().cpu(), want.channel_est_rg
        assert float(((g - w) ** 2).sum() / (w**2).sum()) <= 1e-9


def _train_steps(params, opt_state, two_d, n, seed=4):
    """n TrainStep calls from (params, opt_state) on the params' device, the
    seeded batches made on the host; returns (params, opt_state, losses)."""
    from srsran_ce_tpu_torch.models import denoiser as dn
    from srsran_ce_tpu_torch.models import training as tr

    tx = tr.make_optimizer(1e-3, decay_steps=5)
    step = tr.build_train_step_2d(tx) if two_d else tr.build_train_step(tx)
    rng = np.random.default_rng(seed)
    losses = []
    for _ in range(n):
        if two_d:
            noisy, truth = dn.make_training_batch_2d(rng, 32, 128)
        else:
            noisy, truth = dn.make_training_batch(rng, 64, 128)
        params, opt_state, loss = step(params, opt_state, noisy, truth)
        losses.append(float(loss))
    return params, opt_state, losses


@NEEDS_GPU
@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_training_steps_on_card_match_cpu(kind):
    """5 float32 training steps on the card against the CPU from the same
    params and batches (cuDNN with TF32 pinned off against the CPU's
    convolutions): losses within relative 1e-4; the params within 1e-2
    absolute (Adam's update is about lr * sign(g), so a gradient element
    near zero whose sign differs between two summation orders moves its
    parameter by 2 lr = 2e-3: at most one such flip a step, five steps)."""
    from srsran_ce_tpu_torch.models import training as tr

    init = tr.init_state_2d if kind == "2d" else tr.init_state
    st_cpu, _ = init(0, device="cpu")
    st_gpu, _ = init(0, device="cuda")
    assert all(torch.equal(st_gpu.params[k].cpu(), v) for k, v in st_cpu.params.items())
    p_c, _, l_c = _train_steps(st_cpu.params, st_cpu.opt_state, kind == "2d", 5)
    p_g, _, l_g = _train_steps(st_gpu.params, st_gpu.opt_state, kind == "2d", 5)
    assert p_g["convs.0.weight"].device.type == "cuda"
    assert max(abs(a - b) / b for a, b in zip(l_g, l_c)) <= 1e-4, (l_g, l_c)
    assert max(float((p_g[k].cpu() - p_c[k]).abs().max()) for k in p_c) <= 1e-2


@NEEDS_GPU
def test_checkpoint_resume_on_card_bit_equal(tmp_path):
    """3 steps, save, load, 2 more steps equal to 5 uninterrupted steps bit for
    bit, with cuDNN's deterministic algorithms (set here only)."""
    from srsran_ce_tpu_torch.models import training as tr

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        st, _ = tr.init_state(1, device="cuda")
        p5, o5, l5 = _train_steps(st.params, st.opt_state, False, 5)
        p3, o3, l3 = _train_steps(st.params, st.opt_state, False, 3)
        tr.save_checkpoint(tmp_path / "c.npz", tr.TrainState(p3, o3, 3))
        back = tr.load_checkpoint(tmp_path / "c.npz", device="cuda")
        assert back.step == 3 and back.opt_state.count == 3 == back.opt_state.schedule_count
        # the same batches 4 and 5: replay the generator past the first 3
        from srsran_ce_tpu_torch.models import denoiser as dn

        rng = np.random.default_rng(4)
        for _ in range(3):
            dn.make_training_batch(rng, 64, 128)
        step = tr.build_train_step(tr.make_optimizer(1e-3, decay_steps=5))
        p, o = back.params, back.opt_state
        losses = []
        for _ in range(2):
            p, o, loss = step(p, o, *dn.make_training_batch(rng, 64, 128))
            losses.append(float(loss))
    finally:
        torch.backends.cudnn.deterministic = prev
    assert l3 == l5[:3] and losses == l5[3:]
    assert all(torch.equal(p[k], p5[k]) for k in p5)
    assert all(torch.equal(o.mu[k], o5.mu[k]) and torch.equal(o.nu[k], o5.nu[k]) for k in p5)


@NEEDS_GPU
@pytest.mark.parametrize("trial", [0, 2])
def test_coded_fuzz_trial_on_card_launches_k4(trial):
    """A deep coded-fuzz trial on the card: the exact payload, and K4 launched
    on the host decode path (trial 0) and on the device decode path (trial 2):
    the fuzz's array_code(4, 8, 23) takes the "pallas" tier on the card."""
    from srsran_ce_tpu_torch.ops.kernels import ldpc as k4
    from srsran_ce_tpu_torch.validation import deepfuzz

    n0 = k4.launches
    row = deepfuzz.coded_trial(trial, device="cuda")
    torch.cuda.synchronize()
    assert row["ok"], row["config"]
    assert row["config"]["dev"] == (trial == 2)
    assert k4.launches > n0


@NEEDS_GPU
def test_debug_case_on_card(tmp_path):
    """conformance.debug_case on the card in float64 with an injected
    0.8 at 37 degrees gain: the gain recovered, the report equal to the CPU's
    (numbers within relative 1e-9)."""
    from srsran_ce_tpu_torch.utils import vectors
    from srsran_ce_tpu_torch.validation import conformance, synth_vectors

    header = synth_vectors.generate_suite(tmp_path, [dict(n_prbs=24, n_layers=2, comb=2,
                                                          scs_hz=30e3)], seed0=7100)
    case = vectors.parse_test_header(header)[0]
    path = tmp_path / f"port_channel_estimator_test_output_ch_est{case.idx}.dat"
    ent = vectors.load_entries(path)
    vectors.write_entries(path, ent["sym"], ent["port"], ent["sc"],
                          ent["value"] * 0.8 * np.exp(1j * np.deg2rad(37.0)))
    rep = conformance.debug_case(case, tmp_path, device="cuda")
    best = rep["candidates"][0]
    assert abs(best["gain_abs"] - 0.8) < 1e-3 and abs(best["gain_deg"] - 37.0) < 0.1
    assert best["nmse_after_gain"] < 1e-9 < best["nmse"]
    want = conformance.debug_case(case, tmp_path, device="cpu")
    for g, w in zip(rep["candidates"], want["candidates"]):
        assert g["ordering"] == w["ordering"]
        for key in ("rms", "nmse", "gain_abs", "gain_deg", "nmse_after_gain"):
            assert abs(g[key] - w[key]) <= 1e-9 * max(abs(w[key]), 1e-4), (key, g[key], w[key])


# --- one CUDA graph per builder call (graphs.py) and the pinned staging of
# the serving front-end --------------------------------------------------------

from srsran_ce_tpu_torch import graphs  # noqa: E402
from srsran_ce_tpu_torch.models import tracking  # noqa: E402

KMODS = (k1, k2, k5, k6, k4, k3, k7)


def _fields(res):
    import dataclasses

    if isinstance(res, (tuple, list)):
        return [t for r in res for t in _fields(r)]
    if dataclasses.is_dataclass(res):
        return _fields(tuple(getattr(res, f.name) for f in dataclasses.fields(res)))
    return [res]


def _graphed_vs_eager(fn, args, other):
    """The eager result, the key's first call (eager, the warm-up), its second
    (the capture and a replay), its third (a replay) and a fourth call on
    `other` inputs: every call bit-identical to the eager one, the replay's
    launches per kernel equal to the eager call's, and the replay's result
    unchanged by the later call."""
    graphs.clear()  # a builder of an earlier test may hold this key's graph
    with graphs.eager():
        want = fn(*args)
        n0 = [m.launches for m in KMODS]
        fn(*args)
        eager_n = [m.launches - a for m, a in zip(KMODS, n0)]
    c0 = graphs.captures
    first = fn(*args)
    assert graphs.captures == c0
    second = fn(*args)
    assert graphs.captures == c0 + 1
    n0, r0 = [m.launches for m in KMODS], graphs.replays
    got = fn(*args)
    assert graphs.captures == c0 + 1 and graphs.replays == r0 + 1
    assert [m.launches - a for m, a in zip(KMODS, n0)] == eager_n
    held = [t.clone() for t in _fields(got)]
    fn(*other)
    torch.cuda.synchronize()
    for a, b, c, d, e in zip(_fields(got), _fields(want), _fields(first), held,
                             _fields(second)):
        assert torch.equal(a, b) and torch.equal(c, b) and torch.equal(a, d)
        assert torch.equal(e, b)
    return eager_n


@NEEDS_GPU
@pytest.mark.parametrize("kernels,layout", [
    ("pallas_front", "serve"), ("pallas_front", "factored"), ("pallas", "ref"),
    ("pallas", "serve"), ("xla", "serve"), ("xla", "ref"), ("xla", "factored")])
@pytest.mark.parametrize("name,kw", [FRONT_CASES[0], FRONT_CASES[2]], ids=["nL4", "two_hops"])
def test_graphed_estimator_equals_eager(name, kw, kernels, layout):
    case, rg, pil, beta = case_inputs(kw, 8, torch.float32, "cuda", seed=11)
    _, rg2, pil2, beta2 = case_inputs(kw, 8, torch.float32, "cuda", seed=12)
    fn = est.build_ri(case.hop1, case.hop2, case.config, case.pilots.shape[2], batched=True,
                      kernels=kernels, out_layout=layout)
    n = _graphed_vs_eager(fn, (rg, pil, beta), (rg2, pil2, beta2))
    assert (n[0] > 0) == (kernels == "pallas_front")
    assert (n[2] > 0) == (kernels == "pallas" and layout == "ref")
    one = est.build_ri(case.hop1, case.hop2, case.config, case.pilots.shape[2])
    _graphed_vs_eager(one, (rg[0], pil[0], beta[0]), (rg2[0], pil2[0], beta2[0]))


@NEEDS_GPU
def test_graphed_tracked_estimator_equals_eager_over_slots():
    kw = dict(n_prbs=24, n_layers=2, snr_db=5.0, cfo_hz=200.0)
    c0 = synthetic.make_case(seed=5, **kw)
    fn = tracking.build_tracked_ri(c0.hop1, c0.hop2, c0.config, 2, batched=True,
                                   out_layout="serve")
    s_g = s_e = tracking.init_state(c0.hop1, c0.hop2, c0.config, 2, batch=2)
    for s in range(3):
        cases = [synthetic.make_case(seed=5 + k, noise_seed=100 + s, **kw) for k in range(2)]
        args = _ri_batch(cases, torch.float32, "cuda")
        got, *s_g = fn(*args, *s_g)
        with graphs.eager():
            want, *s_e = fn(*args, *s_e)
        for a, b in zip(_fields((got, s_g)), _fields((want, s_e))):
            assert torch.equal(a, b)
    assert float(s_g[1].min()) > 2.0


@NEEDS_GPU
@pytest.mark.parametrize("mode,kernels,modulation", [
    ("auto", "xla", None), ("auto", "pallas", "qpsk"), ("dense", "pallas", "16qam")])
def test_graphed_receiver_equals_eager(mode, kernels, modulation):
    mk = dict(n_rx=4, modulation="qpsk", n_prbs=12, n_layers=2, snr_db=20.0)
    cases = [synthetic.make_mimo_case(seed=s, **mk) for s in (3, 4)]
    c = cases[0]
    fn = rcv.build_receiver_ri(c.hop1, c.hop2, c.config, 2, 4, batched=True, mode=mode,
                               kernels=kernels, modulation=modulation)
    args = _ri_batch(cases, torch.float32, "cuda")
    other = _ri_batch(cases[::-1], torch.float32, "cuda")
    n = _graphed_vs_eager(fn, args, other)
    assert (n[2] > 0) == (kernels == "pallas") and (n[1] > 0) == (mode == "dense")
    fn = rcv.build_tracked_receiver_ri(c.hop1, c.hop2, c.config, 2, 4, batched=True,
                                       modulation=modulation)
    h0, w0 = tracking.init_state(c.hop1, c.hop2, c.config, 2, batch=4)
    st = (tuple(torch.stack([h] * 2) for h in h0), torch.stack([w0] * 2))
    _graphed_vs_eager(fn, args + st, other + st)


@NEEDS_GPU
def test_graphed_device_decode_equals_eager():
    code = tl.array_code(8, 16, 61)
    coding = transport.TransportCoding(code=code, n_iters=12, interleave_seed=77, crc="crc16",
                                       early_iters=None, kernels="pallas", schedule="layered")
    probs = []
    for s in (5100, 5101):
        case = synthetic.make_mimo_case(seed=s, n_rx=2, modulation="16qam", scramble=False,
                                        n_prbs=12, n_layers=2, snr_db=25.0)
        probs.append(serving.Problem(case.received_rg.astype(np.complex64),
                                     case.pilots.astype(np.complex64), case.beta, case.hop1,
                                     case.hop2, case.config))
    kw = dict(batch_size=2, out="decoded", modulation="16qam", coding=coding,
              decode_on_device=True)
    with graphs.eager():
        want = serving.process(probs * 3, **kw)
    n4, r0 = k4.launches, graphs.replays
    got = serving.process(probs * 3, **kw)
    assert k4.launches - n4 == 3  # one a chunk: eager, then the capture's replay, a replay
    assert graphs.replays - r0 == 2
    for g, w in zip(got, want):
        assert np.array_equal(g.info, w.info) and np.array_equal(g.ok, w.ok)
        assert all(getattr(g, f) == getattr(w, f) for f in serving._SCALARS)


@NEEDS_GPU
def test_served_chunk_replay_launches_k3_once_on_the_pair_route():
    """The served decode chunk (`serving._device_decode_chunk`) at NR BG1
    Z=384, layered 16 sweeps, bfloat16 messages (8 slots a chunk, at most one
    wave of words): one replay of its graph adds exactly one K3 launch, on the
    pair route, to both counters, and the payloads come back exact."""
    code = tnr.nr_base_graph(1, 384)
    coding = transport.TransportCoding(
        code=code, rate_match="nr", tx_bits=2 * 8448, schedule="layered", n_iters=16,
        crc="crc24b", interleave_seed=7, layered_group=tl.default_layered_group(code),
        stream_c2v_dtype="bfloat16")
    geo = synthetic.make_case(seed=4242, snr_db=15.0, n_prbs=273, n_layers=1)
    lay = transport.layout(coding, geo.hop1, geo.hop2, *geo.received_rg.shape, 1, 2)
    assert 8 * lay.c_words <= sm_count()
    rng = np.random.default_rng(4242)
    u = rng.integers(0, 2, (lay.c_words, transport.payload_bits(coding, tl.make_ldpc_plan(code).k)),
                     dtype=np.uint8)
    bits = transport.place_codewords(lay, tl.encode(code, transport.crc_attach(u, "crc24b")), 1, 2,
                                     fill_rng=rng)
    case = synthetic.make_mimo_case(seed=4242, n_rx=1, modulation="qpsk", scramble=False, bits=bits,
                                    n_prbs=273, n_layers=1, snr_db=15.0)
    prob = serving.Problem(case.received_rg.astype(np.complex64), case.pilots.astype(np.complex64),
                           case.beta, case.hop1, case.hop2, case.config)
    kw = dict(batch_size=8, out="decoded", modulation="qpsk", coding=coding,
              matmul_precision="high", decode_on_device=True)
    for _ in range(2):  # the chunk's key: eager, then the capture and its replay
        serving.process([prob] * 8, **kw)
    n0, routes0, r0 = k3.launches, dict(k3.route_launches), graphs.replays
    res = serving.process([prob] * 8, **kw)
    torch.cuda.synchronize()
    assert graphs.replays - r0 == 1 and k3.launches - n0 == 1
    assert {r: n - routes0[r] for r, n in k3.route_launches.items()} == {
        "chip": 0, "stream": 0, "pair": 1}
    assert all(bool(np.all(r.ok)) and np.array_equal(r.info, u) for r in res)


@NEEDS_GPU
def test_failed_capture_raises_and_never_falls_back():
    calls = []

    def forward(x):
        calls.append(1)
        return x * float(x.sum())  # a host synchronisation: no graph holds it

    fn = graphs.Graphed(forward, "sync_probe")
    x = torch.ones(4, device="cuda")
    assert torch.equal(fn(x), x * 4.0)  # the key's first call runs eagerly
    for _ in range(2):
        with pytest.raises(graphs.GraphCaptureError, match="sync_probe on cuda"):
            fn(x)
    assert graphs.cached() <= graphs.MAX_GRAPHS and len(calls) == 3  # eager, then two captures
    with graphs.eager():
        assert torch.equal(fn(x), x * 4.0)


@NEEDS_GPU
def test_staging_buffers_wait_for_their_copies():
    """Three batches staged while the stream is held by a long kernel
    (inflight=3): each gets its own pinned buffer (its copy has not run), and
    every device tensor holds its own batch."""
    dev = torch.device("cuda")
    shape = (5, 2, 37, 3)
    torch.cuda._sleep(200_000_000)
    outs, ptrs = [], []
    for i in range(3):
        def fill(out, i=i):
            ptrs.append(out.ctypes.data)
            out[...] = i
            return out
        outs.append(serving._stage(fill, shape, torch.float32, dev))
    assert len(set(ptrs)) == 3
    torch.cuda.synchronize()
    for i, t in enumerate(outs):
        assert bool((t == i).all())


@NEEDS_GPU
def test_process_inflight_three_equals_one_and_eager():
    cases = [synthetic.make_case(seed=70 + i, n_prbs=24, n_layers=2, snr_db=30.0)
             for i in range(9)]
    probs = [serving.Problem(c.received_rg.astype(np.complex64), c.pilots.astype(np.complex64),
                             c.beta, c.hop1, c.hop2, c.config) for c in cases]
    res = {n: serving.process(probs, batch_size=2, inflight=n) for n in (1, 3)}
    with graphs.eager():
        res[0] = serving.process(probs, batch_size=2, inflight=3)
    for a, b, c in zip(res[3], res[1], res[0]):
        assert np.array_equal(a.channel_est_rg, b.channel_est_rg)
        assert np.array_equal(a.channel_est_rg, c.channel_est_rg)
        assert a.noise_est == b.noise_est == c.noise_est


# ---------------------------------------------------------------------------
# K1 on NaN input; the sharded paths on the card (NCCL world 1, gloo on cuda:0)
# ---------------------------------------------------------------------------

from srsran_ce_tpu_torch.parallel import launch  # noqa: E402
from srsran_ce_tpu_torch.validation import sharded  # noqa: E402


@NEEDS_GPU
def test_fused_front_nan_input_takes_the_first_nan():
    """A grid of inf gives NaN PDPs: K1's TA argmax must take the first NaN as
    the maximum (jnp.argmax, the plain front's mathx.argmax_last), so its TA
    and channels equal the plain front's (NaN where it is NaN)."""
    c = synthetic.make_case(seed=3, n_prbs=4, n_layers=1, n_dmrs_syms=1)
    plan = make_plan(c.hop1, c.hop2, c.config, 1)
    assert est._front_pallas_ok(plan)
    rg = np.full_like(est.split_ri(c.received_rg.astype(np.complex64)), np.inf)
    pil = est.split_ri(c.pilots.astype(np.complex64))
    fn = est.build_ri(c.hop1, c.hop2, c.config, 1, batched=True, kernels="pallas_front",
                      out_layout="serve")
    out = {}
    for dev in ("cpu", "cuda"):
        n0 = k1.launches
        out[dev] = fn(torch.as_tensor(rg[None], device=dev), torch.as_tensor(pil[None], device=dev),
                      torch.ones(1, device=dev))
        assert k1.launches == n0 + (dev == "cuda")
    got, want = out["cuda"], out["cpu"]
    assert float(got.time_alignment) == float(want.time_alignment) < 0
    for f in ("channel_est_rg", "noise_est", "rsrp", "epre"):
        torch.testing.assert_close(getattr(got, f).cpu(), getattr(want, f), equal_nan=True,
                                   rtol=1e-5, atol=1e-6)


@NEEDS_GPU
def test_gloo_halo_route_on_the_card():
    """gloo's send/recv take no CUDA tensor: a halo forced onto them fails on
    cuda:0 (the rank raises or aborts) and goes through on the CPU. So a gloo
    world on the card exchanges its halos by all_gather, and its halos, psum
    and all_gather equal the CPU world's bit for bit."""
    from torch.multiprocessing.spawn import ProcessException

    probe = [dict(name="probe", kind="p2p_probe")]
    with pytest.raises(ProcessException):
        launch.spawn_world(sharded.run_cases, 2, "gloo", "cuda", args=(probe, "cuda"))
    assert "probe" in launch.spawn_world(sharded.run_cases, 2, "gloo", "cpu", args=(probe, "cpu"))[0]
    spec = [dict(name="halo", kind="halo")]
    card = launch.spawn_world(sharded.run_cases, 2, "gloo", "cuda", args=(spec, "cuda"))[0]
    cpu = launch.spawn_world(sharded.run_cases, 2, "gloo", "cpu", args=(spec, "cpu"))[0]
    assert card["halo"]["auto_route"] == "all_gather" and cpu["halo"]["auto_route"] == "p2p"
    assert card["_halo_routes"].get("all_gather", 0) > 0
    assert card["halo"]["same"] and cpu["halo"]["same"]
    for k in ("xs", "lefts", "rights", "psum", "x"):
        assert np.array_equal(card["halo"][k], cpu["halo"][k]), k


SHARDED_CARD_SPECS = [
    dict(name="dp c2", kind="dp_batched", mesh=(1, 1), dtype="float32", seed=11, batch=8,
         kw=dict(n_prbs=106, n_layers=4)),
    dict(name="sp hopped", kind="sp_batched", mesh=(1, 1), dtype="float32", seed=12, batch=64,
         kw=dict(n_prbs=24, n_layers=1, two_hops=True)),
    dict(name="sp 273", kind="sp", mesh=(1, 1), dtype="float64", seed=13,
         kw=dict(n_prbs=273, n_layers=1)),
    dict(name="sp receiver", kind="sp_receiver", mesh=(1, 1), dtype="float32", seed=3, batch=4,
         n_rx=2, kw=dict(n_prbs=24, n_layers=2), modulation="qpsk"),
    dict(name="dp decoder", kind="dp_decoder", mesh=(1, 1), code=("array", 6, 16, 61), batch=64,
         n_iters=25),
]


@NEEDS_GPU
@pytest.mark.parametrize("backend,n", [("nccl", 1), ("gloo", 2)])
def test_sharded_builders_on_the_card(backend, n):
    """The sharded builders on the card against the unsharded port on the same
    card and dtype: over NCCL at world size 1 the DP builders and the hopped
    route bit for bit and every graphed replay equal to its eager call; over
    gloo with two ranks on cuda:0 within 1e-4 (float64: 1e-12) and the
    float64 oracle (NMSE < 1e-12, float64 1e-18)."""
    specs = [dict(s, mesh=(n, 1) if s["mesh"] == (1, 1) and s["kind"].startswith("dp") else
                  (1, n)) for s in SHARDED_CARD_SPECS]
    res = launch.spawn_world(sharded.run_cases, n, backend, "cuda", args=(specs, "cuda", True))[0]
    for s in specs:
        r = res[s["name"]]
        f64 = s.get("dtype") == "float64"
        if "payload_exact" in r:
            assert r["payload_exact"] and r["ok"] and r["bit_identical"], s["name"]
            continue
        if backend == "nccl":
            assert r["graph_replayed"] and r["graphed_equal"], s["name"]
            if s["kind"] in ("dp_batched", "sp_batched"):
                assert r["bit_identical"], s["name"]
        worst = max(v for k, v in r["rel"].items() if k != "llr")
        assert worst <= (1e-12 if f64 else 1e-4), (s["name"], r["rel"])
        if "llr_max_step" in r:
            assert r["llr_max_step"] <= 1 and r["llr_diff_share"] <= 1e-3
        if "nmse_vs_oracle" in r:
            assert r["nmse_vs_oracle"] < (1e-18 if f64 else 1e-12), s["name"]


# ---------------------------------------------------------------------------
# The bench's chain (utils/profiling.Chain): a CUDA graph of a unit of calls
# ---------------------------------------------------------------------------

from srsran_ce_tpu_torch.bench import throughput as bench_tp  # noqa: E402
from srsran_ce_tpu_torch.utils import profiling  # noqa: E402


@NEEDS_GPU
def test_graphed_chain_equals_the_eager_loop():
    """The bench's c2 pallas_front row at B=128: 8 chained calls replayed from
    the chain's CUDA graph (one unit of 8) leave the carry the eager loop
    leaves, bit for bit; K1 counts the warm-up call and the 8 of the replay,
    then the 8 of the eager loop."""
    dev = torch.device("cuda")
    case = synthetic.make_case(seed=1234, snr_db=30.0,
                               **bench_tp.BENCH_CONFIGS[bench_tp.HEADLINE][0])
    body, carry = bench_tp.row_chain(case, 128, dev, kernels="pallas_front")
    chain = profiling.Chain(body, carry, 8)
    n0 = k1.launches
    got = chain.run(8).clone()
    torch.cuda.synchronize()
    assert k1.launches - n0 == 1 + 8
    with graphs.eager():
        want = carry
        for _ in range(8):
            want = body(want)
    torch.cuda.synchronize()
    assert k1.launches - n0 == 1 + 8 + 8
    assert torch.equal(got, want)
    assert not torch.equal(got, carry)  # the chain moved the carry
    assert torch.equal(chain.run(8), got)  # each run starts from the carry
    chain.release()


from srsran_ce_tpu_torch.utils import spans  # noqa: E402


@NEEDS_GPU
def test_spans_time_the_replays_on_the_card():
    """A decoded call of three chunks, every chunk's graph replayed, with the
    spans on: one `graphs.replay` span a chunk inside the call, their CUDA
    event pairs all resolved by the snapshot with a positive device time, the
    staged bytes those of the three chunks, and the results those of the same
    call with the spans off; off, nothing is recorded."""
    code = tl.array_code(8, 16, 61)
    coding = transport.TransportCoding(code=code, n_iters=12, interleave_seed=77, crc="crc16",
                                       early_iters=None, kernels="pallas", schedule="layered")
    case = synthetic.make_mimo_case(seed=5100, n_rx=2, modulation="16qam", scramble=False,
                                    n_prbs=12, n_layers=2, snr_db=25.0)
    probs = [serving.Problem(case.received_rg.astype(np.complex64),
                             case.pilots.astype(np.complex64), case.beta, case.hop1, case.hop2,
                             case.config)] * 6
    kw = dict(batch_size=2, out="decoded", modulation="16qam", coding=coding,
              decode_on_device=True)
    for _ in range(2):  # eager, then captured: every later chunk replays
        serving.process(probs, **kw)
    s0 = spans.snapshot()
    off = serving.process(probs, **kw)
    assert spans.snapshot() == s0
    r0 = graphs.replays
    with spans.enabled():
        on = serving.process(probs, **kw)
    s1 = spans.snapshot()
    assert graphs.replays - r0 == 3
    d = {n: s1["spans"][n]["count"] - s0["spans"].get(n, {}).get("count", 0)
         for n in ("serving.process", "graphs.replay", "serving.pack", "serving.unpack")}
    # a pack and a copy each of the grids, the pilots and the betas, a chunk
    assert d == {"serving.process": 1, "graphs.replay": 3, "serving.pack": 9,
                 "serving.unpack": 3}
    assert s1["counters"]["graphs.replay_ms"] - s0["counters"].get("graphs.replay_ms", 0) > 0
    assert not spans._pending
    rg, pil = probs[0].received_rg, probs[0].pilots
    staged = 3 * 2 * (2 * rg.size * 4 + 2 * pil.size * 4 + 4)
    assert (s1["counters"]["serving.h2d_bytes"]
            - s0["counters"].get("serving.h2d_bytes", 0)) == staged
    for a, b in zip(off, on):
        assert np.array_equal(a.info, b.info) and np.array_equal(a.ok, b.ok)


@NEEDS_GPU
def test_factored_serving_at_published_widths_within_the_cells_limits():
    """One UE-slot of the 40 MHz massive-MIMO deployment (`cebench`'s
    `ce_n78_40mhz_4port_32ant`: 106 PRB, 4 DM-RS ports, 32 antennas, so 32
    problems) served by `process(out="factored")` on the card through the
    graphed path (the third call replays the captured graph), judged by the
    benchmark's float64 reference within the configuration's limits; with the
    spans on, `serving.d2h_bytes` counts the fetched profiles, rotations and
    five float32 scalars of the 32 problems."""
    from cebench import spec
    from cebench.gen import slots
    from cebench.reference import ce

    cfg = spec.read_json("configs", "ce_n78_40mhz_4port_32ant.json")
    slot = slots.ce_slot(cfg, 2**31 + 19_019, 0)
    serve = spec.load_module("chains", cfg["chain"]).server(cfg, [slot], "cuda")
    for _ in range(2):  # eager, then captured
        serve([0])
    r0 = graphs.replays
    s0 = spans.snapshot()
    with spans.enabled():
        res = serve([0])[0]
    s1 = spans.snapshot()
    assert graphs.replays - r0 == 1 and len(res) == 32
    nums = ce.judge_slot(slot, res, ce.reference(slot))
    for k, limit in cfg["limits"].items():
        assert nums[k] <= limit, (k, nums[k], limit)
    fetched = s1["counters"]["serving.d2h_bytes"] - s0["counters"].get("serving.d2h_bytes", 0)
    assert fetched == 32 * (res[0].profiles.nbytes + res[0].sym_rot.nbytes + 5 * 4)


@NEEDS_GPU
def test_two_layer_256qam_call_at_published_widths_decodes_336_words_in_one_k3_launch():
    """One 8-slot call of the 2-layer 256QAM uplink (`cebench`'s
    `pusch_n78_100mhz_4rx_2l256`: 273 PRB, 4 rx, 42 BG1 Z=384 blocks of
    12,480 bits a slot) through the cell's chain on the card: the replay of
    the chunk's graph launches K3 once, on the pair route, for 336 words past
    one wave of the card's SMs; with the spans on, `serving.decode_words`
    counts them; every payload comes back exact and every slot within the
    configuration's limits of the float64 reference."""
    from cebench import spec
    from cebench.gen import slots
    from cebench.reference import pusch

    cfg = spec.read_json("configs", "pusch_n78_100mhz_4rx_2l256.json")
    c_words = slots.pusch_layout(cfg).c_words
    assert c_words == 42 and 8 * c_words > sm_count()
    pool = [slots.pusch_slot(cfg, 2**31 + 23_023, i) for i in range(8)]
    serve = spec.load_module("chains", cfg["chain"]).server(cfg, pool, "cuda")
    for _ in range(2):  # eager, then captured
        serve(list(range(8)))
    n0, routes0, r0 = k3.launches, dict(k3.route_launches), graphs.replays
    s0 = spans.snapshot()
    with spans.enabled():
        res = serve(list(range(8)))
    s1 = spans.snapshot()
    assert graphs.replays - r0 == 1 and k3.launches - n0 == 1
    assert {r: n - routes0[r] for r, n in k3.route_launches.items()} == {
        "chip": 0, "stream": 0, "pair": 1}
    words = (s1["counters"]["serving.decode_words"]
             - s0["counters"].get("serving.decode_words", 0))
    assert words == 8 * c_words == 336
    for s, (r,) in zip(pool, res):
        assert np.array_equal(r.info, s.payload) and bool(np.all(r.ok))
        nums = pusch.judge_slot(s, [r], pusch.reference(s))
        for k, limit in cfg["limits"].items():
            assert nums[k] <= limit, (k, nums[k], limit)


# ---------------------------------------------------------------------------
# The served estimate on K1 (`estimator.served_kernels`)
# ---------------------------------------------------------------------------


def _cell_call(n_slots, seed):
    """`n_slots` UE-slots of the benchmark's 32-antenna deployment
    (`ce_n78_40mhz_4port_32ant`: 106 PRB, 4 ports, 4 DM-RS symbols, CFO
    compensated) as one `serving.process` call's problems, the served
    precision, and the float64 CPU run of the same problems on the "xla" tier
    in both served layouts."""
    problems, (hop1, hop2, high, nL) = _cell_problems(n_slots, seed)
    rg = torch.as_tensor(np.stack([est.split_ri(p.received_rg.astype(np.complex128))
                                   for p in problems]))
    pil = torch.as_tensor(np.stack([est.split_ri(p.pilots.astype(np.complex128))
                                    for p in problems]))
    beta = torch.tensor([p.beta for p in problems], dtype=torch.float64)
    want = {layout: est.build_ri(hop1, hop2, high, nL, batched=True, out_layout=layout)(
        rg, pil, beta) for layout in ("serve", "factored")}
    return problems, (hop1, hop2, high, nL), want


def _cell_problems(n_slots, seed, config="ce_n78_40mhz_4port_32ant.json"):
    """The problems of `_cell_call` and (hop1, hop2, served config, n_layers);
    `config` another CE deployment's file."""
    import dataclasses

    from cebench import spec
    from cebench.gen import slots
    from srsran_ce_tpu_torch import config as pconfig

    cfg = spec.read_json("configs", config)
    pool = [slots.ce_slot(cfg, seed, i) for i in range(n_slots)]
    s = pool[0]  # the chain's problem form (cebench/chains/ce_factored.py)
    hop1 = pconfig.HopConfig(**dataclasses.asdict(s.hop1))
    hop2 = None if s.hop2 is None else pconfig.HopConfig(**dataclasses.asdict(s.hop2))
    conf = pconfig.EstimatorConfig(**dataclasses.asdict(s.config))
    problems = [serving.Problem(np.ascontiguousarray(p.rg[r]), p.pilots, p.beta, hop1, hop2, conf)
                for p in pool for r in range(p.rg.shape[0])]
    high = dataclasses.replace(conf, matmul_precision=cfg["matmul_precision"])
    return problems, (hop1, hop2, high, int(cfg["n_layers"]))


def _served_numbers(out, got, want):
    """(worst NMSE, worst scalar relative error) of served results against
    the float64 batch `want`, by the benchmark's `numbers` (floors 1e-9 s for
    the TA, 1 Hz for the CFO)."""
    from cebench.reference import numbers

    worst_n = worst_s = 0.0
    for b, r in enumerate(got):
        if out == "grid":
            ref = est.merge_ri(want.channel_est_rg[b].numpy()).transpose(2, 1, 0)
            est_ = r.channel_est_rg
        else:
            ref = est.merge_ri(want.profiles[b].numpy())
            est_ = r.profiles
            rot = est.merge_ri(want.sym_rot[b].numpy())
            worst_n = max(worst_n, numbers.nmse(r.sym_rot, rot))
        worst_n = max(worst_n, numbers.nmse(est_, ref))
        worst_s = max(worst_s, numbers.scalar_err(
            numbers.scalars_of(r), {n: float(getattr(want, n)[b]) for n in numbers.SCALARS}))
    return worst_n, worst_s


@NEEDS_GPU
def test_served_estimate_takes_k1_at_the_cells_shape_within_its_limits():
    """128 problems of the 32-antenna cell (4 UE-slots, one chunk) through
    `process(out="factored")` and `process(out="grid")` on the card: the rule
    takes K1, which launches once a call, eager (the key's first call), at
    the capture's call and at each replay; the replay is bit-identical to the
    eager route (`graphs.eager()`), and both are within the cell's limits of
    the float64 CPU run (NMSE 1e-10, scalars relative 1e-5)."""
    problems, key, want = _cell_call(4, 2**31 + 20_001)
    assert len(problems) == 128
    report = {}
    for out, layout in (("factored", "factored"), ("grid", "serve")):
        assert est.served_kernels(*key, layout, "cuda") == "pallas_front"
        graphs.clear()
        ks, r0 = [], graphs.replays
        for _ in range(3):  # eager, captured (and replayed), replayed
            n0 = k1.launches
            got = serving.process(problems, out=out)
            ks.append(k1.launches - n0)
        assert ks == [1, 1, 1] and graphs.replays - r0 == 2, (out, ks)
        with graphs.eager():
            n0 = k1.launches
            eager = serving.process(problems, out=out)
            assert k1.launches - n0 == 1
        for a, b in zip(got, eager):
            for f in serving._SCALARS + (("profiles", "sym_rot") if out == "factored"
                                         else ("channel_est_rg",)):
                assert np.array_equal(getattr(a, f), getattr(b, f)), (out, f)
        nmse, s_err = _served_numbers(out, got, want[layout])
        report[out] = (nmse, s_err)
        assert nmse <= 1e-10 and s_err <= 1e-5, (out, nmse, s_err)
    print(f"served K1 at the cell's shape vs float64 CPU (NMSE, scalar rel err): {report}")


@NEEDS_GPU
@pytest.mark.parametrize("out", ["factored", "grid"])
def test_served_call_at_the_cells_shape_launches_k1_staged_once_a_replay(out):
    """A served call of the cell's 128 problems reads its staged grid and
    pilots in K1: over replays of its graph `front.route_launches` moves by
    {"staged": replays, "gathered": 0}, and `front_finish` launches once a
    replay."""
    problems, key = _cell_problems(4, 2**31 + 20_002)
    assert est.served_kernels(*key, "factored" if out == "factored" else "serve",
                              "cuda") == "pallas_front"
    graphs.clear()
    serving.process(problems, out=out)  # eager: the key's first call
    serving.process(problems, out=out)  # captured and replayed
    r0, routes0, f0 = graphs.replays, dict(k1.route_launches), kf.launches
    for _ in range(3):
        serving.process(problems, out=out)
    n = graphs.replays - r0
    assert n == 3
    assert {r: k - routes0[r] for r, k in k1.route_launches.items()} == {"staged": n, "gathered": 0}
    assert kf.launches - f0 == n


@NEEDS_GPU
def test_equalized_serving_launches_no_k1():
    cases = [synthetic.make_mimo_case(seed=s, n_rx=2, modulation="qpsk", n_prbs=12, n_layers=2,
                                      snr_db=20.0) for s in (7, 8, 9)]
    probs = [serving.Problem(c.received_rg.astype(np.complex64), c.pilots.astype(np.complex64),
                             c.beta, c.hop1, c.hop2, c.config) for c in cases]
    n0, r0 = k1.launches, graphs.replays
    for _ in range(3):
        serving.process(probs, batch_size=2, out="equalized")
    assert k1.launches == n0 and graphs.replays > r0


# ---------------------------------------------------------------------------
# The fused front's finish (`front_finish`)
# ---------------------------------------------------------------------------

FINISH_CASES = [
    ("one_hop", dict(n_prbs=106, n_layers=3)),
    ("two_hops", dict(n_prbs=24, n_layers=3, two_hops=True, n_dmrs_syms=3)),
    ("cell_shape", dict(n_prbs=106, n_layers=4)),
]


def _finish_call(kw, batch, fn, profiles, seed=0):
    """`fn` (`front_finish` or its plain version) on K1-shaped random outputs
    of each hop of a synthetic case's plan, on the card."""
    case = synthetic.make_case(seed=5, **kw)
    plan = make_plan(case.hop1, case.hop2, case.config, kw["n_layers"])
    pt = plan_tensors(plan, "cuda", torch.float32)
    hops = [hp for hp in (plan.hop1, plan.hop2) if hp is not None]
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")
    h_s = [t(rng.standard_normal((batch, 2, plan.n_layers, hp.n_re))) for hp in hops]
    sc = [t(np.concatenate([rng.uniform(-0.05, 0.05, (batch, 1)), rng.uniform(-2e-6, 2e-6, (batch, 1)),
                            rng.uniform(0.5, 50.0, (batch, 3)), np.zeros((batch, 3))], axis=1))
          for _ in hops]
    taps = [ht["taps"] for ht in pt["hops"]] if profiles else None
    return fn(h_s, sc, taps, pt["sst"], sc_starts=[hp.sc_start for hp in hops],
              cfo_possible=[hp.cfo_possible for hp in hops], n_sc=case.received_rg.shape[0],
              n_sym=14, n_pilots=plan.n_pilots, noise_den=plan.noise_den,
              scs_hz=plan.config.scs_hz, cfo_compensate=plan.config.cfo_compensate)


@NEEDS_GPU
@pytest.mark.parametrize("route", ["profiles", "scalars"])
@pytest.mark.parametrize("batch", [1, 128, 133])
@pytest.mark.parametrize("name,kw", FINISH_CASES, ids=[c[0] for c in FINISH_CASES])
def test_front_finish_kernel_matches_plain(name, kw, batch, route):
    profiles = route == "profiles"
    n0, r0 = kf.launches, dict(kf.route_launches)
    got = _finish_call(kw, batch, kf.front_finish, profiles)
    assert kf.launches == n0 + 1
    assert {r: n - r0[r] for r, n in kf.route_launches.items()} == {
        "profiles": int(profiles), "scalars": int(not profiles)}
    want = _finish_call(kw, batch, kf.front_finish_plain, profiles)
    torch.cuda.synchronize()
    if profiles:
        assert got[0].shape == want[0].shape and rel(got[0], want[0]) <= 1e-6, name
    else:
        assert got[0] is None
    assert got[1].shape == want[1].shape
    assert float((got[1] - want[1]).abs().max()) <= 2e-7, name
    for g, w, field in zip(got[2:], want[2:], ("noise", "rsrp", "epre", "ta", "cfo_hz")):
        assert g.shape == w.shape == (batch,), field
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-6, atol=0,
                                   err_msg=field)


@NEEDS_GPU
@pytest.mark.parametrize("interp,layout,route", [
    ("linear", "factored", "profiles"), ("linear", "serve", "scalars"),
    ("cnn", "factored", "scalars"), ("cnn", "serve", "scalars")])
def test_front_finish_route_follows_the_layout_and_the_interpolation(interp, layout, route):
    """One finish launch a call of the fused-front tier, on the profiles route
    only for the factored layout with linear interpolation (the "cnn"
    inpainting operator is not two-tap: its profiles stay a product)."""
    kw = dict(n_prbs=24, n_layers=2, comb=2, snr_db=30.0, interp=interp)
    case, rg, pil, beta = case_inputs(kw, 8, torch.float32, "cuda", seed=4)
    fn = est.build_ri(case.hop1, case.hop2, case.config, 2, batched=True, out_layout=layout,
                      kernels="pallas_front")
    n0, r0 = kf.launches, dict(kf.route_launches)
    with graphs.eager():
        got = fn(rg, pil, beta)
    assert kf.launches == n0 + 1
    assert {r: n - r0[r] for r, n in kf.route_launches.items()} == {
        "profiles": int(route == "profiles"), "scalars": int(route == "scalars")}
    want = est.build_ri(case.hop1, case.hop2, case.config, 2, batched=True,
                        out_layout=layout)(rg.double().cpu(), pil.double().cpu(),
                                           beta.double().cpu())
    field = "profiles" if layout == "factored" else "channel_est_rg"
    a, b = getattr(got, field).double().cpu(), getattr(want, field)
    assert float(((a - b) ** 2).sum() / (b**2).sum()) < 4e-11, (interp, layout)


@NEEDS_GPU
def test_front_finish_launches_once_a_replay():
    """Through the graphed path the factored call's finish is one launch on
    the profiles route each replay, as K1 is."""
    kw = FRONT_CASES[0][1]
    case, rg, pil, beta = case_inputs(kw, 16, torch.float32, "cuda", seed=6)
    fn = est.build_ri(case.hop1, case.hop2, case.config, 4, batched=True,
                      out_layout="factored", kernels="pallas_front")
    graphs.clear()  # a builder of an earlier test may hold this key's graph
    fn(rg, pil, beta)  # eager: the key's first call
    fn(rg, pil, beta)  # captured and replayed
    n0, p0, k0, r0 = kf.launches, kf.route_launches["profiles"], k1.launches, graphs.replays
    for _ in range(3):
        out = fn(rg, pil, beta)
    torch.cuda.synchronize()
    assert graphs.replays - r0 == 3
    assert kf.launches - n0 == 3 and kf.route_launches["profiles"] - p0 == 3
    assert k1.launches - k0 == 3
    with graphs.eager():
        eager = fn(rg, pil, beta)
    assert torch.equal(out.profiles, eager.profiles) and torch.equal(out.sym_rot, eager.sym_rot)


@NEEDS_GPU
def test_front_finish_refuses_bands_off_the_four_subcarrier_grid_and_unaligned_tables():
    """The kernel reads and writes 4 subcarriers as one 16-byte word: the
    wrapper refuses an n_sc or a band edge off multiples of 4 and tables not
    16-byte aligned, before any launch."""
    case = synthetic.make_case(seed=5, n_prbs=8, n_layers=2)
    plan = make_plan(case.hop1, case.hop2, case.config, 2)
    pt = plan_tensors(plan, "cuda", torch.float32)
    hp, taps = plan.hop1, pt["hops"][0]["taps"]
    h_s = [torch.randn(4, 2, 2, hp.n_re, device="cuda")]
    sc = [torch.rand(4, 8, device="cuda")]
    n_sc = case.received_rg.shape[0]

    def call(taps, sc_start=hp.sc_start, n_sc=n_sc):
        return kf.front_finish(h_s, sc, [taps], pt["sst"], sc_starts=[sc_start],
                               cfo_possible=[hp.cfo_possible], n_sc=n_sc, n_sym=14,
                               n_pilots=plan.n_pilots, noise_den=plan.noise_den,
                               scs_hz=plan.config.scs_hz, cfo_compensate=True)

    def shifted(t):  # a contiguous copy 4 bytes past a 16-byte boundary
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    n0 = kf.launches
    assert call(taps)[0].shape == (4, 2, 1, 2, n_sc)
    for bad in (dict(n_sc=n_sc + 2), dict(sc_start=hp.sc_start + 2, n_sc=n_sc + 4)):
        with pytest.raises(ValueError, match="multiples of 4"):
            call(taps, **bad)
    for name in ("left", "right", "w_l", "w_r"):
        with pytest.raises(ValueError, match="16-byte aligned"):
            call(dict(taps, **{name: shifted(taps[name])}))
    assert kf.launches == n0 + 1


# ---------------------------------------------------------------------------
# K1's banded route: every band, the wide cell's past the plan's 1,024-RE dense
# smoothing operator
# ---------------------------------------------------------------------------

WIDE_CELL = "ce_n78_100mhz_4port_64ant.json"
#: ptxas's registers of each K1 instantiation (front_kernel_banded<RN>) as they
#: were while the dense route was beside it (sm_90a, CUDA 12.8): taking the
#: dense route out left the banded body's code as it was
BANDED_FRONT_REGISTERS = {1: 121, 2: 121, 3: 121, 4: 121}


def _wide_front_inputs(batch, seed):
    """K1's staged inputs for `batch` problems of the 64-antenna cell's plan
    (273 PRB, 4 ports, n_re 1638: the banded route), each problem's grid
    perturbed by a seeded 1e-3 noise: (hop plan, hop tensors, args, kwargs)."""
    problems, (hop1, hop2, high, nL) = _cell_problems(-(-batch // 64), seed, WIDE_CELL)
    plan = make_plan(hop1, hop2, high, nL)
    pt = plan_tensors(plan, "cuda", torch.float32)
    hp, ht = plan.hop1, pt["hops"][0]
    rng = np.random.default_rng(seed % 2**32)
    rg = np.stack([est.split_ri(p.received_rg) for p in problems[:batch]])
    rg = rg + 1e-3 * rng.standard_normal(rg.shape)
    pil = np.stack([est.split_ri(p.pilots) for p in problems[:batch]])
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device="cuda")
    beta = t([p.beta for p in problems[:batch]])
    kw = dict(n_samples=hp.n_samples, half_cp_len=hp.half_cp_len, fft_size=hp.fft_size,
              scs_hz=high.scs_hz, cfo_possible=hp.cfo_possible, cfo_compensate=high.cfo_compensate,
              re_idx=ht["re_idx"], dmrs_sym_idx=ht["dmrs_sym_idx"])
    return hp, ht, (t(rg), t(pil)[:, :, :, :hp.n_dsym], beta, ht["front"]), kw


@NEEDS_GPU
def test_banded_front_kernel_at_the_cells_shape_matches_plain_and_float64():
    """K1 on its banded route at `ce100_64ant_closed2`'s shape (128 problems,
    273 PRB, 4 layers, n_re 1638, staged): against its plain version on the
    same float32 inputs (relative 1e-5, the TA bins, scalars 1e-4) and the
    plain version in float64 on the CPU (NMSE 1e-10, the cell's limit)."""
    hp, ht, args, kw = _wide_front_inputs(128, 2**31 + 25_001)
    assert est._front_banded(hp) and set(args[3]) == {"taps", "vp", "ta_c", "ta_s", "two_pi_sst_d"}
    n0 = k1.launches
    h_k, s_k = k1.fused_front(*args, **kw)
    assert k1.launches == n0 + 1
    rx, pil = k1.gather_staged(args[0], args[1], kw["re_idx"], kw["dmrs_sym_idx"])
    plain_kw = {k: v for k, v in kw.items() if k not in ("re_idx", "dmrs_sym_idx")}
    h_p, s_p = k1.fused_front_plain(rx, pil, *args[2:], **plain_kw)
    torch.cuda.synchronize()
    assert rel(h_k, h_p) <= 1e-5
    s_k, s_p = s_k.cpu().numpy(), s_p.cpu().numpy()
    to_bin = kw["fft_size"] * kw["scs_hz"]
    np.testing.assert_array_equal(np.rint(s_k[:, 1] * to_bin), np.rint(s_p[:, 1] * to_bin))
    np.testing.assert_allclose(s_k[:, [0, 2, 3, 4]], s_p[:, [0, 2, 3, 4]], rtol=1e-4, atol=1e-12)
    mats64 = {k: None if v is None else v.double().cpu() for k, v in args[3].items()}
    h_64, s_64 = k1.fused_front_plain(rx.double().cpu(), pil.double().cpu(),
                                      args[2].double().cpu(), mats64, **plain_kw)
    nmse = float(((h_k.double().cpu() - h_64) ** 2).sum() / (h_64 ** 2).sum())
    assert nmse <= 1e-10, nmse
    np.testing.assert_allclose(s_k[:, [2, 3, 4]], s_64.numpy()[:, [2, 3, 4]], rtol=1e-5)


@NEEDS_GPU
@pytest.mark.parametrize("B,nL,n_re,cfo_compensate", [
    (1, 4, 1638, True), (37, 1, 1638, True), (128, 2, 1080, False), (9, 3, 1025, True),
    (128, 4, 636, True),  # ce40_closed4's band
])
def test_banded_front_kernel_matches_plain_at_plan_shapes(B, nL, n_re, cfo_compensate):
    """K1's banded route on seeded random inputs at other batches, layer
    counts, bands (an odd CDM layout, the first band past 1,024) and without
    the CFO's compensation: against its plain version."""
    args, kw = random_front(B, nL, 4, n_re, 7, 144, True, cfo_compensate, seed=B + n_re)
    rng = np.random.default_rng(n_re)
    taps = rng.uniform(0.0, 1.0, 15)
    mats = dict(args[3], taps=torch.as_tensor(taps / taps.sum(), dtype=torch.float32,
                                              device="cuda"))
    assert_front_matches_plain(args[:3] + (mats,), kw, f"banded B={B} nL={nL} n_re={n_re}")


@NEEDS_GPU
def test_banded_launch_plan_mirrors_the_kernels_plan():
    """`front.launch_plan(..., n_taps)` against `srs_front_plan` on the
    banded route, bands from `ce40_closed4`'s to 275 PRB."""
    caps = k1.kernel_caps("cuda")
    n_cases = 0
    for cap in (caps, tuple(max(1, c // 3) for c in caps)):
        for B in (1, 33, 128, 256):
            for nL in (1, 2, 4, 8):
                for n_re in (636, 1025, 1638, 3300):
                    lp = k1.launch_plan(B, n_re, nL, 7, 144, n_re, cap, n_taps=15)
                    assert k1.kernel_plan(B, n_re, nL, 7, 144, n_re, cap, n_taps=15) == lp
                    n_cases += 1
    assert n_cases == 2 * 4 * 4 * 4


@NEEDS_GPU
@pytest.mark.parametrize("config,route", [("ce_n78_40mhz_4port_32ant.json", "banded"),
                                          (WIDE_CELL, "banded")])
def test_served_call_counts_k1_by_smoothing_route(config, route):
    """A served call of 128 problems of each CE deployment: over replays of
    its graph K1's launches (`launches.front` in a traced benchmark line) move
    by the replays, K1 on its one route, the banded one, at 106 PRB and at
    273, `front_finish` once a replay, and the results keep the
    configuration's limits of the float64 reference."""
    from cebench import spec
    from cebench.gen import slots
    from cebench.reference import ce

    n_rx = spec.read_json("configs", config)["n_rx"]
    seed = 2**31 + 25_002
    problems, key = _cell_problems(128 // n_rx, seed, config)
    assert est.served_kernels(*key, "factored", "cuda") == "pallas_front"
    graphs.clear()
    serving.process(problems, out="factored")  # eager: the key's first call
    serving.process(problems, out="factored")  # captured and replayed
    r0, n0, f0 = graphs.replays, k1.launches, kf.launches
    for _ in range(3):
        res = serving.process(problems, out="factored")
    n = graphs.replays - r0
    assert n == 3 and route == "banded"
    assert k1.launches - n0 == n
    assert kf.launches - f0 == n
    cfg = spec.read_json("configs", config)
    slot = slots.ce_slot(cfg, seed, 0)
    nums = ce.judge_slot(slot, res[:n_rx], ce.reference(slot))
    for k, limit in cfg["limits"].items():
        assert nums[k] <= limit, (k, nums[k], limit)


@NEEDS_GPU
def test_front_instantiations_compile_without_spills_and_the_banded_ones_as_before():
    """ptxas on csrc/front.cu: no spill in any instantiation, no dense one
    left (`front_kernel<RN>`), and each banded one (`front_kernel_banded<RN>`)
    at the registers it had beside the dense route."""
    import re

    from srsran_ce_tpu_torch.ops.kernels import _build

    _build.build_all(("front",), force=True)
    log = _build.build_logs["front"]
    assert not [ln for ln in log.splitlines()
                if any(int(b) for b in re.findall(r"(\d+) bytes spill", ln))]
    regs, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
        elif name and "Used" in ln and "registers" in ln:
            regs[name] = int(re.search(r"Used (\d+) registers", ln).group(1))
            name = None
    dense = [n for n in regs if re.search(r"front_kernelILi\dEE", n)]
    banded = {int(re.search(r"front_kernel_bandedILi(\d)EE", n).group(1)): r
              for n, r in regs.items() if re.search(r"front_kernel_bandedILi\dEE", n)}
    assert not dense and len(banded) == 4, sorted(regs)
    assert banded == BANDED_FRONT_REGISTERS, banded

