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
"""
import numpy as np
import pytest
import torch

from srsran_ce_tpu_torch.models import estimator as est
from srsran_ce_tpu_torch.models.plan import make_plan, plan_tensors
from srsran_ce_tpu_torch.ops.kernels import fill_rotate as k6
from srsran_ce_tpu_torch.ops.kernels import fill_rotate_serve as k2
from srsran_ce_tpu_torch.ops.kernels import front as k1
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
@pytest.mark.parametrize("batch,n_re,n_sc,n_sym", [(13, 52, 200, 14), (128, 636, 1272, 7)])
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
@pytest.mark.parametrize("batch,C,n_ext,K", [(128, 8, 650, 15), (128, 32, 650, 15), (3, 2, 20, 5), (1, 1, 1, 1)])
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
