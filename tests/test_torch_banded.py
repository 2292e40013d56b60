"""K1's banded smoothing route, the tier rule that admits it, and the plain
PyTorch reference of the wide CE cell, on the CPU.

K1 smooths every band with the raised-cosine taps over the extended band
(`front.banded_smooth`); up to 1,024 pilot REs the plan also builds the fused
smoothing operator that holds the same filter (`smooth_mat`, as the JAX plan;
the "xla" tier applies it), past that none. Held here:
  - the plain K1 against the same front smoothed by the plan's dense operator
    at every kind of plan the operator exists for (n_re <= 1024: one and two
    PRBs, an odd band, a PRB hole, 8 layers, two hops), float64 within 1e-12
    relative, the TA bins equal;
  - the pallas_front tier on the banded route (K1's and `front_finish`'s
    plain versions) against the JAX package's "xla" estimator at 180 PRB
    (n_re 1080), float64, within the ref-layout bound of 1e-12 NMSE;
  - `cebench/reference/ce_torch.py` against the frozen numpy oracle;
  - the tier rule: K1 for the 64-antenna cell's plan ("factored" only), the
    receiver still on its plain tier, the port's plan still the JAX plan at
    273 PRB.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cebench import spec
from cebench.gen import slots
from cebench.reference import ce_torch, numbers, oracle as cb_oracle
from srsran_ce_tpu.models import estimator as jest
from srsran_ce_tpu.models import plan as jplan
from srsran_ce_tpu.utils import synthetic as jsyn
from srsran_ce_tpu_torch import config as pconfig
from srsran_ce_tpu_torch import serving
from srsran_ce_tpu_torch.models import estimator as est
from srsran_ce_tpu_torch.models import plan as tplan
from srsran_ce_tpu_torch.models import receiver
from srsran_ce_tpu_torch.ops.kernels import front as k1
from srsran_ce_tpu_torch.utils import synthetic

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_plan import assert_same  # noqa: E402

CUDA = torch.device("cuda")
WIDE_CELL = "ce_n78_100mhz_4port_64ant.json"


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def dense_smooth(hp):
    """K1's smoothing step as the plan's dense operator, in `banded_smooth`'s
    place: (h, vb, vef, taps) -> h @ smooth + vb @ smooth_vb + vef @
    flip(smooth_ve). h comes pair-averaged; the operator folds the same
    average in, and averaging twice changes nothing."""
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    sm, svb, sve = t(hp.smooth_mat), t(hp.smooth_vb_mat), t(hp.smooth_ve_mat[::-1])
    return lambda h, vb, vef, taps: h @ sm + vb @ svb + vef @ sve


DENSE_CASES = [
    ("nL4_2cdm", dict(n_prbs=26, n_layers=4)),
    ("nL1", dict(n_prbs=24, n_layers=1)),
    ("nL3_odd", dict(n_prbs=16, n_layers=3)),
    ("nL2_two_hops", dict(n_prbs=12, n_layers=2, two_hops=True)),
    ("nL1_cfo_off", dict(n_prbs=20, n_layers=1, cfo_compensate=False)),
    ("nL4_106prb", dict(n_prbs=106, n_layers=4)),
    ("one_prb", dict(n_prbs=1, n_layers=2)),
    ("one_prb_comb4_odd_band", dict(n_prbs=1, n_layers=4, comb=4)),
    ("two_prbs", dict(n_prbs=2, n_layers=4)),
    ("prb_hole", dict(n_prbs=20, n_layers=3, prb_start=6, n_prb_total=30, prb_hole=(5, 8))),
    ("nL8_comb4", dict(n_prbs=16, n_layers=8, comb=4)),
]


@pytest.mark.parametrize("name,kw", DENSE_CASES, ids=[c[0] for c in DENSE_CASES])
def test_banded_route_matches_the_dense_route(name, kw, monkeypatch):
    """The plain K1 on staged inputs against the same front smoothed by the
    plan's dense operator, float64; the operator's edge columns (pair_l,
    pair_r) are the pair-averaged band's first and last n_pils."""
    case = synthetic.make_case(seed=7, **dict(dict(comb=2, snr_db=25.0), **kw))
    nL = case.pilots.shape[2]
    plan = tplan.make_plan(case.hop1, case.hop2, case.config, nL)
    pt = tplan.plan_tensors(plan, "cpu", torch.float64)
    rng = np.random.default_rng(3)
    rg = est.split_ri(case.received_rg)
    rg = torch.as_tensor(rg + 1e-3 * rng.standard_normal((3,) + rg.shape))
    pil = torch.as_tensor(est.split_ri(case.pilots))[None].expand(3, -1, -1, -1, -1)
    beta = torch.as_tensor(case.beta * (1.0 + 0.1 * np.arange(3)))
    d0 = 0
    for hp, ht in zip((plan.hop1, plan.hop2), pt["hops"]):
        assert hp.smooth_mat is not None and est._front_banded(hp) and "taps" in ht["front"]
        h = rng.standard_normal((2 * nL, hp.n_re))
        avg = h.copy()
        if nL >= 2:
            m = hp.n_re // 2
            avg[:, 0:2 * m:2] = avg[:, 1:2 * m:2] = (h[:, 0:2 * m:2] + h[:, 1:2 * m:2]) * 0.5
        assert rel(h @ hp.pair_l_mat, avg[:, :hp.n_pils]) <= 1e-15
        assert rel(h @ hp.pair_r_mat, avg[:, hp.n_re - hp.n_pils:]) <= 1e-15
        kw_ = dict(n_samples=hp.n_samples, half_cp_len=hp.half_cp_len, fft_size=hp.fft_size,
                   scs_hz=case.config.scs_hz, cfo_possible=hp.cfo_possible,
                   cfo_compensate=case.config.cfo_compensate, re_idx=ht["re_idx"],
                   dmrs_sym_idx=ht["dmrs_sym_idx"])
        pil_h = pil[:, :, :, d0:d0 + hp.n_dsym]
        d0 += hp.n_dsym
        h_b, s_b = k1.fused_front(rg, pil_h, beta, ht["front"], **kw_)
        with monkeypatch.context() as mp:
            mp.setattr(k1, "banded_smooth", dense_smooth(hp))
            h_d, s_d = k1.fused_front(rg, pil_h, beta, ht["front"], **kw_)
        assert rel(h_b, h_d) <= 1e-12, (name, rel(h_b, h_d))
        np.testing.assert_array_equal(s_b[:, 1].numpy(), s_d[:, 1].numpy())  # TA bins
        np.testing.assert_allclose(s_b.numpy(), s_d.numpy(), rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("n_layers", [1, 2, 4])
def test_banded_tier_matches_jax_xla_estimator_at_180_prb(n_layers):
    """pallas_front, factored, on a plan with no dense operator (n_re 1080)
    against the JAX package's xla estimator in the reference layout."""
    kw = dict(n_prbs=180, n_layers=n_layers, comb=2, snr_db=20.0, cfo_hz=200.0)
    case, jc = synthetic.make_case(seed=43, **kw), jsyn.make_case(seed=43, **kw)
    plan = tplan.make_plan(case.hop1, case.hop2, case.config, n_layers)
    assert plan.hop1.n_re == 1080 and plan.hop1.smooth_mat is None
    assert est._front_pallas_ok(plan) and est._front_banded(plan.hop1)
    rng = np.random.default_rng(5)
    rg = est.split_ri(case.received_rg)
    rg_b = rg + 1e-3 * rng.standard_normal((2,) + rg.shape)
    pil_b = np.ascontiguousarray(np.broadcast_to(est.split_ri(case.pilots),
                                                 (2, 2) + case.pilots.shape))
    beta = case.beta * (1.0 + 0.1 * np.arange(2))
    mine = est.build_ri(case.hop1, case.hop2, case.config, n_layers, batched=True,
                        kernels="pallas_front", out_layout="factored")(
        torch.as_tensor(rg_b), torch.as_tensor(pil_b), torch.as_tensor(beta))
    ref = jest.build_ri(jc.hop1, jc.hop2, jc.config, n_layers, batched=True, kernels="xla",
                        out_layout="ref")(rg_b, pil_b, beta)
    ref_grid = np.asarray(ref.channel_est_rg)  # (B, 2, n_sc, n_sym, nL)
    for b in range(2):
        grid = est.reconstruct_factored(est.merge_ri(mine.profiles[b].numpy()),
                                        est.merge_ri(mine.sym_rot[b].numpy()), case.hop1, case.hop2)
        assert numbers.nmse(grid, est.merge_ri(ref_grid[b])) <= 1e-12
    for f in ("noise_est", "rsrp", "epre", "time_alignment", "cfo_hz"):
        np.testing.assert_allclose(getattr(mine, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=1e-10, atol=1e-300, err_msg=f)


@pytest.mark.parametrize("n_layers", [4, 1])
def test_torch_reference_matches_the_oracle(n_layers):
    """`cebench/reference/ce_torch.py` in float64 against the frozen numpy
    oracle: the wide cell's configuration at 180 PRB, 2 antennas."""
    cfg = dict(spec.read_json("configs", WIDE_CELL), n_prbs=180, n_rx=2, n_layers=n_layers)
    s = slots.ce_slot(cfg, 2**31 + 25_025, 0)
    for r in range(2):
        mine = ce_torch.estimate(s.rg[r], s.pilots, s.beta, s.hop1, s.hop2, s.config)
        o = cb_oracle.estimate(s.rg[r], s.pilots, s.beta, s.hop1, s.hop2, s.config)
        assert numbers.nmse(mine.channel_est_rg, o.channel_est_rg) <= 1e-24
        assert numbers.scalar_err(numbers.scalars_of(mine), numbers.scalars_of(o)) <= 1e-12


def test_torch_reference_imports_neither_jax_nor_the_program():
    import ast

    src = Path(ce_torch.__file__).read_text()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert names.isdisjoint({"jax", "jaxlib", "flax", "srsran_ce_tpu", "srsran_ce_tpu_torch"})


def wide_cell_key(**changes):
    """(hop1, hop2, config, n_layers) of the 64-antenna cell's plan at the
    served precision, as `cebench`'s chain makes it."""
    cfg = spec.read_json("configs", WIDE_CELL)
    s = slots.ce_slot(dict(cfg, n_rx=1), 2**31 + 25_026, 0)
    hop1 = pconfig.HopConfig(**dataclasses.asdict(s.hop1))
    conf = pconfig.EstimatorConfig(**dataclasses.asdict(s.config))
    conf = dataclasses.replace(conf, matmul_precision=cfg["matmul_precision"], **changes)
    return hop1, None, conf, int(cfg["n_layers"])


WIDE_TIER_CASES = [
    ("factored_on_cuda", {}, "factored", CUDA, "pallas_front"),
    ("grid_on_cuda", {}, "serve", CUDA, "xla"),
    ("factored_on_cpu", {}, "factored", torch.device("cpu"), "xla"),
    ("cfo_compensation_off", dict(cfo_compensate=False), "factored", CUDA, "pallas_front"),
    ("wiener", dict(smoothing="wiener"), "factored", CUDA, "xla"),
    ("cnn_alpha", dict(interp="cnn", cnn_alpha=0.5), "factored", CUDA, "xla"),
]


@pytest.mark.parametrize("name,changes,layout,device,tier", WIDE_TIER_CASES,
                         ids=[c[0] for c in WIDE_TIER_CASES])
def test_wide_cell_takes_the_banded_route(name, changes, layout, device, tier):
    key = wide_cell_key(**changes)
    plan = tplan.make_plan(*key)
    assert plan.hop1.n_re == 1638 and plan.hop1.smooth_mat is None
    est._front_serves.cache_clear()
    assert est.served_kernels(*key, layout, device) == tier
    if tier == "pallas_front":
        assert est._front_pallas_ok(plan) and est._front_serves(key, layout)
        fn = est.build_ri(*key, batched=True, kernels=tier, out_layout=layout)
        front = fn.plan_tensors("cpu", torch.float32)["hops"][0]["front"]
        assert set(front) == {"taps", "vp", "ta_c", "ta_s", "two_pi_sst_d"}
        assert tuple(front["taps"].shape) == (15,) and tuple(front["vp"].shape) == (7, 7)
    est._front_serves.cache_clear()


def test_banded_launch_plan_at_the_cells_shape():
    """128 problems of 1,638 REs, 4 layers: every cluster resident at once on
    an H100 (2 problems x 2 blocks, 128 blocks, one an SM); even tap counts
    raise."""
    caps = (132, 66, 39, 30, 22, 17, 15, 15)
    lp = k1.launch_plan(128, 1638, 4, 7, 144, 1638, caps, n_taps=15)
    assert (lp.P, lp.S, lp.blocks) == (2, 2, 128), lp
    assert k1.SMEM_HALF < lp.smem <= k1.SMEM_LIMIT and lp.S * lp.NS >= 1638
    assert lp.RN <= 4 and lp.S * lp.TS >= 288
    with pytest.raises(ValueError):
        k1.launch_plan(128, 1638, 4, 7, 144, 1638, caps, n_taps=14)
    for n_re in (1025, 1638, 3300):  # every band up to 275 PRB has a banded plan
        for nL in (1, 2, 4, 8):
            k1.launch_plan(128, n_re, nL, 7, 144, n_re, caps, n_taps=15)


def test_receiver_keeps_its_plain_tier_at_the_wide_band(monkeypatch):
    """K1's banded route now covers a 273-PRB one-layer plan, the PUSCH
    receiver's; the receiver takes no tier rule: `serving.process` builds it
    on "xla" (it would launch no K1 on the card either), and its plan's
    tensors hold none of K1's or its finish's (no `front`, no two-tap
    tables)."""
    cfg = spec.read_json("configs", "pusch_n78_100mhz_4rx.json")
    s = slots.ce_slot(dict(cfg, n_rx=1, modulation="qpsk"), 2**31 + 25_027, 0)
    plan = tplan.make_plan(pconfig.HopConfig(**dataclasses.asdict(s.hop1)), None,
                           pconfig.EstimatorConfig(**dataclasses.asdict(s.config)), 1)
    assert plan.hop1.n_re == 1638 and est._front_pallas_ok(plan)
    built = []
    real = receiver.build_receiver_ri

    def spy(*args, **kw):
        fn = real(*args, **kw)
        built.append(fn)
        return fn

    monkeypatch.setattr(receiver, "build_receiver_ri", spy)
    link = synthetic.make_mimo_case(seed=11, n_rx=2, n_prbs=273, n_layers=1, modulation="qpsk",
                                    snr_db=25.0)
    prob = serving.Problem(link.received_rg.astype(np.complex64), link.pilots.astype(np.complex64),
                           float(link.beta), link.hop1, link.hop2, link.config)
    res = serving.process([prob], out="equalized", device="cpu")
    assert len(res) == 1 and [fn.kernels for fn in built] == ["xla"]
    hops = built[0].plan_tensors("cpu", torch.float32)["hops"]
    assert built[0].plan.hop1.n_re == 1638
    assert all(h["front"] is None and h["taps"] is None for h in hops)


@pytest.mark.parametrize("n_layers", [1, 4])
def test_port_plan_equals_the_jax_plan_at_273_prb(n_layers):
    """The port's plan stays the JAX plan where K1 takes the banded route:
    no dense operator past 1,024 REs on either side."""
    kw = dict(n_prbs=273, n_layers=n_layers, comb=2, snr_db=30.0)
    a, b = synthetic.make_case(seed=1, **kw), jsyn.make_case(seed=1, **kw)
    pa = tplan.make_plan(a.hop1, a.hop2, a.config, n_layers)
    pb = jplan.make_plan(b.hop1, b.hop2, b.config, n_layers)
    assert pa.hop1.smooth_mat is None and pb.hop1.smooth_mat is None
    assert_same(pa, pb)
