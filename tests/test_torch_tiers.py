"""The port's per-problem estimator tiers against the JAX package and the oracle.

`srsran_ce_tpu_torch.models.estimator.build_ri(kernels="xla" | "pallas",
out_layout="ref" | "serve" | "factored", out_dtype=None | "bfloat16")`, plus
`build`, `build_batched` and `estimate`, on numpy-made inputs that feed both
packages (the JAX Pallas kernels in interpret mode). On the CPU the port runs
its kernels' plain versions.

Tolerances: float64 — relative 1e-10 (max-abs error over max-abs value) on
grids and scalars against the JAX tiers, channel NMSE < 1e-18 against the
float64 oracle (tests/test_estimator_vs_oracle.py's bound, tol 1e-9 squared)
with its scalar bounds; bfloat16 grids — relative 4e-3 (the documented ~4e-3
of bf16 output, `build_ri`'s docstring) against the JAX package's bf16 grid,
from float32 inputs.
"""
import dataclasses
import sys
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_ce_tpu.models import estimator as jest
from srsran_ce_tpu.ops.pallas import mathx as jmathx
from srsran_ce_tpu.utils import synthetic as jsyn
from srsran_ce_tpu_torch.models import estimator as est
from srsran_ce_tpu_torch.models.plan import make_plan, plan_tensors
from srsran_ce_tpu_torch.utils import oracle, synthetic

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_estimator_vs_oracle import CASES as ORACLE_CASES  # noqa: E402

SCALARS = ("noise_est", "rsrp", "epre", "time_alignment", "cfo_hz")
# a representative subset for the port-vs-JAX comparisons: CDM pairs, two hops,
# an odd layer count with time interpolation and the WLS CFO, cnn inpainting
# through its operator (30 iterations) with the alpha blend and through the
# partial-conv chain itself (12 iterations, <= 16), wiener with time interpolation
JAX_CASES = [
    ("nL4_2cdm", dict(n_prbs=26, n_layers=4, comb=2, snr_db=30.0)),
    ("nL2_two_hops", dict(n_prbs=12, n_layers=2, comb=2, snr_db=30.0, two_hops=True)),
    ("nL3_time_interp_wls", dict(n_prbs=16, n_layers=3, snr_db=25.0, time_interp="linear",
                                 cfo_estimator="wls", doppler_hz=300.0)),
    ("cnn_alpha_deep", dict(n_prbs=20, n_layers=2, interp="cnn", cnn_alpha=0.3, prb_start=4,
                            n_prb_total=30)),
    ("wiener_time_interp", dict(n_prbs=12, n_layers=1, smoothing="wiener",
                                time_interp="linear", two_hops=True)),
    ("cnn_short_chain", dict(n_prbs=8, n_layers=1, interp="cnn")),
]


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def inputs(kw, dtype=np.float64, batch=2, seed=41):
    """A case of both packages (bit-identical) and a batch of perturbed
    problems of it in ri layout."""
    case, jc = synthetic.make_case(seed=seed, **kw), jsyn.make_case(seed=seed, **kw)
    rng = np.random.default_rng(2)
    rg = est.split_ri(case.received_rg)
    rg_b = (rg + 1e-3 * rng.standard_normal((batch,) + rg.shape)).astype(dtype)
    pil_b = np.broadcast_to(est.split_ri(case.pilots), (batch, 2) + case.pilots.shape).astype(dtype)
    beta = (case.beta * (1.0 + 0.1 * np.arange(batch))).astype(dtype)
    return case, jc, rg_b, pil_b, beta


def port_and_jax(case, jc, rg, pil, beta, **kw):
    nL = case.pilots.shape[2]
    mine = est.build_ri(case.hop1, case.hop2, case.config, nL, batched=True, **kw)(
        torch.as_tensor(rg), torch.as_tensor(pil), torch.as_tensor(beta)
    )
    ref = jest.build_ri(jc.hop1, jc.hop2, jc.config, nL, batched=True, **kw)(rg, pil, beta)
    return mine, ref


@pytest.mark.parametrize("layout", ["ref", "serve"])
@pytest.mark.parametrize("kernels", ["xla", "pallas"])
@pytest.mark.parametrize("name,kw", JAX_CASES, ids=[c[0] for c in JAX_CASES])
def test_tiers_match_jax_f64(name, kw, kernels, layout):
    case, jc, rg, pil, beta = inputs(kw)
    mine, ref = port_and_jax(case, jc, rg, pil, beta, kernels=kernels, out_layout=layout)
    assert tuple(mine.channel_est_rg.shape) == np.asarray(ref.channel_est_rg).shape
    assert rel(mine.channel_est_rg, ref.channel_est_rg) <= 1e-10
    for f in SCALARS:
        np.testing.assert_allclose(np.asarray(getattr(mine, f)), np.asarray(getattr(ref, f)),
                                   rtol=1e-10, atol=1e-300, err_msg=f)


@pytest.mark.parametrize("name,kw", JAX_CASES[:2] + JAX_CASES[3:4], ids=["nL4", "hops", "cnn"])
def test_xla_factored_matches_jax_f64(name, kw):
    case, jc, rg, pil, beta = inputs(kw)
    mine, ref = port_and_jax(case, jc, rg, pil, beta, out_layout="factored")
    assert rel(mine.profiles, ref.profiles) <= 1e-10
    assert rel(mine.sym_rot, ref.sym_rot) <= 1e-10


@pytest.mark.parametrize("kernels", ["xla", "pallas"])
@pytest.mark.parametrize("name,kw", JAX_CASES[:1] + JAX_CASES[2:4], ids=["nL4", "ti", "cnn"])
def test_bf16_serve_matches_jax(name, kw, kernels):
    case, jc, rg, pil, beta = inputs(kw, np.float32)
    mine, ref = port_and_jax(case, jc, rg, pil, beta, kernels=kernels, out_layout="serve",
                             out_dtype="bfloat16")
    assert mine.channel_est_rg.dtype == torch.bfloat16
    assert rel(mine.channel_est_rg.float().numpy(), np.asarray(ref.channel_est_rg, np.float32)) <= 4e-3
    for f in ("noise_est", "rsrp", "epre"):  # full precision, float32
        np.testing.assert_allclose(np.asarray(getattr(mine, f)), np.asarray(getattr(ref, f)),
                                   rtol=1e-4, err_msg=f)


@pytest.fixture
def exact_jax_atan2(monkeypatch):
    """The JAX fused front with exact atan2 (see tests/test_torch_kernels.py);
    its jit cache is cleared on both sides."""
    jest._build_ri_cached.cache_clear()
    monkeypatch.setattr(jmathx, "atan2", jnp.arctan2)
    yield
    jest._build_ri_cached.cache_clear()


@pytest.mark.parametrize("layout", ["serve", "factored"])
def test_pallas_front_cnn_matches_jax_f64(layout, exact_jax_atan2):
    """interp="cnn" through the fused front: the fill takes the inpainting
    operator (the JAX gates accept cnn when the plan has inpaint schedules)."""
    kw = dict(n_prbs=24, n_layers=2, comb=2, snr_db=30.0, interp="cnn")
    case, jc, rg, pil, beta = inputs(kw)
    mine, ref = port_and_jax(case, jc, rg, pil, beta, kernels="pallas_front", out_layout=layout)
    key = "channel_est_rg" if layout == "serve" else "profiles"
    assert rel(getattr(mine, key), getattr(ref, key)) <= 1e-10
    for f in SCALARS:
        np.testing.assert_allclose(np.asarray(getattr(mine, f)), np.asarray(getattr(ref, f)),
                                   rtol=1e-10, atol=1e-300, err_msg=f)


def test_pallas_front_bf16_matches_jax():
    case, jc, rg, pil, beta = inputs(JAX_CASES[0][1], np.float32, batch=3)
    mine, ref = port_and_jax(case, jc, rg, pil, beta, kernels="pallas_front", out_layout="serve",
                             out_dtype="bfloat16")
    assert mine.channel_est_rg.dtype == torch.bfloat16
    assert rel(mine.channel_est_rg.float().numpy(), np.asarray(ref.channel_est_rg, np.float32)) <= 4e-3


def assert_oracle(res, o, nmse_bound=1e-18):
    ch = res.channel_est_rg
    nmse = np.sum(np.abs(ch - o.channel_est_rg) ** 2) / (np.sum(np.abs(o.channel_est_rg) ** 2) + 1e-30)
    assert nmse < nmse_bound, nmse
    np.testing.assert_allclose(float(res.noise_est), o.noise_est, rtol=1e-8, atol=1e-20)
    np.testing.assert_allclose(float(res.rsrp), o.rsrp, rtol=1e-9)
    np.testing.assert_allclose(float(res.epre), o.epre, rtol=1e-9)
    np.testing.assert_allclose(float(res.time_alignment), o.time_alignment, rtol=1e-9, atol=1e-15)
    if o.cfo_hz is None:
        assert np.isnan(float(res.cfo_hz))
    else:
        np.testing.assert_allclose(float(res.cfo_hz), o.cfo_hz, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("name,kw", ORACLE_CASES, ids=[c[0] for c in ORACLE_CASES])
def test_oracle_geometries(name, kw):
    """All geometries of tests/test_estimator_vs_oracle.py (same seeds) through
    `estimate` (the "xla" tier) and `build_ri(kernels="pallas")`, reference
    layout, against the float64 oracle."""
    case = synthetic.make_case(seed=zlib.crc32(name.encode()), snr_db=30.0, **kw)
    o = oracle.estimate(case.received_rg, case.pilots, case.beta, case.hop1, case.hop2, case.config)
    assert_oracle(est.estimate(case.received_rg, case.pilots, case.beta, case.hop1, case.hop2,
                               case.config, device="cpu"), o)
    fn = est.build_ri(case.hop1, case.hop2, case.config, case.pilots.shape[2], kernels="pallas")
    res = fn(torch.as_tensor(est.split_ri(case.received_rg)),
             torch.as_tensor(est.split_ri(case.pilots)), case.beta)
    assert_oracle(est._to_numpy(res), o)


def test_build_batched_and_estimate_match_jax():
    kw = dict(n_prbs=24, n_layers=2, snr_db=30.0)
    cases = [synthetic.make_case(seed=100 + i, **kw) for i in range(3)]
    c0 = cases[0]
    rg = np.stack([c.received_rg for c in cases])
    pil = np.stack([c.pilots for c in cases])
    beta = np.array([c.beta for c in cases])
    out = est.build_batched(c0.hop1, c0.hop2, c0.config, 2, device="cpu")(rg, pil, beta)
    ref = jest.build_batched(c0.hop1, c0.hop2, c0.config, n_layers=2)(rg, pil, beta)
    assert out.channel_est_rg.shape == (3, 288, 14, 2) and out.channel_est_rg.dtype == np.complex128
    want = np.asarray(ref.channel_est_rg)
    assert np.abs(out.channel_est_rg - want).max() / np.abs(want).max() <= 1e-10
    for f in SCALARS:
        np.testing.assert_allclose(getattr(out, f), np.asarray(getattr(ref, f)), rtol=1e-10)
    one = est.estimate(rg[1], pil[1], beta[1], c0.hop1, c0.hop2, c0.config, device="cpu")
    assert np.abs(one.channel_est_rg - out.channel_est_rg[1]).max() <= 1e-14
    # complex64 inputs run in float32
    r32 = est.estimate(rg[1].astype(np.complex64), pil[1].astype(np.complex64), np.float32(beta[1]),
                       c0.hop1, c0.hop2, c0.config, device="cpu")
    assert r32.channel_est_rg.dtype == np.complex64
    assert np.abs(r32.channel_est_rg - one.channel_est_rg).max() <= 1e-5


def test_ta_fft_route_matches_dft_route():
    """`_process_hop`'s FFT route (plans without the direct-DFT matrices) gives
    the DFT route's estimate, per problem."""
    case, _, rg, pil, beta = inputs(dict(n_prbs=16, n_layers=2, two_hops=True), batch=3)
    plan = make_plan(case.hop1, case.hop2, case.config, 2)
    no_dft = dataclasses.replace(
        plan,
        hop1=dataclasses.replace(plan.hop1, ta_dft_cos=None, ta_dft_sin=None),
        hop2=dataclasses.replace(plan.hop2, ta_dft_cos=None, ta_dft_sin=None),
    )
    args = [torch.as_tensor(a) for a in (rg, pil, beta)]
    c = lambda x: torch.complex(x[:, 0], x[:, 1])
    runs = [est._estimate_impl(p, plan_tensors(p, "cpu", torch.float64), c(args[0]), c(args[1]),
                               args[2]) for p in (plan, no_dft)]
    assert rel(runs[1].channel_est_rg, runs[0].channel_est_rg) <= 1e-12
    for f in SCALARS:
        np.testing.assert_allclose(getattr(runs[1], f), getattr(runs[0], f), rtol=1e-12)


def test_unported_options_raise():
    """What stays refused: tracking with learned smoothing and with time
    interpolation (the JAX builders' refusals), and the layout options."""
    from srsran_ce_tpu_torch.models import tracking

    case = synthetic.make_case(seed=8, n_prbs=16, n_layers=1, smoothing="learned")
    with pytest.raises(ValueError, match="learned"):
        tracking.build_tracked_ri(case.hop1, case.hop2, case.config, 1, device="cpu")
    case = synthetic.make_case(seed=8, n_prbs=16, n_layers=1, time_interp="linear")
    with pytest.raises(ValueError, match="time_interp"):
        tracking.build_tracked_ri(case.hop1, case.hop2, case.config, 1, device="cpu")
    plan = make_plan(case.hop1, case.hop2, case.config, 1)
    rg = torch.complex(*torch.as_tensor(est.split_ri(case.received_rg[None])).unbind(0))
    pil = torch.complex(*torch.as_tensor(est.split_ri(case.pilots[None])).unbind(0))
    h0 = (torch.zeros((1, 1, plan.hop1.n_re), dtype=torch.complex128),)
    with pytest.raises(ValueError, match="time_interp"):
        est._estimate_impl(plan, plan_tensors(plan, "cpu", torch.float64), rg, pil,
                           torch.ones(1, dtype=torch.float64), h_prev=h0,
                           track_w=torch.zeros(1, dtype=torch.float64))
    case = synthetic.make_case(seed=8, n_prbs=16, n_layers=1)
    with pytest.raises(ValueError, match="serve"):
        est.build_ri(case.hop1, case.hop2, case.config, 1, out_dtype="bfloat16")
    with pytest.raises(ValueError, match="pallas_front"):
        est.build_ri(case.hop1, case.hop2, case.config, 1, kernels="pallas_front")
