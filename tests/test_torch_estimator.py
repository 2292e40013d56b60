"""The port's batched estimator against the JAX package and the float64 oracle.

`srsran_ce_tpu_torch.models.estimator.build_ri(kernels="pallas_front")` in the
serve and factored layouts, batched and unbatched, against the JAX
`build_ri(kernels="pallas_front")` (interpret mode) and the JAX XLA tier, on
the same numpy-made inputs. On the CPU the port runs its kernels' plain
versions.

Tolerances: float64 — relative 1e-10 on the grids and scalars against both JAX
tiers (the JAX Pallas tier with `jnp.arctan2` in place of its float32-accurate
`mathx.atan2` polynomial, see tests/test_torch_kernels.py) and channel NMSE
< 1e-12 against the oracle; float32 — the unmodified JAX Pallas tier at the
bounds of tests/test_pallas_kernels.py:319-332.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_ce_tpu.models import estimator as jest
from srsran_ce_tpu.models import plan as jplan
from srsran_ce_tpu.ops.pallas import mathx as jmathx
from srsran_ce_tpu.utils import synthetic as jsyn
from srsran_ce_tpu_torch import entry
from srsran_ce_tpu_torch.models import estimator as est
from srsran_ce_tpu_torch.models.plan import plan_tensors
from srsran_ce_tpu_torch.utils import oracle, synthetic

REPO = Path(__file__).resolve().parents[1]
CASES = [
    ("nL4_2cdm", dict(n_prbs=26, n_layers=4, comb=2, snr_db=30.0)),
    ("nL2_two_hops", dict(n_prbs=12, n_layers=2, comb=2, snr_db=30.0, two_hops=True)),
    ("nL3_odd", dict(n_prbs=16, n_layers=3, comb=2, snr_db=30.0)),
    ("nL1_cfo_off_offset", dict(n_prbs=20, n_layers=1, comb=2, snr_db=25.0,
                                cfo_compensate=False, prb_start=6, n_prb_total=30)),
]
B = 2


@pytest.fixture
def exact_jax_atan2(monkeypatch):
    """The JAX Pallas tier with exact atan2; its jit cache is cleared on both
    sides so no program traced with the other atan2 is reused."""
    jest._build_ri_cached.cache_clear()
    monkeypatch.setattr(jmathx, "atan2", jnp.arctan2)
    yield
    jest._build_ri_cached.cache_clear()


def inputs(kw, dtype, batch=B):
    case = synthetic.make_case(seed=41, **kw)
    rng = np.random.default_rng(2)
    rg = est.split_ri(case.received_rg).astype(dtype)
    pil = est.split_ri(case.pilots).astype(dtype)
    rg_b = (np.broadcast_to(rg, (batch,) + rg.shape)
            + 1e-3 * rng.standard_normal((batch,) + rg.shape)).astype(dtype)
    pil_b = np.broadcast_to(pil, (batch,) + pil.shape).copy()
    beta = np.full(batch, case.beta, dtype)
    return case, rg_b, pil_b, beta


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


SCALARS = ("noise_est", "rsrp", "epre", "time_alignment", "cfo_hz")


def grid(res, layout):
    return np.asarray(res.channel_est_rg if layout == "serve" else res.profiles)


@pytest.mark.parametrize("layout", ["serve", "factored"])
@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_port_matches_jax_tiers_f64(name, kw, layout, exact_jax_atan2):
    case, rg, pil, beta = inputs(kw, np.float64)
    jc = jsyn.make_case(seed=41, **kw)
    nL = case.pilots.shape[2]
    port = est.build_ri(case.hop1, case.hop2, case.config, nL, batched=True,
                        out_layout=layout, kernels="pallas_front")
    out = port(torch.as_tensor(rg), torch.as_tensor(pil), torch.as_tensor(beta))
    for kernels in ("pallas_front", "xla"):
        ref = jest.build_ri(jc.hop1, jc.hop2, jc.config, nL, batched=True,
                            out_layout=layout, kernels=kernels)(rg, pil, beta)
        assert rel(grid(out, layout), grid(ref, layout)) <= 1e-10, kernels
        if layout == "factored":
            assert rel(out.sym_rot, ref.sym_rot) <= 1e-10, kernels
        for f in SCALARS:
            np.testing.assert_allclose(
                np.asarray(getattr(out, f)), np.asarray(getattr(ref, f)), rtol=1e-10,
                atol=1e-300, err_msg=f"{kernels} {f}",
            )


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_port_matches_oracle_f64(name, kw):
    """Serve grid of each problem vs the float64 oracle: NMSE < 1e-12."""
    case = synthetic.make_case(seed=41, **kw)
    nL = case.pilots.shape[2]
    fn = est.build_ri(case.hop1, case.hop2, case.config, nL, out_layout="serve",
                      kernels="pallas_front")  # unbatched
    res = fn(torch.as_tensor(est.split_ri(case.received_rg)),
             torch.as_tensor(est.split_ri(case.pilots)), case.beta)
    o = oracle.estimate(case.received_rg, case.pilots, case.beta, case.hop1, case.hop2, case.config)
    ch = est.merge_ri(res.channel_est_rg.numpy()).transpose(2, 1, 0)  # (n_sc, n_sym, nL)
    nmse = np.sum(np.abs(ch - o.channel_est_rg) ** 2) / np.sum(np.abs(o.channel_est_rg) ** 2)
    assert nmse < 1e-12, nmse
    np.testing.assert_allclose(float(res.noise_est), o.noise_est, rtol=1e-8)
    np.testing.assert_allclose(float(res.rsrp), o.rsrp, rtol=1e-9)
    np.testing.assert_allclose(float(res.epre), o.epre, rtol=1e-9)
    np.testing.assert_allclose(float(res.time_alignment), o.time_alignment, rtol=1e-9, atol=1e-15)
    np.testing.assert_allclose(float(res.cfo_hz), o.cfo_hz, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("layout", ["serve", "factored"])
def test_port_matches_jax_pallas_front_f32(layout):
    kw = CASES[0][1]
    case, rg, pil, beta = inputs(kw, np.float32, batch=4)
    jc = jsyn.make_case(seed=41, **kw)
    port = est.build_ri(case.hop1, case.hop2, case.config, 4, batched=True,
                        out_layout=layout, kernels="pallas_front")
    out = port(torch.as_tensor(rg), torch.as_tensor(pil), torch.as_tensor(beta))
    ref = jest.build_ri(jc.hop1, jc.hop2, jc.config, 4, batched=True,
                        out_layout=layout, kernels="pallas_front")(rg, pil, beta)
    a, b = grid(out, layout).astype(np.float64), grid(ref, layout).astype(np.float64)
    assert np.sum((a - b) ** 2) / np.sum(b**2) < 1e-9
    g = lambda r, f: np.asarray(getattr(r, f), np.float64)
    np.testing.assert_allclose(g(out, "noise_est"), g(ref, "noise_est"), rtol=1e-4)
    np.testing.assert_allclose(g(out, "rsrp"), g(ref, "rsrp"), rtol=1e-5)
    np.testing.assert_allclose(g(out, "epre"), g(ref, "epre"), rtol=1e-6)
    np.testing.assert_allclose(g(out, "time_alignment"), g(ref, "time_alignment"),
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(g(out, "cfo_hz"), g(ref, "cfo_hz"), rtol=1e-4, atol=1e-3)


def test_unbatched_and_factored_reconstruct():
    kw = CASES[1][1]  # two hops: the placement into the zero grid
    case, rg, pil, beta = inputs(kw, np.float64)
    nL = case.pilots.shape[2]
    serve_b = est.build_ri(case.hop1, case.hop2, case.config, nL, batched=True,
                           out_layout="serve", kernels="pallas_front")
    serve_1 = est.build_ri(case.hop1, case.hop2, case.config, nL, out_layout="serve",
                           kernels="pallas_front")
    fac = est.build_ri(case.hop1, case.hop2, case.config, nL, batched=True,
                       out_layout="factored", kernels="pallas_front")
    rb = serve_b(rg, pil, beta)
    for b in range(B):
        r1 = serve_1(rg[b], pil[b], beta[b])
        # batched and single matmuls may block their sums differently: ulps only
        assert rel(r1.channel_est_rg, rb.channel_est_rg[b]) <= 1e-14
        assert r1.channel_est_rg.shape == rb.channel_est_rg.shape[1:]
        np.testing.assert_allclose(float(r1.noise_est), float(rb.noise_est[b]), rtol=1e-14)
    f = fac(rg, pil, beta)
    dense = est.reconstruct_factored(
        est.merge_ri(np.moveaxis(f.profiles.numpy(), 1, 0)),
        est.merge_ri(np.moveaxis(f.sym_rot.numpy(), 1, 0)), case.hop1, case.hop2,
    )  # (B, n_sc, n_sym, nL)
    serve = est.merge_ri(np.moveaxis(rb.channel_est_rg.numpy(), 1, 0)).transpose(0, 3, 2, 1)
    assert np.abs(dense - serve).max() / np.abs(serve).max() <= 1e-14


def test_plan_tensors_of_jax_plan_give_same_result():
    kw = CASES[0][1]
    case, rg, pil, beta = inputs(kw, np.float64)
    jc = jsyn.make_case(seed=41, **kw)
    fn = est.build_ri(case.hop1, case.hop2, case.config, 4, batched=True,
                      out_layout="serve", kernels="pallas_front")
    args = (torch.as_tensor(rg), torch.as_tensor(pil), torch.as_tensor(beta))
    mine = fn(*args)
    jp = jplan.make_plan(jc.hop1, jc.hop2, jc.config, 4)
    theirs = est._front_pallas_batched(jp, plan_tensors(jp, "cpu", torch.float64), *args, "serve")
    assert torch.equal(mine.channel_est_rg, theirs.channel_est_rg)
    for f in SCALARS:
        assert torch.equal(getattr(mine, f), getattr(theirs, f)), f


def test_ineligible_and_unported_raise():
    case = synthetic.make_case(seed=8, n_prbs=16, n_layers=1, smoothing="wiener")
    with pytest.raises(ValueError, match="not eligible"):
        est.build_ri(case.hop1, case.hop2, case.config, 1, batched=True,
                     out_layout="serve", kernels="pallas_front")
    case = synthetic.make_case(seed=8, n_prbs=16, n_layers=1, time_interp="linear")
    with pytest.raises(ValueError, match="not eligible"):
        est.build_ri(case.hop1, case.hop2, case.config, 1, batched=True,
                     out_layout="serve", kernels="pallas_front")
    case = synthetic.make_case(seed=8, n_prbs=16, n_layers=1)
    with pytest.raises(ValueError, match="serve and factored"):
        est.build_ri(case.hop1, case.hop2, case.config, 1, batched=True, kernels="pallas_front")
    with pytest.raises(ValueError, match="serve layout"):
        est.build_ri(case.hop1, case.hop2, case.config, 1, kernels="pallas_front",
                     out_layout="factored", out_dtype="bfloat16")
    # learned smoothing is outside the fused front's coverage, as in JAX
    learned = synthetic.make_case(seed=8, n_prbs=16, n_layers=1, smoothing="learned")
    with pytest.raises(ValueError, match="not eligible"):
        est.build_ri(learned.hop1, learned.hop2, learned.config, 1, out_layout="serve",
                     kernels="pallas_front")
    # cnn interpolation and the bf16 grid are ported: the fused front takes them
    cnn = synthetic.make_case(seed=8, n_prbs=16, n_layers=1, interp="cnn")
    est.build_ri(cnn.hop1, cnn.hop2, cnn.config, 1, out_layout="serve", kernels="pallas_front",
                 out_dtype="bfloat16")


def test_entry_c2_on_cpu():
    fn, (rg, pil, beta) = entry.entry(device="cpu", batch=2)
    out = fn(rg, pil, beta)
    assert out.channel_est_rg.shape == (2, 2, 4, 14, 1272)
    assert out.channel_est_rg.dtype == torch.float32
    assert torch.isfinite(out.channel_est_rg).all()
    assert torch.isfinite(out.noise_est).all() and (out.noise_est > 0).all()
    assert abs(float(out.cfo_hz[0]) - 200.0) < 10.0


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a CUDA device chip_smoke exits non-zero and prints no result;
    alone in a directory (no package beside it) it fails too."""
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_bytes((REPO / "chip_smoke.py").read_bytes())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                             text=True, timeout=120, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Every entry point runs on the card unless asked for the CPU: with no CUDA
    device its default raises (never a quiet move to the CPU), and the message
    names the way out."""
    from srsran_ce_tpu_torch.ops import ldpc
    from srsran_ce_tpu_torch.validation import conformance

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    case = synthetic.make_case(seed=1, n_prbs=4, n_layers=1, snr_db=30.0)
    calls = {
        "entry": lambda: entry.entry(batch=1),
        "build": lambda: est.build(case.hop1, case.hop2, case.config, 1),
        "build_batched": lambda: est.build_batched(case.hop1, case.hop2, case.config, 1),
        "estimate": lambda: est.estimate(case.received_rg, case.pilots, case.beta, case.hop1,
                                         case.hop2, case.config),
        "run_case": lambda: conformance.run_case(None, tmp_path),
        "run_suite": lambda: conformance.run_suite(tmp_path / "none.h", tmp_path),
        "build_decoder": lambda: ldpc.build_decoder(ldpc.array_code(3, 8, 13), n_iters=2),
    }
    for call in calls.values():
        with pytest.raises(RuntimeError, match=r"device=cuda: no CUDA device here \(pass device=cpu"):
            call()
    with pytest.raises(RuntimeError, match="the port runs on 'cpu' or 'cuda'"):
        est.build(case.hop1, case.hop2, case.config, 1, device="meta")
