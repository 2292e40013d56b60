"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version (CPU tensors never reach
a CUDA kernel), so these tests hold `fused_front_plain`,
`fused_fill_rotate_serve_plain`, `rc_smooth_plain`, `fused_fill_rotate_plain`
and `inpaint_stack_plain` against `srsran_ce_tpu.ops.pallas.kernels` run in
interpret mode, as the JAX package's own tests run it. Inputs come from
numpy seeds and feed both sides.

Tolerances:
  float64 — relative 1e-10 on arrays (max-abs error over max-abs value) and
    on scalars; TA equal. The JAX kernel's `mathx.atan2` is a float32-accurate
    Cephes polynomial even in float64 (mathx.py:27-46, ~1e-9 relative in the
    CFO and virtual pilots), so the float64 comparisons substitute
    `jnp.arctan2` for it on the JAX side (monkeypatch; the package is not
    changed) — they check the structure, not the polynomial.
  float32 — the JAX package's kernel-vs-XLA bounds of
    tests/test_pallas_kernels.py:319-332 (NMSE 1e-9, noise rtol 1e-4, rsrp
    1e-5, epre 1e-6, ta 1e-6, cfo 1e-4), with the unmodified JAX kernel.
`front_finish_plain` replaces no JAX kernel: it is held against the
arithmetic it took the place of (the dense operator product per CDM group and
the scalar finish in plain torch), float64 within 1e-13 and float32 within
1e-6 relative.
The CUDA kernels themselves are held against their plain versions on the card
by tests/test_torch_gpu.py (no JAX there) and chip_smoke.py.
"""
import dataclasses
import math
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from srsran_ce_tpu.models import estimator as jest
from srsran_ce_tpu.ops import dsp as jdsp
from srsran_ce_tpu.ops.pallas import kernels as jk
from srsran_ce_tpu.ops.pallas import mathx as jmathx
from srsran_ce_tpu_torch.models import estimator as port_est
from srsran_ce_tpu_torch.models.plan import make_plan, plan_tensors
from srsran_ce_tpu_torch.ops import mathx
from srsran_ce_tpu_torch.ops import dsp
from srsran_ce_tpu_torch.ops.kernels import _build
from srsran_ce_tpu_torch.ops.kernels import fill_rotate as k6
from srsran_ce_tpu_torch.ops.kernels import fill_rotate_serve as k2
from srsran_ce_tpu_torch.ops.kernels import front as k1
from srsran_ce_tpu_torch.ops.kernels import front_finish as kf
from srsran_ce_tpu_torch.ops.kernels import inpaint as k7
from srsran_ce_tpu_torch.ops.kernels import rc_smooth as k5
from srsran_ce_tpu_torch.utils import synthetic

FRONT_CASES = [
    ("nL4_2cdm", dict(n_prbs=26, n_layers=4, comb=2, snr_db=30.0)),
    ("nL1_cfo_off", dict(n_prbs=24, n_layers=1, comb=2, snr_db=25.0, cfo_compensate=False)),
    ("nL2_two_hops", dict(n_prbs=12, n_layers=2, comb=2, snr_db=30.0, two_hops=True)),
    ("nL3", dict(n_prbs=16, n_layers=3, comb=2, snr_db=30.0)),
    ("nL1_one_dmrs_sym", dict(n_prbs=8, n_layers=1, comb=2, snr_db=30.0, n_dmrs_syms=1)),
]


@pytest.fixture
def exact_jax_atan2(monkeypatch):
    monkeypatch.setattr(jmathx, "atan2", jnp.arctan2)


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def front_inputs(kw, dtype, batch=3, seed=0):
    """Per-hop fused-front inputs of a synthetic case, each problem perturbed
    by seeded noise: [(hop plan, torch args, torch kwargs, jax args, jax kwargs)]."""
    case = synthetic.make_case(seed=31, **kw)
    nL = case.pilots.shape[2]
    plan = make_plan(case.hop1, case.hop2, case.config, nL)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    pt = plan_tensors(plan, "cpu", tdt)
    rng = np.random.default_rng(seed)
    rg = port_est.split_ri(case.received_rg)
    rg = np.broadcast_to(rg, (batch,) + rg.shape) + 1e-3 * rng.standard_normal((batch,) + rg.shape)
    pil = np.broadcast_to(port_est.split_ri(case.pilots), (batch, 2) + case.pilots.shape)
    beta = np.full(batch, case.beta) * (1.0 + 0.1 * rng.uniform(size=batch))
    rg_t = torch.as_tensor(rg.astype(dtype))
    out = []
    d0 = 0
    for hp, ht in zip([plan.hop1, plan.hop2], pt["hops"]):
        rx = port_est._gather_rx(hp, ht, rg_t)
        pil_h = np.ascontiguousarray(
            np.transpose(pil[:, :, :, d0 : d0 + hp.n_dsym], (0, 1, 4, 3, 2)).astype(dtype)
        )
        d0 += hp.n_dsym
        mats = ht["front"]
        common = dict(
            n_samples=hp.n_samples, half_cp_len=hp.half_cp_len, fft_size=hp.fft_size,
            scs_hz=case.config.scs_hz, cfo_possible=hp.cfo_possible,
            cfo_compensate=case.config.cfo_compensate,
        )
        sst = plan.symbol_start_time
        jkw = dict(common, sst_d=None if sst is None else sst[hp.dmrs_sym_idx])
        t_args = (rx, torch.as_tensor(pil_h), torch.as_tensor(beta.astype(dtype)), mats)
        j_args = (jnp.asarray(rx.numpy()), jnp.asarray(pil_h), jnp.asarray(beta.astype(dtype)),
                  jest._front_mats(hp))
        out.append((hp, t_args, common, j_args, jkw))
    return out


@pytest.mark.parametrize("name,kw", FRONT_CASES, ids=[c[0] for c in FRONT_CASES])
def test_fused_front_plain_matches_jax_f64(name, kw, exact_jax_atan2):
    for hp, t_args, t_kw, j_args, j_kw in front_inputs(kw, np.float64):
        h_t, s_t = k1.fused_front_plain(*t_args, **t_kw)
        h_j, s_j = jk.fused_front(*j_args, **j_kw)
        assert rel(h_t, h_j) <= 1e-10, (name, rel(h_t, h_j))
        s_t, s_j = s_t.numpy(), np.asarray(s_j)
        np.testing.assert_array_equal(s_t[:, 1], s_j[:, 1])  # TA: discrete bins
        np.testing.assert_allclose(s_t, s_j, rtol=1e-10, atol=1e-300)


@pytest.mark.parametrize("name,kw", FRONT_CASES[:4], ids=[c[0] for c in FRONT_CASES[:4]])
def test_fused_front_plain_matches_jax_f32(name, kw):
    for hp, t_args, t_kw, j_args, j_kw in front_inputs(kw, np.float32, seed=1):
        h_t, s_t = k1.fused_front_plain(*t_args, **t_kw)
        h_j, s_j = jk.fused_front(*j_args, **j_kw, precision="high")
        a, b = h_t.numpy().astype(np.float64), np.asarray(h_j, np.float64)
        assert np.sum((a - b) ** 2) / np.sum(b**2) < 1e-9, name
        s_t, s_j = s_t.numpy(), np.asarray(s_j)
        np.testing.assert_allclose(s_t[:, 0], s_j[:, 0], rtol=1e-4, atol=1e-9)  # cfo
        np.testing.assert_allclose(s_t[:, 1], s_j[:, 1], rtol=1e-6, atol=1e-12)  # ta
        np.testing.assert_allclose(s_t[:, 2], s_j[:, 2], rtol=1e-4)  # noise
        np.testing.assert_allclose(s_t[:, 3], s_j[:, 3], rtol=1e-5)  # rsrp
        np.testing.assert_allclose(s_t[:, 4], s_j[:, 4], rtol=1e-6)  # epre


def fill_inputs(nL, n_cdm, dtype, seed):
    rng = np.random.default_rng(seed)
    B, n_re, n_sc, n_sym = 3, 52, 208, 14
    h = rng.standard_normal((B, 2, nL, n_re)).astype(dtype)
    w = (0.1 * rng.standard_normal((n_cdm, n_re, n_sc))).astype(dtype)
    ph = rng.uniform(-np.pi, np.pi, (B, n_sym))
    rot = np.stack([np.cos(ph), np.sin(ph)], 1).astype(dtype)
    return h, w, rot


@pytest.mark.parametrize(
    "nL,slices",
    [(4, ((0, 2), (2, 4))), (3, ((0, 2), (2, 3))), (1, ((0, 1),)), (4, ((0, 4),))],
    ids=["equal_2x2", "unequal_2_1", "one_layer", "one_group_4"],
)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fill_rotate_serve_plain_matches_jax(nL, slices, dtype):
    h, w, rot = fill_inputs(nL, len(slices), dtype, seed=nL)
    got = k2.fused_fill_rotate_serve_plain(
        torch.as_tensor(h), torch.as_tensor(w), torch.as_tensor(rot), layer_slices=slices
    )
    want = jk.fused_fill_rotate_serve(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(rot), layer_slices=slices
    )
    assert got.shape == want.shape == (3, 2, nL, 14, 208)
    tol = 1e-10 if dtype == np.float64 else 1e-5
    assert rel(got.numpy(), want) <= tol


@pytest.mark.parametrize("C,n_ext,K", [(8, 650, 15), (32, 60, 15), (2, 20, 5), (4, 9, 1)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_rc_smooth_plain_matches_jax(C, n_ext, K, dtype):
    """K5's plain version vs the JAX kernel, c2 rows (C = 2*nL = 8, n_ext =
    636 + 2*7, K = 15) and the time-interpolation row count among them."""
    rng = np.random.default_rng(K * C)
    x = rng.standard_normal((3, C, n_ext)).astype(dtype)
    taps = rng.standard_normal(K)
    got = k5.rc_smooth_plain(torch.as_tensor(x), taps)
    want = jk.rc_smooth(jnp.asarray(x), taps)
    assert got.shape == want.shape == (3, C, n_ext - K + 1)
    assert rel(got.numpy(), want) <= (1e-14 if dtype == np.float64 else 1e-6)


def _inpaint_w(n_re_groups, comb, n_sc, dtype):
    """(n_groups, n_re, n_sc) inpainting operators (comb offsets per group) and
    the JAX package's operators for the same masks."""
    ws, jws = [], []
    for c in range(n_re_groups):
        known = np.zeros(n_sc, dtype=bool)
        known[c::comb] = True
        ws.append(dsp.inpaint_operator(known, max(6, n_sc // 8), torch.float64, "cpu"))
        jws.append(np.asarray(jdsp.inpaint_operator(known, max(6, n_sc // 8), np.float64)))
    return torch.stack(ws).numpy().astype(dtype), np.stack(jws).astype(dtype)


@pytest.mark.parametrize(
    "nL,slices,w_kind",
    [(4, ((0, 2), (2, 4)), "linear"), (3, ((0, 2), (2, 3)), "linear"), (1, ((0, 1),), "linear"),
     (2, ((0, 2),), "inpaint"), (3, ((0, 2), (2, 3)), "inpaint")],
    ids=["equal_2x2", "unequal_2_1", "one_layer", "inpaint_one_group", "inpaint_unequal"],
)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fill_rotate_plain_matches_jax(nL, slices, w_kind, dtype):
    """K6's plain version vs the JAX kernel, which takes one CDM group per call
    (as `_grid_fill_rotate_pallas` calls it): the JAX blocks are concatenated
    along the layer axis."""
    if w_kind == "linear":
        h, w, rot = fill_inputs(nL, len(slices), dtype, seed=nL)
        jw = w
    else:
        rng = np.random.default_rng(nL)
        w, jw = _inpaint_w(len(slices), 2, 208, dtype)
        h = rng.standard_normal((3, 2, nL, w.shape[1])).astype(dtype)
        ph = rng.uniform(-np.pi, np.pi, (3, 14))
        rot = np.stack([np.cos(ph), np.sin(ph)], 1).astype(dtype)
    got = k6.fused_fill_rotate_plain(
        torch.as_tensor(h), torch.as_tensor(w), torch.as_tensor(rot), layer_slices=slices
    )
    want = np.concatenate(
        [np.asarray(jk.fused_fill_rotate(jnp.asarray(h[:, :, l0:l1]), jnp.asarray(jw[c]),
                                         jnp.asarray(rot)))
         for c, (l0, l1) in enumerate(slices)],
        axis=-1,
    )
    assert got.shape == want.shape == (3, 2, 208, 14, nL)
    assert rel(got.numpy(), want) <= (1e-10 if dtype == np.float64 else 1e-5)


def test_fill_rotate_writes_block_into_grid_on_cpu():
    """`out=` places the block and leaves the rest of the grid untouched; the
    plain path counts no launch."""
    h, w, rot = (torch.as_tensor(a) for a in fill_inputs(3, 2, np.float64, 1))
    rot = rot[:, :, :10]
    grid = torch.full((3, 2, 230, 14, 3), 5.0, dtype=torch.float64)
    n6 = k6.launches
    out = k6.fused_fill_rotate(h, w, rot, ((0, 2), (2, 3)), out=grid, sc_start=11, sym_start=2)
    assert out is grid and k6.launches == n6
    blk = k6.fused_fill_rotate_plain(h, w, rot, ((0, 2), (2, 3)))
    assert torch.equal(grid[:, :, 11:219, 2:12], blk)
    assert (grid[:, :, :11] == 5).all() and (grid[:, :, 219:] == 5).all()
    assert (grid[:, :, :, :2] == 5).all() and (grid[:, :, :, 12:] == 5).all()


def test_mathx_atan2_axes_and_signed_zeros():
    vals = np.array([-2.0, -1.0, -1e-30, -0.0, 0.0, 1e-30, 1.0, 2.0, 3.5])
    y, x = np.meshgrid(vals, vals, indexing="ij")
    got = mathx.atan2(torch.as_tensor(y), torch.as_tensor(x)).numpy()
    want = np.arctan2(y, x)
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
    assert got[3, 0] == -np.pi and got[4, 0] == np.pi  # atan2(-0, x<0) = -pi
    # the JAX emulation agrees to its float32 polynomial accuracy, signs exactly
    jax_v = np.asarray(jmathx.atan2(jnp.asarray(y), jnp.asarray(x)))
    np.testing.assert_allclose(got, jax_v, rtol=1e-6, atol=1e-12)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(jax_v))


def test_mathx_unwrap_across_pi_jumps():
    rng = np.random.default_rng(3)
    walk = np.cumsum(rng.uniform(-2.5, 2.5, (6, 40)), axis=-1)
    wrapped = np.angle(np.exp(1j * walk))
    edge = np.array([[3.0, -3.0, 3.1, -3.1, 0.0, np.pi, -np.pi, np.pi, 0.5, -np.pi]])
    for ph in (wrapped, edge, np.zeros((2, 1))):
        got = mathx.unwrap_last(torch.as_tensor(ph)).numpy()
        np.testing.assert_allclose(got, np.unwrap(ph, axis=-1), rtol=0, atol=1e-12)
        if ph.shape[-1] > 1:
            want = np.asarray(jmathx.unwrap_last(jnp.asarray(ph)))
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_mathx_argmax_first_maximum():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 4, (50, 17)).astype(np.float64)  # many ties
    x = np.concatenate([x, np.full((1, 17), 2.0), [[1, 3, 3, 2] + [0] * 13]])
    got = mathx.argmax_last(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, np.argmax(x, axis=-1))
    np.testing.assert_array_equal(got, np.asarray(jmathx.argmax_last(jnp.asarray(x))))


def test_wrappers_take_plain_version_on_cpu():
    (hp, t_args, t_kw, _, _), = front_inputs(FRONT_CASES[0][1], np.float32)
    n1, n2 = k1.launches, k2.launches
    h_w, s_w = k1.fused_front(*t_args, **t_kw)
    h_p, s_p = k1.fused_front_plain(*t_args, **t_kw)
    assert torch.equal(h_w, h_p) and torch.equal(s_w, s_p)
    h, w, rot = (torch.as_tensor(a) for a in fill_inputs(3, 2, np.float32, 0))
    assert torch.equal(
        k2.fused_fill_rotate_serve(h, w, rot, ((0, 2), (2, 3))),
        k2.fused_fill_rotate_serve_plain(h, w, rot, ((0, 2), (2, 3))),
    )
    assert (k1.launches, k2.launches) == (n1, n2)  # plain versions never count
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((2, 4, 30)))
    n5 = k5.launches
    assert torch.equal(k5.rc_smooth(x, np.ones(5) / 5), k5.rc_smooth_plain(x, np.ones(5) / 5))
    assert k5.launches == n5


def test_wrappers_reject_other_devices():
    h = torch.empty((2, 2, 2, 8), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        k2.fused_fill_rotate_serve(h, torch.empty((8, 16), device="meta"),
                                   torch.empty((2, 2, 14), device="meta"))
    (hp, t_args, t_kw, _, _), = front_inputs(FRONT_CASES[1][1], np.float32)
    with pytest.raises(ValueError, match="CUDA"):
        k1.fused_front(t_args[0].to("meta"), *t_args[1:], **t_kw)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        k5.rc_smooth(torch.empty((2, 4, 30), device="meta"), np.ones(5))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        k6.fused_fill_rotate(h, torch.empty((8, 16), device="meta"),
                             torch.empty((2, 2, 14), device="meta"))


# The staged form of K1's inputs: the grid and the pilots as the caller staged
# them, read through the hop's RE and symbol tables (ops/kernels/front.py).
STAGED_CASES = FRONT_CASES + [
    ("cell_shape", dict(n_prbs=106, n_layers=4, comb=2, scs_hz=30e3, snr_db=20.0)),
    ("partial_prb_gap", dict(n_prbs=20, n_layers=3, comb=2, snr_db=30.0, prb_start=6,
                             n_prb_total=30, prb_hole=(5, 8))),
    ("two_hops_gap", dict(n_prbs=24, n_layers=1, comb=2, snr_db=30.0, two_hops=True,
                          prb_hole=(4, 6))),
]


def staged_inputs(kw, dtype, batch=3, seed=0):
    """The staged batch of a synthetic case: (plan, plan tensors, grid (B, 2,
    n_sc, n_sym), pilots (B, 2, n_re, nd_total, nL), beta), each problem
    perturbed by seeded noise."""
    case = synthetic.make_case(seed=31, **kw)
    plan = make_plan(case.hop1, case.hop2, case.config, case.pilots.shape[2])
    pt = plan_tensors(plan, "cpu", dtype)
    rng = np.random.default_rng(seed)
    rg = port_est.split_ri(case.received_rg)
    rg = np.broadcast_to(rg, (batch,) + rg.shape) + 1e-3 * rng.standard_normal((batch,) + rg.shape)
    pil = np.broadcast_to(port_est.split_ri(case.pilots), (batch, 2) + case.pilots.shape)
    beta = np.full(batch, case.beta) * (1.0 + 0.1 * rng.uniform(size=batch))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)
    return case, plan, pt, t(rg), t(pil), t(beta)


def hop_views(plan, pt, pil):
    """Per hop: (hop plan, hop tensors, d0, the hop's view of the staged pilots)."""
    out, d0 = [], 0
    for hp, ht in zip([plan.hop1, plan.hop2], pt["hops"]):
        out.append((hp, ht, d0, pil[:, :, :, d0 : d0 + hp.n_dsym]))
        d0 += hp.n_dsym
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name,kw", STAGED_CASES, ids=[c[0] for c in STAGED_CASES])
def test_fused_front_staged_plain_equals_the_gathered_route(name, kw, dtype):
    """On the CPU the staged form (the grid, a hop's view of the staged
    pilots, its tables) gives, bit for bit, what `_gather_rx` and the pilots'
    permute feeding `fused_front_plain` give; the gather follows the rule
    rx[b, ri, c, d, k] = rg[b, ri, re_idx[c n_re + k], sym[d]] and
    pil[b, ri, l, d, k] = pil_ri[b, ri, k, d0 + d, l] element for element; the
    plain version counts no launch."""
    case, plan, pt, rg, pil, beta = staged_inputs(kw, dtype, seed=len(name))
    n0, r0 = k1.launches, dict(k1.route_launches)
    views = hop_views(plan, pt, pil)
    assert len(views) == 1 + kw.get("two_hops", False)
    for hp, ht, d0, pil_h in views:
        t_kw = dict(n_samples=hp.n_samples, half_cp_len=hp.half_cp_len, fft_size=hp.fft_size,
                    scs_hz=case.config.scs_hz, cfo_possible=hp.cfo_possible,
                    cfo_compensate=case.config.cfo_compensate)
        rx_g = port_est._gather_rx(hp, ht, rg)
        pil_g = pil_h.permute(0, 1, 4, 3, 2).contiguous()
        re_t = hp.re_idx.reshape(hp.n_cdm, hp.n_re)
        want_rx = rg.numpy()[:, :, re_t[:, None, :], hp.dmrs_sym_idx[None, :, None]]
        want_pil = np.transpose(pil.numpy()[:, :, :, d0 : d0 + hp.n_dsym], (0, 1, 4, 3, 2))
        rx_s, pil_s = k1.gather_staged(rg, pil_h, ht["re_idx"], ht["dmrs_sym_idx"])
        assert np.array_equal(rx_s.numpy(), want_rx) and np.array_equal(pil_s.numpy(), want_pil)
        assert torch.equal(rx_s, rx_g) and torch.equal(pil_s, pil_g)
        h_s, s_s = k1.fused_front(rg, pil_h, beta, ht["front"], re_idx=ht["re_idx"],
                                  dmrs_sym_idx=ht["dmrs_sym_idx"], **t_kw)
        h_g, s_g = k1.fused_front_plain(rx_g, pil_g, beta, ht["front"], **t_kw)
        assert torch.equal(h_s, h_g) and torch.equal(s_s, s_g), (name, d0)
    assert (k1.launches, k1.route_launches) == (n0, r0)


def test_fused_front_refuses_bad_staged_inputs():
    """The wrapper checks the staged form's grid, pilots and tables on either
    device, before any launch: shape, dtype and device of each."""
    case, plan, pt, rg, pil, beta = staged_inputs(FRONT_CASES[0][1], torch.float32)
    hp, ht = plan.hop1, pt["hops"][0]
    kw = dict(n_samples=hp.n_samples, half_cp_len=hp.half_cp_len, fft_size=hp.fft_size,
              scs_hz=case.config.scs_hz, cfo_possible=hp.cfo_possible,
              cfo_compensate=case.config.cfo_compensate)
    re_idx, sym = ht["re_idx"], ht["dmrs_sym_idx"]

    def call(rg_=rg, pil_=pil, re_=re_idx, sym_=sym):
        return k1.fused_front(rg_, pil_, beta, ht["front"], re_idx=re_, dmrs_sym_idx=sym_, **kw)

    call()  # as given, it runs
    bad = [
        ("grid", dict(rg_=torch.cat([rg, rg[:, :1]], 1)), ValueError, "staged grid"),
        ("grid", dict(rg_=rg[0]), ValueError, "takes no tables"),
        ("pilots", dict(pil_=pil[:, :, :-1]), ValueError, "pil_ri has shape"),
        ("pilots", dict(pil_=pil[:, :, :, :, :2]), ValueError, "shape"),
        ("pilots", dict(pil_=pil[..., 0]), ValueError, "staged pilots"),
        ("table", dict(re_=re_idx.to(torch.int32)), TypeError, "int64"),
        ("table", dict(sym_=sym.to(torch.float32)), TypeError, "int64"),
        ("table", dict(re_=re_idx[:-1]), ValueError, "re_idx has shape"),
        ("table", dict(sym_=sym[:1]), ValueError, "pil_ri has shape"),
        ("table", dict(re_=re_idx.reshape(hp.n_cdm, -1)), TypeError, "1-D"),
        ("table", dict(re_=None), ValueError, "needs the hop's re_idx"),
        ("table", dict(sym_=None), ValueError, "needs the hop's dmrs_sym_idx"),
        ("table", dict(re_=re_idx.to("meta")), ValueError, "re_idx is on meta"),
        ("table", dict(sym_=sym.to("meta")), ValueError, "dmrs_sym_idx is on meta"),
    ]
    for what, args, exc, match in bad:
        with pytest.raises(exc, match=match):
            call(**args)
    with pytest.raises(ValueError, match="CPU \\(plain\\) or CUDA"):
        call(rg_=rg.to("meta"), pil_=pil.to("meta"), re_=re_idx.to("meta"), sym_=sym.to("meta"))
    # the gathered form takes no tables
    rx_g, pil_g = k1.gather_staged(rg, pil, re_idx, sym)
    with pytest.raises(ValueError, match="takes no tables"):
        k1.fused_front(rx_g, pil_g, beta, ht["front"], re_idx=re_idx, **kw)


@pytest.mark.parametrize("layout", ["serve", "factored"])
@pytest.mark.parametrize("name,kw", [STAGED_CASES[0], STAGED_CASES[2], STAGED_CASES[6],
                                     STAGED_CASES[7]],
                         ids=["nL4_2cdm", "nL2_two_hops", "partial_prb_gap", "two_hops_gap"])
def test_pallas_front_on_cpu_is_unchanged_by_the_staged_inputs(name, kw, layout, monkeypatch):
    """`_front_pallas_batched` ("pallas_front") hands K1 the grid and each
    hop's view of the staged pilots from its first symbol, with the hop's
    tables; its result equals, bit for bit, the one of the route before it
    (each hop's `_gather_rx` and a permuted copy of its pilots, then the
    gathered form)."""
    case, plan, pt, rg, pil, beta = staged_inputs(kw, torch.float64, batch=2, seed=3)
    views = hop_views(plan, pt, pil)
    seen = []

    def gathered_route(rg_, pil_h, beta_, mats, *, re_idx, dmrs_sym_idx, **f_kw):
        h = next(i for i, v in enumerate(views) if v[1]["re_idx"] is re_idx)
        hp, ht, d0, view = views[h]
        assert rg_ is rg and dmrs_sym_idx is ht["dmrs_sym_idx"] and mats is ht["front"]
        assert pil_h.data_ptr() == view.data_ptr() and pil_h.shape == view.shape
        assert pil_h.stride() == pil.stride()  # a view, not a copy
        seen.append(d0)
        rx = port_est._gather_rx(hp, ht, rg)
        pil_g = pil[:, :, :, d0 : d0 + hp.n_dsym].permute(0, 1, 4, 3, 2).contiguous()
        return k1.fused_front_plain(rx, pil_g, beta_, mats, **f_kw)

    got = port_est._front_pallas_batched(plan, pt, rg, pil, beta, layout)
    monkeypatch.setattr(port_est._k1, "fused_front", gathered_route)
    want = port_est._front_pallas_batched(plan, pt, rg, pil, beta, layout)
    assert seen == [v[2] for v in views]
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert torch.equal(a, b) or (a.isnan().all() and b.isnan().all()), (name, f.name)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert not (tmp_path / "build").exists()


@pytest.mark.parametrize("n,comb", [(48, 2), (96, 4)])
def test_inpaint_stack_plain_matches_jax(n, comb):
    """K7's plain version against the JAX `inpaint_stack` in interpret mode,
    float64, at the JAX test's shapes (tests/test_pallas_kernels.py:49-66)."""
    rng = np.random.default_rng(n)
    known = np.zeros(n, dtype=bool)
    known[::comb] = True
    n_iters = max(6, n // 8)
    vals = rng.standard_normal((2, 4, n))
    x_ri = np.where(known, vals, 0.0)
    want = np.asarray(jk.inpaint_stack(jnp.asarray(x_ri), known, n_iters))
    n0 = k7.launches
    got = k7.inpaint_stack(torch.as_tensor(x_ri), known, n_iters)
    assert k7.launches == n0  # the plain version on a CPU tensor
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    schedule = jdsp.make_inpaint_schedule(known, n_iters)
    got_s = k7.inpaint_stack_plain(torch.as_tensor(x_ri), known, n_iters, schedule=schedule)
    assert torch.equal(got_s, got)


def test_inpaint_stack_plain_all_known_pins_every_value():
    """Every position known: the JAX kernel pins the whole row, and so does the
    plain version (dsp.cnn_inpaint would low-pass it instead)."""
    x = np.random.default_rng(2).standard_normal((1, 2, 12))
    known = np.ones(12, bool)
    want = np.asarray(jk.inpaint_stack(jnp.asarray(x), known, 6))
    np.testing.assert_array_equal(want, x)
    assert torch.equal(k7.inpaint_stack(torch.as_tensor(x), known, 6), torch.as_tensor(x))


def test_inpaint_stack_rejects_other_devices():
    with pytest.raises(ValueError, match="CPU or CUDA"):
        k7.inpaint_stack(torch.empty((2, 4, 30), device="meta"), np.ones(30, bool), 6)


def test_inpaint_route_table_covers_every_row_length():
    """K7's route table: every n from 3 to the largest the wrapper accepts
    goes to the first route whose capacity (a warp's 32 S cells, or a block's
    16 warps of 30 S core cells) holds it; shorter and longer rows raise."""
    caps = [k7.capacity(r) for r in range(len(k7.ROUTES))]
    assert k7.MAX_N == max(caps)
    for n in range(3, k7.MAX_N + 1):
        r = k7.route_for(n)
        assert caps[r] >= n and all(c < n for c in caps[:r]), n
    for n in (0, 1, 2, k7.MAX_N + 1):
        with pytest.raises(ValueError, match="rows of 3"):
            k7.route_for(n)


def test_inpaint_route_table_matches_the_kernel_source():
    """ROUTES mirrors csrc/inpaint.cu's kRoutes entry by entry (the C entry
    takes the route id), read from the source: no nvcc here."""
    src = (_build.CSRC_DIR / "inpaint.cu").read_text()
    table = src[src.index("kRoutes[] = {"): src.index("};", src.index("kRoutes[] = {"))]
    entries = [tuple(int(v) for v in m)
               for m in re.findall(r"\{inpaint_kernel<(\d+), (\d+)>", table)]
    assert tuple(entries) == k7.ROUTES
    assert f"kMaxBlockThreads = {32 * k7._BLOCK_WARPS};" in src


def _k7_kernel_arithmetic(x, known, n_iters):
    """K7's arithmetic as csrc/inpaint.cu performs it, in numpy float32: each
    conv3 sum rounded apart (0.25 l + 0.5 c, then + 0.25 r), x * m_t before the
    conv and 1 / (den_t + eps) after it, and the steady passes without the
    plain version's product by 1 / (1 + eps)."""
    f32 = np.float32

    def conv3(v):
        vp = np.concatenate([v[..., 1:2], v, v[..., -2:-1]], axis=-1)
        return (f32(0.25) * vp[..., :-2] + f32(0.5) * vp[..., 1:-1]) + f32(0.25) * vp[..., 2:]

    transient, steady = dsp.make_inpaint_schedule(known, n_iters)
    y = x
    for m, den in transient:
        y = np.where(known, x, conv3(y * m.astype(f32)) * (1.0 / (den + 1e-12)).astype(f32))
    for _ in range(steady):
        y = np.where(known, x, conv3(y))
    return np.where(known, x, conv3(conv3(y)))


# every route boundary of K7's table (the last n a route holds, the first it
# hands on), n = 3 and an odd n
K7_EDGE_NS = sorted({k7.capacity(r) + d for r in range(len(k7.ROUTES)) for d in (0, 1)
                     if k7.capacity(r) + d <= k7.MAX_N} | {3, 1001})


@pytest.mark.parametrize("n", K7_EDGE_NS)
def test_inpaint_kernel_arithmetic_matches_plain_float32(n):
    """The float32 steady factor 1 / (1 + 1e-12) is exactly 1, so the kernel's
    steady passes, which leave it out, stay bit-identical to the plain
    version at every route boundary (combs 2-4, max(6, n // 8) iterations)."""
    assert np.float32(1.0 / (1.0 + k7._EPS)) == 1.0
    known = np.zeros(n, dtype=bool)
    known[:: 2 + n % 3] = True
    x = np.where(known, np.random.default_rng(n).standard_normal((2, 2, n)), 0.0).astype(np.float32)
    want = k7.inpaint_stack_plain(torch.as_tensor(x), known, max(6, n // 8)).numpy()
    np.testing.assert_array_equal(_k7_kernel_arithmetic(x, known, max(6, n // 8)), want)


def test_rc_smooth_taps_struct_is_cached_and_reversed():
    """K5's launch argument: K and the taps reversed in float32, one struct per
    taps (by their float64 bytes), reused for equal taps."""
    taps = np.random.default_rng(3).standard_normal(15)
    tab = k5.taps_struct(taps)
    assert tab.k == 15
    np.testing.assert_array_equal(np.array(tab.t[:15], np.float32), taps[::-1].astype(np.float32))
    assert k5.taps_struct(taps.copy()) is tab and k5.taps_struct(list(taps)) is tab
    assert k5.taps_struct(taps * 2) is not tab
    assert k5.taps_struct(np.ones(32)).k == 32
    with pytest.raises(ValueError, match="1..32 taps"):
        k5.taps_struct(np.ones(33))


# ---------------------------------------------------------------------------
# K1 and K2 as redesigned for Hopper: the launch plans, the gate, and float32
# models of each kernel's order of summation (the CUDA kernels run only on the
# card; tests/test_torch_gpu.py holds them to their plain versions there)
# ---------------------------------------------------------------------------

# the JAX bench's five configurations (bench.py:68-74) and the estimator and
# kernel tests' configurations, plus the ones the gate turns away
GATE_CONFIGS = [
    dict(n_prbs=52, n_layers=1, comb=2, scs_hz=15e3),
    dict(n_prbs=52, n_layers=1, comb=2, scs_hz=30e3),
    dict(n_prbs=106, n_layers=4, comb=2, scs_hz=30e3),
    dict(n_prbs=273, n_layers=1, comb=2, scs_hz=30e3, interp="cnn"),
    dict(n_prbs=24, n_layers=1, comb=2, scs_hz=30e3, two_hops=True),
    dict(n_prbs=26, n_layers=4, comb=2),
    dict(n_prbs=12, n_layers=2, comb=2, two_hops=True),
    dict(n_prbs=16, n_layers=3, comb=2),
    dict(n_prbs=20, n_layers=1, comb=2, cfo_compensate=False, prb_start=6, n_prb_total=30),
    dict(n_prbs=24, n_layers=1, comb=2, cfo_compensate=False),
    dict(n_prbs=8, n_layers=1, comb=2, n_dmrs_syms=1),
    dict(n_prbs=16, n_layers=1, smoothing="wiener"),
    dict(n_prbs=16, n_layers=1, time_interp="linear"),
    dict(n_prbs=16, n_layers=1, interp="cnn"),
    dict(n_prbs=86, n_layers=8, comb=4),
    dict(n_prbs=4, n_layers=2, comb=2),
]


H100_CAPS = (132, 66, 39, 30, 22, 17, 15, 15)  # chip_smoke phase 2 on an H100 80GB HBM3


def parent_smem_fits(n_re, nL, n_pils, half_cp_len):
    """The parent's shared-memory rule for K1: one block a problem holding H
    and Hs (2 x 2nL x n_re), the PDP and the edge and virtual-pilot rows."""
    rows = 2 * nL
    return 4 * (2 * rows * n_re + 2 * half_cp_len + 4 * rows * n_pils) <= k1.SMEM_LIMIT


@pytest.mark.parametrize("kw", GATE_CONFIGS, ids=[str(i) for i in range(len(GATE_CONFIGS))])
def test_front_gate_admits_the_parents_plans(kw, monkeypatch):
    """`_front_pallas_ok` asks K1's launch plan, on the banded route at every
    band; up to 1,024 pilot REs, where the plan builds the dense operator, it
    admits exactly the plans that the first parent's shared-memory rule
    admitted (the banded plan exists wherever that rule held)."""
    case = synthetic.make_case(seed=5, **kw)
    plan = make_plan(case.hop1, case.hop2, case.config, case.pilots.shape[2])
    got = port_est._front_pallas_ok(plan)
    real = k1.launch_plan

    def parent_rule(batch, n_re, nL, n_pils, half_cp_len, k_ta, caps, n_taps):
        if n_re <= 1024 and not parent_smem_fits(n_re, nL, n_pils, half_cp_len):
            raise ValueError("does not fit")
        return real(batch, n_re, nL, n_pils, half_cp_len, k_ta, caps, n_taps)

    monkeypatch.setattr(k1, "launch_plan", parent_rule)
    assert got == port_est._front_pallas_ok(plan)


def test_front_plan_exists_wherever_the_parents_did():
    """Over every shape up to n_re = 1024 (where the plan builds the fused
    smoothing operator, n_pils <= n_re), a launch of K1's banded route exists
    exactly where the first parent's one block a problem fitted, at any batch
    and cluster capacity; a band narrower than its virtual pilots has none."""
    caps_low = tuple(max(1, c // 4) for c in k1.NOMINAL_CAPS)
    n = 0
    for nL in range(1, 9):
        for n_pils in (1, 2, 7, 12, 16):
            for hcp in (36, 144, 288):
                for n_re in (1, 2, 3, 5, 12, 24, 96, 143, 144, 300, 636, 637, 1000, 1024):
                    want = n_pils <= n_re and parent_smem_fits(n_re, nL, n_pils, hcp)
                    for batch, caps in ((1, k1.NOMINAL_CAPS), (128, k1.NOMINAL_CAPS),
                                        (1000, caps_low)):
                        try:
                            lp = k1.launch_plan(batch, n_re, nL, n_pils, hcp, n_re, caps, 15)
                        except ValueError:
                            lp = None
                        assert (lp is not None) == want, (nL, n_pils, hcp, n_re, batch)
                        if lp is not None:
                            assert lp.smem <= k1.SMEM_LIMIT and lp.P * 2 * nL <= lp.Mpad <= 32
                            assert lp.S * lp.NS >= n_re and lp.S * lp.TS >= 2 * hcp
                            assert lp.blocks == -(-batch // lp.P) * lp.S
                        n += 1
    assert n == 8 * 5 * 3 * 14 * 3


def test_front_shapes_outside_every_plan_raise():
    caps = k1.NOMINAL_CAPS
    for args in ((1, 636, 9, 7, 144, 636, 15),   # 9 layers
                 (1, 636, 4, 17, 144, 636, 15),  # 17 pilots
                 (1, 636, 4, 7, 144, 637, 15),   # a TA DFT longer than the band
                 (0, 636, 4, 7, 144, 636, 15),   # no problem
                 (1, 6, 4, 7, 144, 6, 15),       # fewer REs than virtual pilots
                 (1, 636, 4, 7, 144, 636, 14),   # an even filter
                 (1, 636, 4, 7, 144, 636, 0),    # no filter
                 (1, 20000, 8, 16, 144, 20000, 15)):  # no block holds the band
        with pytest.raises(ValueError):
            k1.launch_plan(*args[:6], caps, args[6])


def test_front_plan_at_the_main_paths_shapes():
    """c2 (B=128): one problem a block of 8 rows, 128 blocks, the TA product's
    576 columns in one pass of 3 register columns; c4 (B=256): 4 problems x
    2 blocks a cluster. `caps`: an H100 SXM's cluster capacities at one block
    an SM (chip_smoke phase 2 prints the card's): its GPCs hold 30 clusters of
    4, not the 33 that 132 SMs would."""
    caps = H100_CAPS
    c2 = k1.launch_plan(128, 636, 4, 7, 144, 636, caps, 15)
    assert (c2.P, c2.S, c2.blocks, c2.Mpad, c2.RN) == (1, 1, 128, 8, 3), c2
    c4 = k1.launch_plan(256, 144, 1, 7, 144, 144, caps, 15)
    assert (c4.P, c4.S, c4.blocks, c4.Mpad) == (4, 2, 128, 8), c4
    for lp in (c2, c4):
        assert k1.SMEM_HALF < lp.smem <= k1.SMEM_LIMIT  # one block an SM


def front_model(rx, pil, beta, mats, plan, *, n_samples, half_cp_len, fft_size, scs_hz,
                cfo_possible, cfo_compensate):
    """float32 model of csrc/front.cu's order of summation under `plan`: each
    cluster's P problems, its S blocks' column and bin shares, every partial
    (EPRE, CFO correlations, noise, RSRP) summed over the blocks in rank
    order, the CDM pairs averaged and filtered by the taps in order, the TA
    product accumulated K tile by K tile."""
    B, _, n_cdm, nd, n_re = rx.shape
    nL = pil.shape[2]
    rows, n_pils, hcp = 2 * nL, mats["vp"].shape[0], half_cp_len
    nbins, k_ta, KT = 2 * hcp, mats["ta_c"].shape[0], plan.KT
    f = torch.float32
    h_out = torch.zeros((B, rows, n_re), dtype=f)
    sc = torch.zeros((B, 8), dtype=f)
    spans = [(min(r * plan.NS, n_re), min(r * plan.NS + plan.NS, n_re)) for r in range(plan.S)]
    bins = [(min(r * plan.TS, nbins), min(r * plan.TS + plan.TS, nbins)) for r in range(plan.S)]
    cdm = [min(l // 2, n_cdm - 1) for l in range(nL)]

    def tiled(a, b):  # a (M, K) @ b (K, N), the K tiles summed in order
        acc = torch.zeros((a.shape[0], b.shape[1]), dtype=f)
        for k0 in range(0, a.shape[1], KT):
            acc = acc + a[:, k0:k0 + KT] @ b[k0:k0 + KT]
        return acc

    with k1.full_f32_matmul():
        for b in range(B):
            xr, xi = rx[b, 0], rx[b, 1]  # (n_cdm, nd, n_re)
            pr_, pi_ = pil[b, 0], pil[b, 1]  # (nL, nd, n_re)
            rec_r = xr[cdm] * pr_ + xi[cdm] * pi_  # (nL, nd, n_re)
            rec_i = xi[cdm] * pr_ - xr[cdm] * pi_
            epre = torch.zeros((), dtype=f)
            corr = torch.zeros((nL, 2), dtype=f)
            for c0, c1 in spans:
                epre = epre + (xr[..., c0:c1] ** 2 + xi[..., c0:c1] ** 2).sum()
                ar, ai, er, ei = (t[..., c0:c1] for t in (rec_r[:, 0], rec_i[:, 0],
                                                          rec_r[:, 1], rec_i[:, 1]))
                corr = corr + torch.stack([(ar * er + ai * ei).sum(-1),
                                           (ar * ei - ai * er).sum(-1)], -1)
            cfo = torch.zeros((), dtype=f)
            if cfo_possible:
                acc = torch.zeros((), dtype=f)
                for c in range(n_cdm):
                    p_ = corr[2 * c] + (corr[2 * c + 1] if 2 * c + 1 < nL else 0.0)
                    acc = acc + torch.atan2(p_[1], p_[0])
                cfo = acc / torch.tensor(2.0 * math.pi * n_samples, dtype=f) / n_cdm
            x = mats["two_pi_sst_d"] * cfo if cfo_possible and cfo_compensate else torch.zeros(nd)
            co, si = torch.cos(x)[:, None], torch.sin(x)[:, None]
            sr = (rec_r * co + rec_i * si).sum(1) / beta[b] / nd
            s_i = (rec_i * co - rec_r * si).sum(1) / beta[b] / nd
            H = torch.cat([sr, s_i])  # (rows, n_re)
            if nL >= 2:
                m = n_re // 2
                H[:, 0:2 * m:2] = H[:, 1:2 * m:2] = (H[:, 0:2 * m:2] + H[:, 1:2 * m:2]) * 0.5

            def virtual(e):
                if n_pils == 1:
                    return e
                amp = torch.sqrt(e[:nL] ** 2 + e[nL:] ** 2)
                ph = mathx.unwrap_last(torch.atan2(e[nL:], e[:nL]))
                va, vph = amp @ mats["vp"].T, ph @ mats["vp"].T
                return torch.cat([va * torch.cos(vph), va * torch.sin(vph)])

            Hs = k1.banded_smooth(H, virtual(H[:, :n_pils]),
                                  virtual(H[:, n_re - n_pils:].flip(-1)), mats["taps"])
            h_out[b] = Hs
            noise = torch.zeros((), dtype=f)
            hsum = torch.zeros((), dtype=f)
            for c0, c1 in spans:
                hr, hi = Hs[:nL, None, c0:c1], Hs[nL:, None, c0:c1]  # (nL, 1, n)
                hpr, hpi = hr * co - hi * si, hr * si + hi * co
                con_r = beta[b] * (pr_[..., c0:c1] * hpr - pi_[..., c0:c1] * hpi)
                con_i = beta[b] * (pr_[..., c0:c1] * hpi + pi_[..., c0:c1] * hpr)
                for c in range(n_cdm):
                    l0, l1 = 2 * c, min(2 * c + 2, nL)
                    dr = xr[c, :, c0:c1] - con_r[l0:l1].sum(0)
                    di = xi[c, :, c0:c1] - con_i[l0:l1].sum(0)
                    noise = noise + (dr * dr + di * di).sum()
                hsum = hsum + (Hs[:, c0:c1] ** 2).sum()
            pdp = torch.zeros(nbins, dtype=f)
            for t0, t1 in bins:
                tc = tiled(Hs[:, :k_ta], mats["ta_c"][:, t0:t1])
                ts = tiled(Hs[:, :k_ta], mats["ta_s"][:, t0:t1])
                pdp[t0:t1] = ((tc[:nL] - ts[nL:]) ** 2 + (ts[:nL] + tc[nL:]) ** 2).sum(0)
            i_d = int(mathx.argmax_last(pdp[:hcp]))
            i_a = int(mathx.argmax_last(pdp[hcp:]))
            i_max = i_d if pdp[:hcp].max() >= pdp[hcp:].max() else -(hcp - i_a)
            sc[b, :5] = torch.stack([cfo, torch.tensor(i_max / fft_size / scs_hz, dtype=f),
                                     noise, beta[b] * beta[b] * hsum * nd, epre])
    return h_out.reshape(B, 2, nL, n_re), sc


@pytest.mark.parametrize("label,kw,batch", [
    ("c2", dict(n_prbs=106, n_layers=4, comb=2, scs_hz=30e3, snr_db=30.0), 128),
    ("c4", dict(n_prbs=24, n_layers=1, comb=2, scs_hz=30e3, snr_db=30.0, two_hops=True), 256),
])
def test_front_kernel_order_model_matches_plain(label, kw, batch):
    """The kernel's order of summation, under the plan it launches at the
    main path's batch on an H100 and the one of a single problem (a cluster
    of 8 blocks, so the column and bin split is exercised), stays within
    chip_smoke phase 3's bounds of the plain version: h_s relative 1e-5, the
    scalars within rtol 1e-4, the same TA bins. A problem's arithmetic depends
    on the plan's column and bin split (S) and K tile, not on which problems
    share a cluster, so 6 seeded problems stand for the batch."""
    for hp, (rx, pil, beta, mats), t_kw, _, _ in front_inputs(kw, np.float32, batch=6, seed=7):
        plans = [k1.launch_plan(b, hp.n_re, pil.shape[2], hp.n_pils, hp.half_cp_len,
                                mats["ta_c"].shape[0], H100_CAPS, mats["taps"].shape[0])
                 for b in (batch, 1)]
        assert plans[1].S == 8  # the column and bin split is exercised
        h_p, s_p = k1.fused_front_plain(rx, pil, beta, mats, **t_kw)
        for lp in plans:
            h_m, s_m = front_model(rx, pil, beta, mats, lp, **t_kw)
            assert rel(h_m.numpy(), h_p.numpy()) <= 1e-5, (label, lp)
            s_m, s_q = s_m.numpy(), s_p.numpy()
            to_bin = t_kw["fft_size"] * t_kw["scs_hz"]
            np.testing.assert_array_equal(np.rint(s_m[:, 1] * to_bin), np.rint(s_q[:, 1] * to_bin))
            np.testing.assert_allclose(s_m[:, [0, 2, 3, 4]], s_q[:, [0, 2, 3, 4]], rtol=1e-4,
                                       atol=1e-12)


def tile_sums(a, w_c, KS):
    """float32 model of csrc/fill_common.cuh's order of summation for the rows
    `a` of one product tile: the K steps split over KS blocks, each block's
    steps accumulated one after the other, the blocks' partials summed in rank
    order."""
    n_re = a.shape[1]
    nk = -(-n_re // k2._KT)
    kc = -(-nk // KS)
    tot = None
    for r in range(KS):
        part = torch.zeros((a.shape[0], w_c.shape[1]), dtype=torch.float32)
        for s in range(r * kc, min(r * kc + kc, nk)):
            k0 = s * k2._KT
            part = part + a[:, k0:k0 + k2._KT] @ w_c[k0:k0 + k2._KT]
        tot = part if tot is None else tot + part
    return tot


def fill_model(h, w, rot, layer_slices, n_sm, layout="serve", grid=None, sc0=0, sy0=0):
    """float32 model of the grid fills' order of summation. "serve", as
    csrc/fill_rotate_serve.cu (K2) tiles it: the launch plan's tiles of 64
    (problem, layer, ri) rows of one chunk, then rotated. "ref", as
    csrc/fill_rotate.cu (K6) does: tiles of P problems, the product once per
    CDM group over the rows (problem, layer of the group, ri), the sums parked
    per (problem, ri, layer), then rotated and written into `grid` (or a new
    block) at (sc0, sy0) in the reference layout."""
    B, _, nL, n_re = h.shape
    n_sc, n_sym = w.shape[-1], rot.shape[2]
    rr_of = lambda b: rot[b, 0][:, :, None]  # (b, n_sym, 1)
    ri_of = lambda b: rot[b, 1][:, :, None]
    with k2.full_f32_matmul():
        if layout == "serve":
            chunks = k2.chunks_of(layer_slices, nL, w.shape[0])
            lp = k2.launch_plan(B, chunks, n_re, n_sc, n_sm)
            out = torch.empty((B, 2, nL, n_sym, n_sc), dtype=torch.float32)
            for c, l0, nl in chunks:
                rows = h[:, :, l0:l0 + nl].permute(0, 2, 1, 3).reshape(-1, n_re)  # (b, layer, ri)
                for m0 in range(0, rows.shape[0], k2._TM):
                    tot = tile_sums(rows[m0:m0 + k2._TM], w[c], lp.KS)
                    fr, fi = tot[0::2], tot[1::2]  # (pairs, n_sc)
                    q = torch.arange(m0 // 2, m0 // 2 + fr.shape[0])
                    b, l = q // nl, l0 + q % nl
                    rr, ri = rr_of(b), ri_of(b)
                    out[b, 0, l] = fr[:, None] * rr - fi[:, None] * ri
                    out[b, 1, l] = fr[:, None] * ri + fi[:, None] * rr
            return out, lp
        chunks = k6.fill_chunks(layer_slices, nL, w.shape[0])
        lp = k6.launch_plan(B, nL, chunks, n_re, n_sc, n_sym, n_sm)
        out = torch.empty((B, 2, n_sc, n_sym, nL), dtype=torch.float32) if grid is None else grid
        for b0 in range(0, B, lp.P):
            pv = min(lp.P, B - b0)
            sums = torch.empty((pv, 2, nL, n_sc), dtype=torch.float32)  # the parked sums
            for c, l0, nl in chunks:
                rows = h[b0:b0 + pv, :, l0:l0 + nl].permute(0, 2, 1, 3).reshape(-1, n_re)
                assert rows.shape[0] <= k2._TM  # one product tile a group
                tot = tile_sums(rows, w[c], lp.KS).reshape(pv, nl, 2, n_sc)
                sums[:, :, l0:l0 + nl] = tot.permute(0, 2, 1, 3)
            fr = sums[:, 0].permute(0, 2, 1)[:, :, None, :]  # (pv, n_sc, 1, nL)
            fi = sums[:, 1].permute(0, 2, 1)[:, :, None, :]
            b = torch.arange(b0, b0 + pv)
            rr, ri = rr_of(b)[:, None], ri_of(b)[:, None]  # (pv, 1, n_sym, 1)
            blk = out[b0:b0 + pv, :, sc0:sc0 + n_sc, sy0:sy0 + n_sym]
            blk[:, 0] = fr * rr - fi * ri
            blk[:, 1] = fr * ri + fi * rr
        return out, lp


@pytest.mark.parametrize("label,B,nL,n_re,n_sc,slices", [
    ("c2", 40, 4, 636, 1272, ((0, 2), (2, 4))),
    ("nL=3", 9, 3, 636, 1272, ((0, 2), (2, 3))),
    ("c4", 256, 1, 144, 288, ((0, 1),)),
    ("c3 operator", 3, 1, 1638, 3276, ((0, 1),)),
])
def test_fill_kernel_order_model_matches_plain(label, B, nL, n_re, n_sc, slices):
    """The kernel's order of summation, split over a cluster's blocks where
    the plan asks for it, stays within chip_smoke phase 4's bound of the plain
    version: relative 1e-5."""
    rng = np.random.default_rng(B)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)
    h = t(rng.standard_normal((B, 2, nL, n_re)))
    w = t(0.1 * rng.standard_normal((len(slices), n_re, n_sc)))
    ph = rng.uniform(-np.pi, np.pi, (B, 14))
    rot = t(np.stack([np.cos(ph), np.sin(ph)], 1))
    got, lp = fill_model(h, w, rot, slices, 132)
    want = k2.fused_fill_rotate_serve_plain(h, w, rot, slices)
    assert rel(got.numpy(), want.numpy()) <= 1e-5, (label, lp)


def test_fill_plan_and_refusals():
    c2 = k2.chunks_of(((0, 2), (2, 4)), 4, 2)
    assert c2 == [(0, 0, 2), (1, 2, 2)]
    assert k2.chunks_of(((0, 2), (2, 3)), 3, 2) == [(0, 0, 2), (1, 2, 1)]
    lp = k2.launch_plan(128, c2, 636, 1272, 132)
    assert lp.tiles == 2 * 8 * 10 and lp.smem == k2.SMEM
    assert lp.KS * lp.clusters == lp.blocks and lp.clusters <= lp.tiles
    c3 = k2.launch_plan(16, k2.chunks_of(None, 1, 1), 1638, 3276, 132)
    assert c3.tiles == 26 and c3.KS > 1 and c3.KS * c3.tiles >= 132
    with pytest.raises(ValueError, match="layer_slices"):
        k2.chunks_of(tuple((l, l + 1) for l in range(17)), 17, 17)  # 17 chunks > 16
    with pytest.raises(ValueError, match="do not cover"):
        k2.chunks_of(((0, 2),), 4, 1)
    with pytest.raises(ValueError):
        k2.launch_plan(0, c2, 636, 1272, 132)


@pytest.mark.parametrize("label,B,nL,n_re,n_sc,slices,n_sym,grid_sym,sy0", [
    ("c2", 40, 4, 636, 1272, ((0, 2), (2, 4)), 14, 14, 0),
    ("nL=3", 17, 3, 636, 1272, ((0, 2), (2, 3)), 14, 14, 0),
    ("c4 second hop", 256, 1, 144, 288, ((0, 1),), 7, 14, 7),
    ("c3 operator", 16, 1, 1638, 3276, ((0, 1),), 14, 14, 0),
])
def test_k6_kernel_order_model_matches_plain(label, B, nL, n_re, n_sc, slices, n_sym, grid_sym,
                                             sy0):
    """K6's order of summation (P-problem tiles, the product once per CDM
    group, K split over a cluster where the plan asks for it) and its
    reference-layout epilogue, written at (sc0, sy0) into a larger grid, stay
    within chip_smoke phase 9's bound of the plain version, relative 1e-5,
    and leave the rest of the grid as it was."""
    rng = np.random.default_rng(B + nL)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)
    h = t(rng.standard_normal((B, 2, nL, n_re)))
    w = t(0.1 * rng.standard_normal((len(slices), n_re, n_sc)))
    ph = rng.uniform(-np.pi, np.pi, (B, n_sym))
    rot = t(np.stack([np.cos(ph), np.sin(ph)], 1))
    sc0 = 12
    grid = torch.full((B, 2, n_sc + 20, grid_sym, nL), 5.0)
    got, lp = fill_model(h, w, rot, slices, 132, layout="ref", grid=grid, sc0=sc0, sy0=sy0)
    assert got is grid
    want = k6.fused_fill_rotate_plain(h, w, rot, slices)
    blk = grid[:, :, sc0:sc0 + n_sc, sy0:sy0 + n_sym]
    assert rel(blk.numpy(), want.numpy()) <= 1e-5, (label, lp)
    assert (grid[:, :, :sc0] == 5).all() and (grid[:, :, sc0 + n_sc:] == 5).all()
    assert (grid[:, :, :, :sy0] == 5).all() and (grid[:, :, :, sy0 + n_sym:] == 5).all()
    assert lp.KS > 1, lp  # each case splits K over a cluster


def test_k6_plan_and_refusals():
    c2 = k6.fill_chunks(((0, 2), (2, 4)), 4, 2)
    assert c2 == [(0, 0, 2), (1, 2, 2)]
    assert k6.fill_chunks(((0, 4), (4, 8)), 8, 2) == [(0, 0, 4), (1, 4, 4)]
    assert k6.fill_chunks(((0, 8),), 8, 1) == [(0, 0, 8)]
    lp = k6.launch_plan(128, 4, c2, 636, 1272, 14, 132)
    # 16 problems x 2 layers x re/im = 64 rows a group; ring 48 KB + sums 64 KB,
    # two blocks an SM within 228 KB
    assert (lp.P, lp.tiles, lp.KS, lp.clusters, lp.blocks) == (16, 80, 2, 80, 160), lp
    assert lp.smem == 49152 + 65536 and 2 * (lp.smem + 1024) <= 233472
    for nL, slices in ((1, ((0, 1),)), (3, ((0, 2), (2, 3))), (8, ((0, 4), (4, 8))), (8, ((0, 8),)),
                       (5, ((0, 2), (2, 4), (4, 5)))):
        chunks = k6.fill_chunks(slices, nL, len(slices))
        for B in (1, 15, 16, 17, 256):
            p = k6.launch_plan(B, nL, chunks, 636, 1272, 14, 132)
            assert 1 <= p.P <= B and 2 * p.P * max(n for _, _, n in chunks) <= 64
            assert p.smem <= k6.BLOCK_SMEM and p.KS * p.clusters == p.blocks
            assert -(-p.P // max(p.KS, 2)) * 2 * nL * 128 * 4 <= k2.RING  # a share fits the ring
    with pytest.raises(ValueError, match="layers"):
        k6.launch_plan(4, 9, [(0, 0, 9)], 636, 1272, 14, 132)
    with pytest.raises(ValueError, match="chunks"):
        k6.launch_plan(4, 8, [(0, l % 8, 1) for l in range(17)], 636, 1272, 14, 132)
    with pytest.raises(ValueError, match="cover"):
        k6.launch_plan(4, 4, [(0, 0, 2), (1, 1, 2)], 636, 1272, 14, 132)
    with pytest.raises(ValueError, match="symbols"):
        k6.launch_plan(4, 4, c2, 636, 1272, 33, 132)
    with pytest.raises(ValueError):
        k6.launch_plan(0, 4, c2, 636, 1272, 14, 132)


# ---------------------------------------------------------------------------
# front_finish: the fused front's finish, against the arithmetic it replaced
# ---------------------------------------------------------------------------

FINISH_CASES = [
    ("nL1", dict(n_prbs=8, n_layers=1)),
    ("nL2_two_hops", dict(n_prbs=8, n_layers=2, two_hops=True)),
    ("nL3", dict(n_prbs=10, n_layers=3)),
    ("nL4_cfo_off", dict(n_prbs=12, n_layers=4, cfo_compensate=False)),
    ("nL8_comb4", dict(n_prbs=8, n_layers=8, comb=4)),
    ("nL1_one_dmrs_sym", dict(n_prbs=8, n_layers=1, n_dmrs_syms=1)),
    ("nL2_two_hops_first_without_cfo", dict(n_prbs=8, n_layers=2, two_hops=True, n_dmrs_syms=3)),
    ("nL3_two_hops_no_cfo_offset", dict(n_prbs=6, n_layers=3, two_hops=True, n_dmrs_syms=2,
                                        prb_start=2, n_prb_total=20)),
]


def finish_inputs(kw, dtype, batch=3, seed=0):
    """A plan of a synthetic case and K1-shaped outputs of each of its hops:
    (plan, pt, hops, h_s, sc, n_sc)."""
    case = synthetic.make_case(seed=5, **kw)
    plan = make_plan(case.hop1, case.hop2, case.config, kw["n_layers"])
    pt = plan_tensors(plan, "cpu", dtype)
    hops = [hp for hp in (plan.hop1, plan.hop2) if hp is not None]
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    h_s = [t(rng.standard_normal((batch, 2, plan.n_layers, hp.n_re))) for hp in hops]
    sc = [t(np.concatenate([rng.uniform(-0.05, 0.05, (batch, 1)),  # cfo (of the scs)
                            rng.uniform(-2e-6, 2e-6, (batch, 1)),  # ta (s)
                            rng.uniform(0.5, 50.0, (batch, 3)),  # noise, rsrp, epre sums
                            np.zeros((batch, 3))], axis=1)) for _ in hops]
    return plan, pt, hops, h_s, sc, case.received_rg.shape[0]


def finish_as_before(plan, pt, hops, h_s, sc, n_sc, profiles):
    """The finish as `_front_pallas_batched` computed it before `front_finish`:
    the scalars in plain torch and, for the factored layout, one dense product
    a CDM group by the plan's interpolation operator into a zero array."""
    config, nL = plan.config, plan.n_layers
    B, dt, n_sym = sc[0].shape[0], sc[0].dtype, 14
    zeros = torch.zeros(B, dtype=dt)
    epre, noise, rsrp, ta = zeros, zeros, zeros, zeros
    cfo = None
    for hp, s in zip(hops, sc):
        ta, noise, rsrp, epre = ta + s[:, 1], noise + s[:, 2], rsrp + s[:, 3], epre + s[:, 4]
        if hp.cfo_possible:
            cfo = s[:, 0] if cfo is None else (cfo + s[:, 0]) / 2.0
    rsrp = rsrp / plan.n_pilots / nL
    epre = epre / plan.n_pilots
    noise = noise / plan.noise_den
    if len(hops) == 2:
        ta = ta / 2.0
    cfo_hz = cfo * config.scs_hz if cfo is not None else torch.full_like(zeros, math.nan)
    if config.cfo_compensate and cfo is not None:
        phase = (2.0 * math.pi) * cfo[:, None] * pt["sst"][None, :]
        rot = torch.stack([torch.cos(phase), torch.sin(phase)], dim=1)
    else:
        rot = torch.stack([torch.ones(B, n_sym, dtype=dt), torch.zeros(B, n_sym, dtype=dt)], 1)
    prof = None
    if profiles:
        prof = torch.zeros((B, 2, len(hops), nL, n_sc), dtype=dt)
        for h, (hp, ht, hs) in enumerate(zip(hops, pt["hops"], h_s)):
            for c, (l0, l1) in enumerate(hp.layer_slices):
                full = torch.matmul(hs[:, :, l0:l1].contiguous(), ht["interp"][c])
                prof[:, :, h, l0:l1, hp.sc_start : hp.sc_start + hp.n_sc_hop] = full
    return prof, rot, noise, rsrp, epre, ta, cfo_hz


def run_finish(fn, plan, pt, hops, h_s, sc, n_sc, profiles):
    taps = [ht["taps"] for ht in pt["hops"]] if profiles else None
    return fn(h_s, sc, taps, pt["sst"], sc_starts=[hp.sc_start for hp in hops],
              cfo_possible=[hp.cfo_possible for hp in hops], n_sc=n_sc, n_sym=14,
              n_pilots=plan.n_pilots, noise_den=plan.noise_den, scs_hz=plan.config.scs_hz,
              cfo_compensate=plan.config.cfo_compensate)


@pytest.mark.parametrize("route", ["profiles", "scalars"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13), (torch.float32, 1e-6)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name,kw", FINISH_CASES, ids=[c[0] for c in FINISH_CASES])
def test_front_finish_plain_matches_the_dense_finish(name, kw, dtype, tol, route):
    """`front_finish_plain` against the arithmetic it replaced: the profiles
    (a two-tap gather against the dense product, the band placed into zeros),
    the rotation and the five scalars; NaN CFO where no hop estimates it."""
    args = finish_inputs(kw, dtype)
    profiles = route == "profiles"
    got = run_finish(kf.front_finish_plain, *args, profiles)
    want = finish_as_before(*args, profiles)
    if profiles:
        assert got[0].shape == want[0].shape and got[0].dtype == dtype
        assert rel(got[0], want[0]) <= tol, rel(got[0], want[0])
        outside = want[0] == 0
        assert torch.equal(got[0][outside], want[0][outside])  # zeros outside the band
    else:
        assert got[0] is None
    assert got[1].shape == want[1].shape and rel(got[1], want[1]) <= tol
    for g, w, field in zip(got[2:], want[2:], ("noise", "rsrp", "epre", "ta", "cfo_hz")):
        assert g.shape == w.shape and g.dtype == dtype, field
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=tol, atol=0, equal_nan=True,
                                   err_msg=field)
    plan, hops = args[0], args[2]
    assert torch.isnan(got[6]).all() == (not any(hp.cfo_possible for hp in hops))
    no_rotation = not (plan.config.cfo_compensate and any(hp.cfo_possible for hp in hops))
    assert no_rotation == (torch.equal(got[1][:, 0], torch.ones_like(got[1][:, 0]))
                           and torch.equal(got[1][:, 1], torch.zeros_like(got[1][:, 1])))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name,kw", [FINISH_CASES[i] for i in (1, 2, 4, 7)],
                         ids=[FINISH_CASES[i][0] for i in (1, 2, 4, 7)])
def test_front_finish_taps_rebuild_the_operator_exactly(name, kw, dtype):
    """The two-tap tables scattered back, w_l at (left, j) and w_r at
    (right, j), give the operator `plan_tensors` holds, bit for bit: the
    kernel sums exactly its nonzero terms."""
    plan, pt, hops, *_ = finish_inputs(kw, dtype)
    for hp, ht in zip(hops, pt["hops"]):
        t = ht["taps"]
        n_cdm, n_sc_hop = t["left"].shape
        assert t["left"].dtype == t["right"].dtype == torch.int32
        assert t["w_l"].dtype == t["w_r"].dtype == dtype
        op = torch.zeros((n_cdm, hp.n_re, n_sc_hop), dtype=dtype)
        c = torch.arange(n_cdm)[:, None].expand(n_cdm, n_sc_hop)
        j = torch.arange(n_sc_hop)[None, :].expand(n_cdm, n_sc_hop)
        op.index_put_((c, t["left"].long(), j), t["w_l"], accumulate=True)
        op.index_put_((c, t["right"].long(), j), t["w_r"], accumulate=True)
        assert torch.equal(op, ht["interp"])
        both = t["left"] == t["right"]
        assert torch.equal(t["w_r"][both], torch.zeros_like(t["w_r"][both]))


def test_front_finish_wrapper_takes_plain_version_on_cpu():
    args = finish_inputs(FINISH_CASES[1][1], torch.float32)
    n0, r0 = kf.launches, dict(kf.route_launches)
    for profiles in (True, False):
        got = run_finish(kf.front_finish, *args, profiles)
        want = run_finish(kf.front_finish_plain, *args, profiles)
        for g, w in zip(got, want):
            assert (g is None and w is None) or torch.equal(g, w)
    assert (kf.launches, kf.route_launches) == (n0, r0)  # plain versions never count
    plan, pt, hops, h_s, sc, n_sc = args
    with pytest.raises(ValueError, match="CPU .plain. or CUDA"):
        run_finish(kf.front_finish, plan, pt, hops, [h.to("meta") for h in h_s], sc, n_sc, True)


TAPS_CASES = [
    ("k1_one_hop", dict(n_prbs=8, n_layers=2), True),
    ("k1_two_hops_offset", dict(n_prbs=6, n_layers=3, two_hops=True, n_dmrs_syms=2,
                                prb_start=2, n_prb_total=20), True),
    # no fused smoothing matrix past 1,024 pilot REs: K1's banded route takes it
    ("wide_no_fused_smoothing", dict(n_prbs=273, n_layers=1), True),
    ("mean_smoothing", dict(n_prbs=8, n_layers=2, smoothing="mean"), False),
    ("time_interpolation", dict(n_prbs=8, n_layers=1, time_interp="linear", doppler_hz=300.0),
     False),
    ("cnn_interpolation", dict(n_prbs=8, n_layers=1, interp="cnn"), False),
]


@pytest.mark.parametrize("name,kw,two_tap", TAPS_CASES, ids=[c[0] for c in TAPS_CASES])
def test_plan_tensors_build_taps_only_for_plans_the_fused_front_takes(name, kw, two_tap):
    """The two-tap tables exist exactly where the fused front (K1) takes a
    linear-interpolation plan, the one tier whose finish reads them, and lie
    on the whole-PRB grid the kernel's 16-byte loads and stores need; a
    caller that never launches K1 (the receiver, `k1=False`) gets none."""
    case = synthetic.make_case(seed=5, **kw)
    plan = make_plan(case.hop1, case.hop2, case.config, kw["n_layers"])
    assert two_tap == (case.config.interp == "linear" and port_est._front_pallas_ok(plan))
    pt = plan_tensors(plan, "cpu", torch.float32)
    assert all(ht["taps"] is None for ht in plan_tensors(plan, "cpu", torch.float32, k1=False)["hops"])
    hops = [hp for hp in (plan.hop1, plan.hop2) if hp is not None]
    for hp, ht in zip(hops, pt["hops"]):
        if not two_tap:
            assert ht["taps"] is None
            continue
        assert set(ht["taps"]) == {"left", "right", "w_l", "w_r"}
        assert ht["taps"]["left"].shape == (hp.n_cdm, hp.n_sc_hop)
        assert hp.sc_start % 4 == 0 and hp.n_sc_hop % 4 == 0
        assert case.received_rg.shape[0] % 4 == 0
