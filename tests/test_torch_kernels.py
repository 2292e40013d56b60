"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version (CPU tensors never reach
a CUDA kernel), so these tests hold `fused_front_plain`,
`fused_fill_rotate_serve_plain`, `rc_smooth_plain` and
`fused_fill_rotate_plain` against `srsran_ce_tpu.ops.pallas.kernels` run in
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
The CUDA kernels themselves are held against their plain versions on the card
by tests/test_torch_gpu.py (no JAX there) and chip_smoke.py.
"""
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


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert not (tmp_path / "build").exists()
