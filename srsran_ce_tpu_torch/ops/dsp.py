"""DSP primitives of the port: torch counterparts of `srsran_ce_tpu/ops/dsp.py`.

Every function works on the **last axis** and broadcasts over leading axes (the
port's estimator puts its problem axis first), on real or complex tensors of
either precision, on the tensor's own device. Convolutions are K static
shifted adds with Python-float taps, as in the JAX module, so the input dtype
is kept and the sums run in the same order.

`make_inpaint_schedule` is a numpy copy of the JAX function (held
bit-identical by tests/test_torch_plan.py); the plan builds its schedule at
plan time. `precision_of` maps the config's matmul precision names onto the
port, which runs every product in full f32 or f64.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch


def _pad_last(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Zero-pad the last axis (complex tensors included)."""
    parts = []
    if left:
        parts.append(x.new_zeros(x.shape[:-1] + (left,)))
    parts.append(x)
    if right:
        parts.append(x.new_zeros(x.shape[:-1] + (right,)))
    return torch.cat(parts, dim=-1) if len(parts) > 1 else x


def unwrap_phase(ph: torch.Tensor) -> torch.Tensor:
    """Phase unwrap along the last axis, numpy.unwrap's convention: the
    parallel prefix-sum form of the JAX function (`torch.remainder` is the
    floored modulo of `jnp.mod`)."""
    if ph.shape[-1] <= 1:
        return ph
    pi = math.pi
    dd = ph[..., 1:] - ph[..., :-1]
    ddmod = torch.remainder(dd + pi, 2.0 * pi) - pi
    ddmod = torch.where((ddmod == -pi) & (dd > 0), ddmod + 2.0 * pi, ddmod)
    correction = torch.where(dd.abs() < pi, torch.zeros_like(dd), ddmod - dd)
    cum = torch.cumsum(correction, dim=-1)
    return ph + _pad_last(cum, 1, 0)


def conv_same_zero(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """MATLAB conv(x, h, 'same') with zero padding, odd-length static real taps."""
    taps = np.asarray(taps)
    K = taps.size
    if K % 2 != 1:
        raise ValueError("conv_same_zero expects odd-length taps")
    if K == 1:
        return x * float(taps[0])
    N = x.shape[-1]
    p = (K - 1) // 2
    xp = _pad_last(x, p, p)
    flipped = [float(t) for t in taps[::-1]]
    y = flipped[0] * xp[..., 0:N]
    for k in range(1, K):
        y = y + flipped[k] * xp[..., k : k + N]
    return y


def conv_valid(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """'valid' convolution along the last axis: (..., N) -> (..., N-K+1)."""
    taps = np.asarray(taps)
    K = taps.size
    N = x.shape[-1]
    if N < K:
        raise ValueError(f"conv_valid needs input >= taps ({N} < {K})")
    flipped = [float(t) for t in taps[::-1]]
    M = N - K + 1
    y = flipped[0] * x[..., 0:M]
    for k in range(1, K):
        y = y + flipped[k] * x[..., k : k + M]
    return y


def _reflect_pad_1(x: torch.Tensor) -> torch.Tensor:
    """Reflect-pad the last axis by 1 on each side (replicate for length 1)."""
    if x.shape[-1] == 1:
        return torch.cat([x, x, x], dim=-1)
    return torch.cat([x[..., 1:2], x, x[..., -2:-1]], dim=-1)


def conv3_reflect(x: torch.Tensor, taps: Sequence[float] = (0.25, 0.5, 0.25)) -> torch.Tensor:
    """3-tap 'same' convolution with reflect padding (the CNN building block)."""
    a, b, c = float(taps[2]), float(taps[1]), float(taps[0])  # flipped for convolution
    xp = _reflect_pad_1(x)
    N = x.shape[-1]
    return a * xp[..., 0:N] + b * xp[..., 1 : N + 1] + c * xp[..., 2 : N + 2]


def cnn_lowpass(x: torch.Tensor, passes: int = 2) -> torch.Tensor:
    """`passes` x [0.25, 0.5, 0.25] smoothing (identity for length <= 2)."""
    if x.shape[-1] <= 2:
        return x
    y = x
    for _ in range(max(1, int(passes))):
        y = conv3_reflect(y)
    return y


def make_inpaint_schedule(known_mask: np.ndarray, n_iters: int):
    """Precompute the static mask/denominator schedule of the partial-conv inpainting.

    The reference updates its validity mask every iteration from data-independent
    quantities (ce_dl_cnn.py:473-508): m_{t+1} = max(m_t, conv(m_t, h) > eps). Since
    the seed mask is static config, the whole mask trajectory is plan-time constant —
    we precompute (m_t, den_t) per iteration in numpy.

    Returns list of (m_t, den_t) float64 numpy arrays, each shape (n,).
    """
    h = np.array([0.25, 0.5, 0.25])
    eps = 1e-12
    m = np.asarray(known_mask, dtype=np.float64).reshape(-1)
    n = m.size

    def conv_reflect_np(v):
        if n == 1:
            vp = np.array([v[0], v[0], v[0]])
        else:
            vp = np.concatenate([v[1:2], v, v[-2:-1]])
        return np.convolve(vp, h, mode="valid")

    schedule = []
    steady = 0
    total = max(1, int(n_iters))
    for it in range(total):
        den = conv_reflect_np(m)
        if m.all() and (den > eps).all():
            # Mask saturated: every remaining iteration is the identical fixed-point
            # update x = where(known, x0, conv(x)/(1+eps)); count them instead.
            steady = total - it
            break
        schedule.append((m.copy(), den))
        m = np.maximum(m, (den > eps).astype(np.float64))
    return schedule, steady


#: the deepest inpainting chain the estimator's fill runs pass by pass; a deeper
#: one runs as its operator (`inpaint_operator`)
INPAINT_CHAIN_MAX_ITERS = 16


def inpaint_consts(known_mask: np.ndarray, schedule, dtype, device):
    """The device tensors of `cnn_inpaint`'s static schedule: (known (n,)
    bool, [(m_t, 1 / (den_t + eps)) per transient iteration], 1 / (1 + eps)),
    in `dtype` on `device`. The plan builds them once (`models.plan.
    plan_tensors`), so that the call makes no tensor from host data."""
    eps = 1e-12
    known = np.array(known_mask, dtype=bool).reshape(-1)
    transient, _ = schedule
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return (
        torch.as_tensor(known, device=device),
        [(t(m_t), t(1.0 / (den_t + eps))) for m_t, den_t in transient],
        t(1.0 / (1.0 + eps)),
    )


def cnn_inpaint(
    x_sparse: torch.Tensor,  # (..., n), zeros at unknown positions
    known_mask: np.ndarray,  # (n,) bool, static
    n_iters: int,
    schedule=None,
    consts=None,
) -> torch.Tensor:
    """Partial-convolution inpainting with a static mask schedule (reference
    _cnn_inpaint_1d_complex, ce_dl_cnn.py:473-508). `consts`: the schedule's
    tensors (`inpaint_consts`), built here when not given."""
    known = np.asarray(known_mask, dtype=bool).reshape(-1)
    if known.all():
        return cnn_lowpass(x_sparse, passes=2)
    if schedule is None:
        schedule = make_inpaint_schedule(known, n_iters)
    if consts is None:
        consts = inpaint_consts(known, schedule, x_sparse.real.dtype, x_sparse.device)
    steady = schedule[1]
    known_t, transient, inv = consts
    x0 = x_sparse
    x = x_sparse
    for m_j, inv_den in transient:
        x = torch.where(known_t, x0, conv3_reflect(x * m_j) * inv_den)
    for _ in range(steady):
        x = torch.where(known_t, x0, conv3_reflect(x) * inv)
    return torch.where(known_t, x0, cnn_lowpass(x, passes=2))


def inpaint_probes(known: np.ndarray):
    """Probe groups of the operator build: (group of each known position,
    number of groups, support [lo, hi) of each row).

    Row i of the operator is the chain's response to a one at known position
    j = filled[i]. The passes pin every other known position to zero, so the
    response stays in the unknown runs on either side of j, and the final
    two-pass low-pass widens it by two: it lies in [p - 1, q + 1], p and q
    the known positions before and after j. Rows whose supports, widened by
    two more on each side, do not meet never touch each other's values, so
    one probe (their ones together) carries them all, each exactly as it
    would be alone (every value it adds to is a zero)."""
    filled = np.nonzero(known)[0]
    n = known.size
    prev = np.concatenate([[-1], filled[:-1]])
    nxt = np.concatenate([filled[1:], [n]])
    lo, hi = np.maximum(prev - 1, 0), np.minimum(nxt + 2, n)
    group = np.empty(filled.size, np.int64)
    ends: list = []  # per group, the end of its last row's keep-out window
    for i in range(filled.size):
        start = prev[i] - 3
        g = next((k for k, e in enumerate(ends) if e < start), len(ends))
        if g == len(ends):
            ends.append(0)
        ends[g] = nxt[i] + 3
        group[i] = g
    return group, len(ends), lo, hi


@functools.lru_cache(maxsize=64)
def _inpaint_operator_cached(known_key: bytes, n: int, n_iters: int, dtype, device):
    known = np.frombuffer(known_key, dtype=bool)
    filled = np.nonzero(known)[0]
    schedule = make_inpaint_schedule(known, n_iters)
    group, n_groups, lo, hi = inpaint_probes(known)
    probes = torch.zeros((n_groups, n), dtype=torch.float64, device=device)
    probes[torch.as_tensor(group, device=device), torch.as_tensor(filled, device=device)] = 1.0
    resp = cnn_inpaint(probes, known, n_iters, schedule=schedule).cpu().numpy()
    w = np.zeros((filled.size, n))
    for i in range(filled.size):
        w[i, lo[i] : hi[i]] = resp[group[i], lo[i] : hi[i]]
    return torch.as_tensor(w, device=device).to(dtype).contiguous()


def inpaint_operator(known_mask: np.ndarray, n_iters: int, dtype, device) -> torch.Tensor:
    """The (n_re, n_sc) linear operator of the whole inpainting chain, on `device`.

    The inpainting is linear in the seeded pilot values (mask schedule,
    denominators and pinning are static), so its iterations and final
    low-pass collapse into one matrix W with full = pilots @ W. W is built by
    pushing the scatter-identity basis through `cnn_inpaint` itself, once per
    (mask, iterations, dtype, device), many rows in one probe where their
    supports cannot meet (`inpaint_probes`: the same values, bit for bit). The port builds it in
    float64 and casts (the JAX package builds it in the target dtype): at c3
    (273 PRB, 409 iterations, 1638 x 3276) a float32 build would carry the
    rounding of 409 chained passes into every problem."""
    known = np.ascontiguousarray(np.asarray(known_mask, dtype=bool).reshape(-1))
    return _inpaint_operator_cached(
        known.tobytes(), known.size, int(n_iters), dtype, torch.device(device)
    )


def inpaint_matmul(values: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Apply a real operator to complex values: (..., n_re) -> (..., n_sc).
    Run it under `ops.kernels.full_f32_matmul` on the card."""
    w = w.to(values.real.dtype)
    return torch.complex(torch.matmul(values.real, w), torch.matmul(values.imag, w))


def lerp_gather(values: torch.Tensor, left, right, alpha) -> torch.Tensor:
    """Linear interpolation via static gather tables (ordinals into the last
    axis): numpy tables, or tensors on `values`' device (what a call inside a
    CUDA graph passes: no host data crosses in the call)."""
    def table(a, dtype):
        if torch.is_tensor(a):
            return a.to(dtype)
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=values.device)

    lv = values.index_select(-1, table(left, torch.int64))
    rv = values.index_select(-1, table(right, torch.int64))
    return lv + table(alpha, values.real.dtype) * (rv - lv)


def fro_norm_sq(x: torch.Tensor, batch_dims: int = 0) -> torch.Tensor:
    """||x||_F^2 over every axis after the first `batch_dims` (reference
    _fro_norm_sq, ce_rule_baseline.py:466-468). The JAX function sums over all
    axes because it runs per problem under vmap; the port's estimator keeps
    its problem axis and passes batch_dims=1."""
    dims = tuple(range(batch_dims, x.dim()))
    return torch.sum(x.abs() ** 2, dim=dims) if dims else x.abs() ** 2


#: EstimatorConfig.matmul_precision -> the precision the port's kernels take.
#: On the TPU "high" is a 3-pass bf16 split (~1e-7 relative) and "highest" a
#: 6-pass one. The port's CUDA kernels compute every product in full f32 FMA,
#: at least as accurate as either, so both map to "highest"; the plain PyTorch
#: versions run with TF32 off. "default" (one bf16 pass, ~4e-3) has no port
#: counterpart and raises.
_PRECISIONS = {"high": "highest", "highest": "highest"}


def precision_of(name: str) -> str:
    if name not in _PRECISIONS:
        raise NotImplementedError(
            f"matmul_precision={name!r} has no port counterpart (the kernels run full f32)"
        )
    return _PRECISIONS[name]
