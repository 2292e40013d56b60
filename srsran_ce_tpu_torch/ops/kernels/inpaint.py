"""K7 — the partial-convolution inpainting stack: `inpaint_stack`.

Replaces the TPU kernel `srsran_ce_tpu/ops/pallas/kernels.py:inpaint_stack`
(`_inpaint_kernel`): over (B, C, n) real rows (C = 2 nL ri channels, zeros at
the unknown positions), the transient masked iterations of the static
schedule (`dsp.make_inpaint_schedule`), `steady` fixed-point passes of the
reflect-padded [1/4, 1/2, 1/4] convolution, a 2-pass low-pass, the known
positions pinned to their input values throughout.

As in the JAX package, no path of the estimator calls it: the `interp="cnn"`
fill takes `dsp.cnn_inpaint` for chains of at most 16 iterations and the
exact operator matmul beyond. It is the standalone conv-stack counterpart,
held against its plain version.

CUDA kernel (csrc/inpaint.cu): one 256-thread block per row; the row and the
next pass in shared memory (2 n floats, 26 KB at n = 3276) beside the known
mask (n bytes); the per-iteration (mask, reciprocal denominator) rows read
from global memory, where they stay in L2; each pass one `__syncthreads()`
apart. What bounds it on the H100: neither bytes nor operations — its
passes are a chain of dependent steps (409 at 273 PRB), each a block-wide
barrier, so it is latency-bound; the bound computed from bytes and
operations is far below its time.

Sum order: 0.25 left + 0.5 middle + 0.25 right, each product and sum
rounded apart (the products by 1/4 and 1/2 are exact, so no FMA contraction
could move a bit); the transient product x * m comes first and the
reciprocal denominator last, as in the plain version. Kernel and plain
version agree bit for bit barring subnormals.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import dsp
from . import _build, check_cuda_f32

#: kernel launches since the count was last set to 0 (incremented only where
#: the CUDA kernel is launched, never by the plain version)
launches = 0

_EPS = 1e-12
_PTR = ctypes.c_void_p
_ARGTYPES = [_PTR, _PTR, _PTR, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, _PTR, _PTR]
#: a block's shared memory limit on the H100 (227 KB opt-in)
SMEM_LIMIT = 232448


def inpaint_stack_plain(x_ri: torch.Tensor, known_mask, n_iters: int, schedule=None) -> torch.Tensor:
    """Plain PyTorch version: `dsp.cnn_inpaint` over the rows of (B, C, n),
    the same eps, 1/(den + eps) and 1/(1 + eps). With every position known the
    kernel's result is the input (all pinned), which `cnn_inpaint` special-
    cases to a low-pass; the plain version follows the kernel."""
    known = np.asarray(known_mask, dtype=bool).reshape(-1)
    if known.all():
        return x_ri.clone()
    return dsp.cnn_inpaint(x_ri, known, n_iters, schedule=schedule)


def _device_tables(known: np.ndarray, schedule, device):
    """(known (n,) f32, trans (max(n_transient, 1), 2, n) f32 of (m_t, 1 / (den_t +
    eps)) rows, n_transient, steady) on `device`, as kernels.py:861-871 builds
    them."""
    transient, steady = schedule
    n = known.size
    trans = (
        np.stack([np.stack([m, 1.0 / (d + _EPS)]) for m, d in transient]).astype(np.float32)
        if transient else np.zeros((1, 2, n), np.float32)
    )
    return (torch.as_tensor(known.astype(np.float32), device=device),
            torch.as_tensor(trans, device=device), len(transient), int(steady))


@functools.lru_cache(maxsize=64)
def _tables(known_key: bytes, n_iters: int, device):
    known = np.frombuffer(known_key, dtype=bool)
    return _device_tables(known, dsp.make_inpaint_schedule(known, n_iters), device)


def _lib():
    fn = _build.load("inpaint").srs_inpaint_f32
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def inpaint_stack(x_ri: torch.Tensor, known_mask, n_iters: int, schedule=None) -> torch.Tensor:
    """Partial-conv inpainting of (B, C, n) real rows, the signature of the JAX
    `inpaint_stack`: `known_mask` (n,) bool, `n_iters` the chain length,
    `schedule` the precomputed (transient, steady) pair or None. CPU tensors
    go through the plain version; CUDA tensors launch the kernel (float32,
    contiguous, n >= 3) or raise."""
    if x_ri.device.type == "cpu":
        return inpaint_stack_plain(x_ri, known_mask, n_iters, schedule)
    if x_ri.device.type != "cuda":
        raise ValueError(f"inpaint_stack runs on CPU or CUDA tensors, not {x_ri.device}")
    device = check_cuda_f32(x_ri=x_ri)
    if x_ri.dim() != 3:
        raise ValueError(f"x_ri must be (B, C, n), got {tuple(x_ri.shape)}")
    B, C, n = x_ri.shape
    known = np.asarray(known_mask, dtype=bool).reshape(-1)
    if known.size != n:
        raise ValueError(f"known_mask has {known.size} entries, x_ri rows {n}")
    smem = 2 * n * 4 + -(-n // 4) * 4
    if n < 3 or B * C < 1 or smem > SMEM_LIMIT:
        raise ValueError(f"kernel takes rows of 3..{(SMEM_LIMIT * 4) // 9} values and B*C >= 1, "
                         f"got x {tuple(x_ri.shape)}")
    if schedule is None:
        known_t, trans_t, n_transient, steady = _tables(known.tobytes(), int(n_iters), device)
    else:
        known_t, trans_t, n_transient, steady = _device_tables(known, schedule, device)
    out = torch.empty_like(x_ri)
    fn = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(x_ri.data_ptr(), known_t.data_ptr(), trans_t.data_ptr(), B * C, n,
                n_transient, steady, float(np.float32(1.0 / (1.0 + _EPS))),
                out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"inpaint_stack kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out
