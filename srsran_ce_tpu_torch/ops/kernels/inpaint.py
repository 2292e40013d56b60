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

CUDA kernel (csrc/inpaint.cu): the row in registers, S consecutive cells
per thread (S a template parameter), neighbours by warp shuffles, each
cell's pin an all-ones / all-zeros word in a register. Rows of up to 512
values run one row per warp (four per block) with no block barrier. Longer
rows run one block per row, each warp's window overlapping its neighbours'
by one lane (H = S cells) on each side, so a warp runs H passes on shuffles
alone before one `__syncthreads()` swaps the boundary cells through shared
memory. ROUTES below is the route table: the first route whose capacity
holds n runs. What bounds it on the H100: neither bytes nor operations. Its
passes are a chain of dependent steps (411 at 273 PRB), each ~4
instructions a cell, so one block a row is bound by the instruction rate of
the SM that holds the row (c3 has 32 rows, so 32 of the 132 SMs work); the
bound from bytes and operations is far below its time.

The steady passes leave out the plain version's product by 1 / (1 + eps):
in float32 that factor is 1.0, and x * 1 is x.

Sum order: 0.25 left + 0.5 middle + 0.25 right, each sum rounded apart
(the products by 1/4 and 1/2 are exact for normal floats, so the kernel's
FMAs round where the separate product and add do); the transient product x
* m comes first and the reciprocal denominator last, as in the plain
version. Kernel and plain version agree bit for bit barring subnormals.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import dsp
from . import bind, check_cuda_f32, launch

#: kernel launches since the count was last set to 0 (incremented only where
#: the CUDA kernel is launched, never by the plain version)
launches = 0

_EPS = 1e-12
_PTR = ctypes.c_void_p
_ARGTYPES = [_PTR, _PTR, _PTR, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, _PTR, _PTR]
_BLOCK_WARPS = 16  # csrc/inpaint.cu kMaxBlockThreads / 32

#: the route table of csrc/inpaint.cu kRoutes, in its order: (cells per
#: thread S, halo lanes). Halo 0: one row per warp, 32 S cells; halo 1: one
#: block of up to 16 warps per row, (32 - 2) S cells a warp.
ROUTES = ((1, 0), (2, 0), (3, 0), (4, 0), (5, 0), (6, 0), (8, 0), (10, 0), (12, 0), (16, 0),
          (8, 1), (16, 1))


def capacity(route: int) -> int:
    """Cells of a row that route `route` holds."""
    s, halo = ROUTES[route]
    return _BLOCK_WARPS * (32 - 2 * halo) * s if halo else 32 * s


#: the longest row any route holds
MAX_N = max(capacity(r) for r in range(len(ROUTES)))


def route_for(n: int) -> int:
    """The first route of ROUTES whose capacity holds a row of n values;
    raises for a row that none holds."""
    if 3 <= n <= MAX_N:
        for r in range(len(ROUTES)):
            if capacity(r) >= n:
                return r
    raise ValueError(f"kernel takes rows of 3..{MAX_N} values, got {n}")


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


def inpaint_stack(x_ri: torch.Tensor, known_mask, n_iters: int, schedule=None) -> torch.Tensor:
    """Partial-conv inpainting of (B, C, n) real rows, the signature of the JAX
    `inpaint_stack`: `known_mask` (n,) bool, `n_iters` the chain length,
    `schedule` the precomputed (transient, steady) pair or None. CPU tensors
    go through the plain version; CUDA tensors launch the kernel (float32,
    contiguous, 3 <= n <= MAX_N) or raise."""
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
    if B * C < 1:
        raise ValueError(f"kernel takes B*C >= 1, got x {tuple(x_ri.shape)}")
    route = route_for(n)
    if schedule is None:
        known_t, trans_t, n_transient, steady = _tables(known.tobytes(), int(n_iters), device)
    else:
        known_t, trans_t, n_transient, steady = _device_tables(known, schedule, device)
    out = torch.empty_like(x_ri)
    launch("inpaint_stack", bind("inpaint", "srs_inpaint_f32", _ARGTYPES), device,
           x_ri.data_ptr(), known_t.data_ptr(), trans_t.data_ptr(), B * C, n, n_transient,
           steady, route, out.data_ptr())
    global launches
    launches += 1
    return out
