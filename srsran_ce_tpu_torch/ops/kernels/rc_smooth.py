"""K5 — the RC smoothing FIR along the pilot axis: `rc_smooth`.

Replaces the TPU kernel `srsran_ce_tpu/ops/pallas/kernels.py:rc_smooth`
(`_rc_smooth_kernel`): the valid K-tap convolution

    out[b, c, n] = sum_k taps[K-1-k] * x[b, c, n+k]

over (B, C, n_ext) real rows, where the caller stacks re/im and layers (and,
with time interpolation, the DM-RS symbols) into C. `models.estimator._smooth`
reaches it for `kernels="pallas"` with filter smoothing.

CUDA kernel (csrc/rc_smooth.cu): one block per tile of 4 T outputs of a
row (T threads, a multiple of 32 up to 256, so a c2 row of 636 outputs is
one 160-thread tile and 1024 rows fill the 132 SMs in one wave), the tile
and its K - 1 halo staged in shared memory by coalesced loads, each thread
4 consecutive outputs from a register window of its K + 3 inputs read as
16-byte vectors (no bank conflicts), stored as one vector where the row
allows; taps by value in the launch arguments (K <= 15 at every plan
geometry; the kernel takes up to 32). What bounds it on the H100: the
bytes, one read and one write of the rows (c2 at batch 128: 8 rows of 650
in, 636 out, 5.3 MB in all, 1.6 us at 3.35 TB/s); at that size the launch
is most of its time. The wrapper keeps its host path short: the reversed
taps struct is cached per taps, the C entry bound once, and the device
switched only when it is not current.

Sum order: the TPU kernel's, taps[K-1] * x[n] first; the kernel folds each
further tap with an FMA, the plain version rounds the product and the sum
apart, so the two differ by an ulp or so.
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

_MAX_TAPS = 32
_PTR = ctypes.c_void_p


class _RcTaps(ctypes.Structure):
    """struct RcTaps of csrc/rc_smooth.cu: the taps in convolution order."""

    _fields_ = [("k", ctypes.c_int), ("t", ctypes.c_float * _MAX_TAPS)]


_ARGTYPES = [_PTR, _PTR, ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(_RcTaps), _PTR]


def rc_smooth_plain(x_ext_ri: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Plain PyTorch version: (B, C, n_ext) -> (B, C, n_ext - K + 1), the same
    shifted adds in the same order (`dsp.conv_valid`)."""
    return dsp.conv_valid(x_ext_ri, taps)


@functools.lru_cache(maxsize=64)
def _taps_struct_of(key: bytes) -> _RcTaps:
    taps = np.frombuffer(key, dtype=np.float64)
    tab = _RcTaps()
    tab.k = taps.size
    tab.t[: taps.size] = taps[::-1].astype(np.float32).tolist()
    return tab


def taps_struct(taps: np.ndarray) -> _RcTaps:
    """The kernel's taps argument: K and the taps reversed into convolution
    order in float32, cached per taps (keyed by their float64 bytes), so
    equal taps share one struct and no Python loop runs per call."""
    taps = np.ascontiguousarray(taps, dtype=np.float64).reshape(-1)
    if not 1 <= taps.size <= _MAX_TAPS:
        raise ValueError(f"kernel takes 1..{_MAX_TAPS} taps, got K={taps.size}")
    return _taps_struct_of(taps.tobytes())


def rc_smooth(x_ext_ri: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Valid K-tap convolution along the last axis of (B, C, n_ext) real rows.
    CPU tensors go through the plain version; CUDA tensors launch the kernel."""
    if x_ext_ri.device.type == "cpu":
        return rc_smooth_plain(x_ext_ri, taps)
    if x_ext_ri.device.type != "cuda":
        raise ValueError(f"rc_smooth runs on CPU or CUDA tensors, not {x_ext_ri.device}")
    device = check_cuda_f32(x_ext_ri=x_ext_ri)
    if x_ext_ri.dim() != 3:
        raise ValueError(f"x_ext_ri must be (B, C, n_ext), got {tuple(x_ext_ri.shape)}")
    tab = taps_struct(taps)
    B, C, n_ext = x_ext_ri.shape
    if n_ext < tab.k or B * C < 1:
        raise ValueError(f"kernel takes rows of at least K values, "
                         f"got K={tab.k}, x {tuple(x_ext_ri.shape)}")
    out = torch.empty((B, C, n_ext - tab.k + 1), dtype=torch.float32, device=device)
    launch("rc_smooth", bind("rc_smooth", "srs_rc_smooth_f32", _ARGTYPES), device,
           x_ext_ri.data_ptr(), out.data_ptr(), B * C, n_ext, tab)
    global launches
    launches += 1
    return out
