"""K5 — the RC smoothing FIR along the pilot axis: `rc_smooth`.

Replaces the TPU kernel `srsran_ce_tpu/ops/pallas/kernels.py:rc_smooth`
(`_rc_smooth_kernel`): the valid K-tap convolution

    out[b, c, n] = sum_k taps[K-1-k] * x[b, c, n+k]

over (B, C, n_ext) real rows, where the caller stacks re/im and layers (and,
with time interpolation, the DM-RS symbols) into C. `models.estimator._smooth`
reaches it for `kernels="pallas"` with filter smoothing.

CUDA kernel (csrc/rc_smooth.cu): one thread per output element over
(B, C, n_out), taps passed by value in the launch arguments (K <= 15 at every
plan geometry; the kernel takes up to 32). Neighbouring threads read
neighbouring inputs, so each warp's K loads hit the same few L1 lines. What
bounds it on the H100: the bytes, one read and one write of the rows (c2 at
batch 128: 8 rows of 650 in, 636 out, 5.3 MB in all, under 2 us at
3.35 TB/s); at that size the launch itself is most of its time.

Sum order: the TPU kernel's, taps[K-1] * x[n] first; the kernel folds each
further tap with an FMA, the plain version rounds the product and the sum
apart, so the two differ by an ulp or so.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import dsp
from . import _build, check_cuda_f32

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


def _lib():
    fn = _build.load("rc_smooth").srs_rc_smooth_f32
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def rc_smooth(x_ext_ri: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Valid K-tap convolution along the last axis of (B, C, n_ext) real rows.
    CPU tensors go through the plain version; CUDA tensors launch the kernel."""
    if x_ext_ri.device.type == "cpu":
        return rc_smooth_plain(x_ext_ri, taps)
    if x_ext_ri.device.type != "cuda":
        raise ValueError(f"rc_smooth runs on CPU or CUDA tensors, not {x_ext_ri.device}")
    device = check_cuda_f32(x_ext_ri=x_ext_ri)
    taps = np.asarray(taps, dtype=np.float64).reshape(-1)
    K = taps.size
    if x_ext_ri.dim() != 3:
        raise ValueError(f"x_ext_ri must be (B, C, n_ext), got {tuple(x_ext_ri.shape)}")
    B, C, n_ext = x_ext_ri.shape
    if not 1 <= K <= _MAX_TAPS or n_ext < K or B * C < 1:
        raise ValueError(f"kernel takes 1..{_MAX_TAPS} taps over rows of at least K, "
                         f"got K={K}, x {tuple(x_ext_ri.shape)}")
    tab = _RcTaps()
    tab.k = K
    for i, t in enumerate(taps[::-1]):
        tab.t[i] = float(t)
    out = torch.empty((B, C, n_ext - K + 1), dtype=torch.float32, device=device)
    fn = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(x_ext_ri.data_ptr(), out.data_ptr(), B * C, n_ext, ctypes.byref(tab), stream)
    if rc != 0:
        raise RuntimeError(f"rc_smooth kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out
