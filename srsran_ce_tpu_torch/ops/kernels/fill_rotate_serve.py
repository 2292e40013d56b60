"""K2 — serve-layout grid fill: `fused_fill_rotate_serve`.

Replaces the TPU kernel `srsran_ce_tpu/ops/pallas/kernels.py:fused_fill_rotate_serve`
(`_fill_rotate_serve_kernel3` for equal CDM groups, `_fill_rotate_serve_kernel`
for unequal ones). It computes

    out[b, l, y, t] = (h[b, l, :] @ W_c[:, t]) * rot[b, y]     (complex, in ri)

for every layer l of CDM group c, in the subcarrier-last serve layout
(B, 2, nL, n_sym, n_sc).

CUDA kernel (csrc/fill_rotate_serve.cu): one thread block per (chunk of at most
two layers of one CDM group, 128-subcarrier tile, block of 8 problems), one
subcarrier per thread. It walks n_re in chunks of 32, staging the block's h
rows in shared memory, reads W_c straight from L2 (coalesced along the
subcarriers) and keeps the f32 sums in registers; the epilogue writes all
n_sym symbols with the CFO rotation, coalesced along the subcarrier axis.
Unequal CDM groups (nL=3: layers (0, 2), (2, 3)) come in as a table of layer
chunks, not as a second kernel. What bounds it on the H100: at c2 and batch 128
it must write 72.9 MB (about 22 us at 3.35 TB/s) and do about 1.7 GFLOP of f32
FMA (about 25 us at 67 TFLOP/s without tensor cores) — both near the card's
limits in f32, so neither is hidden behind the other yet. Tensor-core 3xTF32
and TMA stores are later changes.

Precision: full f32 FMA for both "high" and "highest" (the TPU's "high" is a
3-pass bf16 split, `kernels._dot_f32x3`, which this is at least as accurate as).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, check_cuda_f32, check_shape, full_f32_matmul

#: kernel launches since the count was last set to 0 (incremented only where
#: the CUDA kernel is launched, never by the plain version)
launches = 0

_MAX_CHUNKS = 16
_MAX_SYM = 32
_PTR = ctypes.c_void_p


class _ChunkTab(ctypes.Structure):
    """Layer chunks of at most two layers, each inside one CDM group
    (struct ChunkTab in csrc/fill_rotate_serve.cu)."""

    _fields_ = [
        ("n", ctypes.c_int),
        ("c", ctypes.c_int * _MAX_CHUNKS),
        ("l0", ctypes.c_int * _MAX_CHUNKS),
        ("nl", ctypes.c_int * _MAX_CHUNKS),
    ]


_ARGTYPES = [_PTR] * 4 + [ctypes.c_int] * 5 + [ctypes.POINTER(_ChunkTab), _PTR]


def _layer_slices(layer_slices, nL: int, n_cdm: int):
    if layer_slices is None:
        layer_slices = ((0, nL),)
    layer_slices = tuple((int(a), int(b)) for a, b in layer_slices)
    if len(layer_slices) != n_cdm or layer_slices[-1][1] != nL:
        raise ValueError(f"layer_slices {layer_slices} do not cover {nL} layers in {n_cdm} groups")
    return layer_slices


def fused_fill_rotate_serve_plain(
    h_ri: torch.Tensor,  # (B, 2, nL, n_re)
    w: torch.Tensor,  # (n_re, n_sc) or (n_cdm, n_re, n_sc)
    rot_ri: torch.Tensor,  # (B, 2, n_sym)
    layer_slices=None,
) -> torch.Tensor:
    """Plain PyTorch version: (B, 2, nL, n_sym, n_sc)."""
    B, _, nL, _ = h_ri.shape
    if w.dim() == 2:
        w = w[None]
    layer_slices = _layer_slices(layer_slices, nL, w.shape[0])
    n_sym = rot_ri.shape[2]
    out = torch.empty((B, 2, nL, n_sym, w.shape[-1]), dtype=h_ri.dtype, device=h_ri.device)
    rr = rot_ri[:, 0][:, None, :, None]  # (B, 1, n_sym, 1)
    ri = rot_ri[:, 1][:, None, :, None]
    with full_f32_matmul():
        for c, (l0, l1) in enumerate(layer_slices):
            f = torch.matmul(h_ri[:, :, l0:l1], w[c])  # (B, 2, n_lc, n_sc)
            fr = f[:, 0, :, None, :]  # (B, n_lc, 1, n_sc)
            fi = f[:, 1, :, None, :]
            out[:, 0, l0:l1] = fr * rr - fi * ri
            out[:, 1, l0:l1] = fr * ri + fi * rr
    return out


def _lib():
    fn = _build.load("fill_rotate_serve").srs_fill_rotate_serve_f32
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def fused_fill_rotate_serve(
    h_ri: torch.Tensor,
    w: torch.Tensor,
    rot_ri: torch.Tensor,
    layer_slices=None,
) -> torch.Tensor:
    """(B, 2, nL, n_sym, n_sc) interpolated, symbol-broadcast, CFO-rotated
    channel block in the serve layout. CPU tensors go through the plain version;
    CUDA tensors launch the kernel."""
    if h_ri.device.type == "cpu":
        return fused_fill_rotate_serve_plain(h_ri, w, rot_ri, layer_slices)
    if h_ri.device.type != "cuda":
        raise ValueError(f"fused_fill_rotate_serve runs on CPU or CUDA tensors, not {h_ri.device}")
    if w.dim() == 2:
        w = w[None]
    device = check_cuda_f32(h_ri=h_ri, w=w, rot_ri=rot_ri)
    B, two, nL, n_re = h_ri.shape
    n_cdm, _, n_sc = w.shape
    n_sym = rot_ri.shape[2]
    if two != 2 or B < 1:
        raise ValueError(f"h_ri must be (B>=1, 2, nL, n_re), got {tuple(h_ri.shape)}")
    check_shape("w", w, (n_cdm, n_re, n_sc))
    check_shape("rot_ri", rot_ri, (B, 2, n_sym))
    if not 1 <= n_sym <= _MAX_SYM:
        raise ValueError(f"kernel takes 1..{_MAX_SYM} symbols, got {n_sym}")
    tab = _ChunkTab()
    chunks = [
        (c, l, min(2, l1 - l))
        for c, (l0, l1) in enumerate(_layer_slices(layer_slices, nL, n_cdm))
        for l in range(l0, l1, 2)
    ]
    if len(chunks) > _MAX_CHUNKS or any(n < 1 for _, _, n in chunks):
        raise ValueError(f"unsupported layer_slices {layer_slices}")
    tab.n = len(chunks)
    for i, (c, l0, n) in enumerate(chunks):
        tab.c[i], tab.l0[i], tab.nl[i] = c, l0, n

    out = torch.empty((B, 2, nL, n_sym, n_sc), dtype=torch.float32, device=device)
    fn = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(
            h_ri.data_ptr(), w.data_ptr(), rot_ri.data_ptr(), out.data_ptr(),
            B, nL, n_re, n_sc, n_sym, ctypes.byref(tab), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_fill_rotate_serve kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out
