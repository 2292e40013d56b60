"""K6 — reference-layout grid fill: `fused_fill_rotate`.

Replaces the TPU kernel `srsran_ce_tpu/ops/pallas/kernels.py:fused_fill_rotate`
(`_fill_rotate_kernel`). It computes

    out[b, sc, y, l] = (h[b, l, :] @ W_c[:, sc]) * rot[b, y]     (complex, in ri)

for every layer l of CDM group c, in the reference layout (B, 2, n_sc, n_sym,
nL): the layout of the conformance path (`kernels="pallas"`,
`out_layout="ref"`).

CUDA kernel (csrc/fill_rotate.cu): one thread block per (128-subcarrier tile,
block of 8 problems), one subcarrier per thread. It reuses K2's product loop
(h rows staged in shared memory, W read straight from L2, f32 FMA sums in
registers) once per layer chunk of at most two layers of one CDM group, so one
launch covers every CDM group of a hop, equal or not (nL=3: layers (0, 2),
(2, 3)). The sums of all layers wait in shared memory; the epilogue then
writes the tile with the layer minor-most, so consecutive threads store
consecutive floats: for a hop over the whole slot one (problem, re/im) tile
is a single span of 128 x n_sym x nL floats. With `out` the kernel writes the
hop's block straight into its slice of the zero grid, so no block is
concatenated or copied afterwards.

What bounds it on the H100: the write, 72.9 MB at c2 and batch 128 (about
22 us at 3.35 TB/s), and about 1.7 GFLOP of f32 FMA (about 25 us at
67 TFLOP/s without tensor cores). The TPU kernel's per-program VMEM limit
(`_grid_fill_rotate_pallas` falls back to XLA above 6 MB of operator) has no
counterpart: W is read from L2 in chunks, any size works.

Precision: full f32 FMA (the TPU runs this product at HIGHEST).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, check_cuda_f32, check_shape, full_f32_matmul

#: kernel launches since the count was last set to 0 (incremented only where
#: the CUDA kernel is launched, never by the plain version)
launches = 0

_MAX_CHUNKS = 16
_MAX_SYM = 32
_MAX_LAYERS = 8
_PTR = ctypes.c_void_p


class _FillChunks(ctypes.Structure):
    """Layer chunks of at most two layers, each inside one CDM group
    (struct FillChunks in csrc/fill_rotate.cu)."""

    _fields_ = [
        ("n", ctypes.c_int),
        ("c", ctypes.c_int * _MAX_CHUNKS),
        ("l0", ctypes.c_int * _MAX_CHUNKS),
        ("nl", ctypes.c_int * _MAX_CHUNKS),
    ]


_ARGTYPES = [_PTR] * 4 + [ctypes.c_int] * 9 + [ctypes.POINTER(_FillChunks), _PTR]


def _layer_slices(layer_slices, nL: int, n_cdm: int):
    if layer_slices is None:
        layer_slices = ((0, nL),)
    layer_slices = tuple((int(a), int(b)) for a, b in layer_slices)
    if len(layer_slices) != n_cdm or layer_slices[-1][1] != nL:
        raise ValueError(f"layer_slices {layer_slices} do not cover {nL} layers in {n_cdm} groups")
    return layer_slices


def fused_fill_rotate_plain(
    h_ri: torch.Tensor,  # (B, 2, nL, n_re)
    w: torch.Tensor,  # (n_re, n_sc) or (n_cdm, n_re, n_sc)
    rot_ri: torch.Tensor,  # (B, 2, n_sym)
    layer_slices=None,
) -> torch.Tensor:
    """Plain PyTorch version: (B, 2, n_sc, n_sym, nL)."""
    B, _, nL, _ = h_ri.shape
    if w.dim() == 2:
        w = w[None]
    layer_slices = _layer_slices(layer_slices, nL, w.shape[0])
    n_sym = rot_ri.shape[2]
    out = torch.empty((B, 2, w.shape[-1], n_sym, nL), dtype=h_ri.dtype, device=h_ri.device)
    rr = rot_ri[:, 0][:, None, :, None]  # (B, 1, n_sym, 1)
    ri = rot_ri[:, 1][:, None, :, None]
    with full_f32_matmul():
        for c, (l0, l1) in enumerate(layer_slices):
            f = torch.matmul(h_ri[:, :, l0:l1], w[c]).transpose(-1, -2)  # (B, 2, n_sc, n_lc)
            fr = f[:, 0, :, None, :]  # (B, n_sc, 1, n_lc)
            fi = f[:, 1, :, None, :]
            out[:, 0, :, :, l0:l1] = fr * rr - fi * ri
            out[:, 1, :, :, l0:l1] = fr * ri + fi * rr
    return out


def _lib():
    fn = _build.load("fill_rotate").srs_fill_rotate_f32
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def fused_fill_rotate(
    h_ri: torch.Tensor,
    w: torch.Tensor,
    rot_ri: torch.Tensor,
    layer_slices=None,
    out: Optional[torch.Tensor] = None,
    sc_start: int = 0,
    sym_start: int = 0,
) -> torch.Tensor:
    """Interpolated, symbol-broadcast, CFO-rotated channel block in the
    reference layout, (B, 2, n_sc, n_sym, nL).

    With `out` (B, 2, grid_sc, grid_sym, nL) the block goes into
    out[:, :, sc_start:sc_start + n_sc, sym_start:sym_start + n_sym] and `out`
    is returned; the rest of it is left as it was. CPU tensors go through the
    plain version; CUDA tensors launch the kernel."""
    if h_ri.device.type == "cpu":
        blk = fused_fill_rotate_plain(h_ri, w, rot_ri, layer_slices)
        if out is None:
            return blk
        n_sc, n_sym = blk.shape[2], blk.shape[3]
        out[:, :, sc_start : sc_start + n_sc, sym_start : sym_start + n_sym] = blk
        return out
    if h_ri.device.type != "cuda":
        raise ValueError(f"fused_fill_rotate runs on CPU or CUDA tensors, not {h_ri.device}")
    if w.dim() == 2:
        w = w[None]
    device = check_cuda_f32(h_ri=h_ri, w=w, rot_ri=rot_ri, out=out)
    B, two, nL, n_re = h_ri.shape
    n_cdm, _, n_sc = w.shape
    n_sym = rot_ri.shape[2]
    if two != 2 or B < 1 or not 1 <= nL <= _MAX_LAYERS:
        raise ValueError(f"h_ri must be (B>=1, 2, 1..{_MAX_LAYERS}, n_re), got {tuple(h_ri.shape)}")
    check_shape("w", w, (n_cdm, n_re, n_sc))
    check_shape("rot_ri", rot_ri, (B, 2, n_sym))
    if not 1 <= n_sym <= _MAX_SYM:
        raise ValueError(f"kernel takes 1..{_MAX_SYM} symbols, got {n_sym}")
    if out is None:
        out = torch.empty((B, 2, n_sc, n_sym, nL), dtype=torch.float32, device=device)
        sc_start = sym_start = 0
    elif (out.dim() != 5 or tuple(out.shape[:2]) != (B, 2) or out.shape[4] != nL
          or not (0 <= sc_start and sc_start + n_sc <= out.shape[2])
          or not (0 <= sym_start and sym_start + n_sym <= out.shape[3])):
        raise ValueError(f"out {tuple(out.shape)} cannot take a ({n_sc}, {n_sym}, {nL}) block "
                         f"at ({sc_start}, {sym_start})")
    tab = _FillChunks()
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

    fn = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(
            h_ri.data_ptr(), w.data_ptr(), rot_ri.data_ptr(), out.data_ptr(),
            B, nL, n_re, n_sc, n_sym, out.shape[2], out.shape[3], sc_start, sym_start,
            ctypes.byref(tab), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_fill_rotate kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out
