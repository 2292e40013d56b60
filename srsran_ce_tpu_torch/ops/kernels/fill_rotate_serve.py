"""K2 — serve-layout grid fill: `fused_fill_rotate_serve`.

Replaces the TPU kernel `srsran_ce_tpu/ops/pallas/kernels.py:fused_fill_rotate_serve`
(`_fill_rotate_serve_kernel3` for equal CDM groups, `_fill_rotate_serve_kernel`
for unequal ones). It computes

    out[b, l, y, t] = (h[b, l, :] @ W_c[:, t]) * rot[b, y]     (complex, in ri)

for every layer l of CDM group c, in the subcarrier-last serve layout
(B, 2, nL, n_sym, n_sc).

CUDA kernel (csrc/fill_rotate_serve.cu on the tiled product of
csrc/fill_common.cuh, which K6 shares), redesigned for Hopper.
The first body (a block per 128 subcarriers x 8 problems x 2 layers, W read
straight from L2, one float per 32 FMAs, the 14 symbols written only after
the whole product) ran at 8.3x its bound. Now each layer chunk (at most two
layers of one CDM group; nL=3 comes in as (0, 2), (2, 3)) is a tiled
product whose rows are (problem, layer, ri) pairs: output tiles of 64 rows x
128 subcarriers, both operands staged per K step of 32 through a two-stage
cp.async ring (W 16 bytes a copy) and shared by the tile's 32 (problem,
layer) pairs, an 8 x 4 register tile a thread. A cluster of KS blocks takes
one tile at a time, each block 1/KS of the K steps; the partial tiles meet in
distributed shared memory, summed in rank order, and each block writes its
share of the tile's pairs as 16-byte streaming stores of the n_sym rotated
symbols. The clusters are persistent (two blocks an SM) and walk the tiles,
so one tile's stores overlap the next one's product. `launch_plan` mirrors
the kernel's `make_plan` (a card test compares them). What bounds it on the
H100 at c2, batch 128: the 72.9 MB write (about 22 us at 3.35 TB/s) and
1.7 GFLOP of f32 FMA (about 25 us at 67 TFLOP/s without tensor cores).
Tensor-core 3xTF32 is a later change.

Precision: full f32 FMA for both "high" and "highest" (the TPU's "high" is a
3-pass bf16 split, `kernels._dot_f32x3`, which this is at least as accurate as).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import bind, check_cuda_f32, check_shape, full_f32_matmul, launch

#: kernel launches since the count was last set to 0 (incremented only where
#: the CUDA kernel is launched, never by the plain version)
launches = 0

_MAX_CHUNKS = 16
_MAX_SYM = 32
_PTR = ctypes.c_void_p


class _ChunkTab(ctypes.Structure):
    """Layer chunks, each inside one CDM group (struct ChunkTab in
    csrc/fill_common.cuh)."""

    _fields_ = [
        ("n", ctypes.c_int),
        ("c", ctypes.c_int * _MAX_CHUNKS),
        ("l0", ctypes.c_int * _MAX_CHUNKS),
        ("nl", ctypes.c_int * _MAX_CHUNKS),
    ]


_ARGTYPES = [_PTR] * 4 + [ctypes.c_int] * 5 + [ctypes.POINTER(_ChunkTab), _PTR]
PLAN_ARGTYPES = ([ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 4
                 + [ctypes.POINTER(_ChunkTab), ctypes.c_int])

_TM, _TN, _KT = 64, 128, 32  # product tile rows x subcarriers, K rows a stage
_BLOCKS_PER_SM = 2
_MAX_KS = 8
RING = 4 * 2 * _KT * (_TM + _TN)  # bytes of the two-stage ring (csrc/fill_common.cuh)
SMEM = max(RING, 4 * _TM * _TN)  # dynamic shared memory of a block


@dataclass(frozen=True)
class LaunchPlan:
    """KS blocks a cluster (each 1/KS of the K steps of a tile); output tiles in
    all; persistent clusters and blocks; dynamic shared memory a block."""

    KS: int
    tiles: int
    clusters: int
    blocks: int
    smem: int


def chunks_of(layer_slices, nL: int, n_cdm: int, max_layers: int = 2):
    """(group, first layer, layers) of each chunk: at most `max_layers` layers
    of one CDM group (struct ChunkTab's rows)."""
    chunks = [
        (c, l, min(max_layers, l1 - l))
        for c, (l0, l1) in enumerate(_layer_slices(layer_slices, nL, n_cdm))
        for l in range(l0, l1, max_layers)
    ]
    if not 1 <= len(chunks) <= _MAX_CHUNKS or any(n < 1 for _, _, n in chunks):
        raise ValueError(f"unsupported layer_slices {layer_slices}")
    return chunks


def chunk_table(chunks) -> _ChunkTab:
    tab = _ChunkTab()
    tab.n = len(chunks)
    for i, (c, l0, n) in enumerate(chunks):
        tab.c[i], tab.l0[i], tab.nl[i] = c, l0, n
    return tab


def launch_plan(batch: int, chunks, n_re: int, n_sc: int, n_sm: int) -> LaunchPlan:
    """The launch as `make_plan` (csrc/fill_rotate_serve.cu) computes it: the
    output tiles of every chunk (2 * batch * layers rows in tiles of 64, n_sc
    in tiles of 128); then `split_k` over the SMs."""
    if batch < 1 or n_re < 1 or n_sc < 1 or n_sm < 1:
        raise ValueError(f"no fill launch for batch={batch}, n_re={n_re}, n_sc={n_sc}")
    nt = -(-n_sc // _TN)
    tiles = sum(-(-2 * batch * nl // _TM) * nt for _, _, nl in chunks)
    ks, clusters = split_k(tiles, n_re, n_sm)
    return LaunchPlan(KS=ks, tiles=tiles, clusters=clusters, blocks=clusters * ks, smem=SMEM)


def split_k(tiles: int, n_re: int, n_sm: int):
    """(KS, clusters) as `fill::split_k` (csrc/fill_common.cuh) chooses them:
    ceil(n_sm / tiles) blocks a tile (1..8, at most the K steps of 32), so
    that fewer tiles than SMs still cover them; two blocks an SM, so
    2 * n_sm // KS persistent clusters, at most one a tile."""
    ks = max(1, min(_MAX_KS, -(-n_re // _KT), -(-n_sm // tiles)))
    return ks, max(1, min(tiles, _BLOCKS_PER_SM * n_sm // ks))


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
    tab = chunk_table(chunks_of(layer_slices, nL, n_cdm))
    out = torch.empty((B, 2, nL, n_sym, n_sc), dtype=torch.float32, device=device)
    launch(
        "fused_fill_rotate_serve", bind("fill_rotate_serve", "srs_fill_rotate_serve_f32", _ARGTYPES),
        device, h_ri.data_ptr(), w.data_ptr(), rot_ri.data_ptr(), out.data_ptr(),
        B, nL, n_re, n_sc, n_sym, ctypes.byref(tab),
    )
    global launches
    launches += 1
    return out


def kernel_plan(batch: int, nL: int, chunks, n_re: int, n_sc: int, n_sm: int) -> LaunchPlan:
    """The kernel's own plan (`srs_fill_rotate_serve_plan` of the built
    library), to hold `launch_plan` to it on the card."""
    out = (ctypes.c_longlong * 5)()
    rc = bind("fill_rotate_serve", "srs_fill_rotate_serve_plan", PLAN_ARGTYPES)(
        out, batch, nL, n_re, n_sc, ctypes.byref(chunk_table(chunks)), n_sm)
    if rc != 0:
        raise ValueError(f"srs_fill_rotate_serve_plan refused the shape (CUDA error {rc})")
    return LaunchPlan(*[int(v) for v in out])
