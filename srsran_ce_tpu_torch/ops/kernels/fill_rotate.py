"""K6 — reference-layout grid fill: `fused_fill_rotate`.

Replaces the TPU kernel `srsran_ce_tpu/ops/pallas/kernels.py:fused_fill_rotate`
(`_fill_rotate_kernel`). It computes

    out[b, sc, y, l] = (h[b, l, :] @ W_c[:, sc]) * rot[b, y]     (complex, in ri)

for every layer l of CDM group c, in the reference layout (B, 2, n_sc, n_sym,
nL): the layout of the conformance path (`kernels="pallas"`,
`out_layout="ref"`).

CUDA kernel (csrc/fill_rotate.cu), redesigned for Hopper on K2's tiled
product (csrc/fill_common.cuh: a two-stage cp.async ring, an 8 x 4 register
tile a thread, K split over a cluster where the tiles are fewer than the SMs,
persistent clusters). The first body (one subcarrier a thread, W read from L2
a float at a time, chunks of two layers, scalar stores with a divide a float)
ran at 6 % of its bound. In this layout a (problem, re/im, subcarrier) span is
n_sym x nL floats with the layer fastest, so a tile holds every layer of its
P problems x 128 subcarriers: it runs the product once per CDM group (rows
(problem, layer of the group, re/im), 2 P nl <= 64), parks the sums in shared
memory, and after the last group sums the cluster's partials in rank order,
rotates and writes whole spans, 16 bytes a store where they are aligned (as
at c2). One launch covers every CDM group of a hop, equal or not (nL=3:
(0, 2), (2, 3)). With `out` the kernel writes the hop's block straight into
its slice of the zero grid, so no block is concatenated or copied
afterwards. `launch_plan` mirrors the kernel's `make_plan` (a card test
compares them).

What bounds it on the H100 at c2, batch 128: the write, 72.9 MB (about 22 us
at 3.35 TB/s), and about 1.7 GFLOP of f32 FMA (about 25 us at 67 TFLOP/s
without tensor cores), the same work as K2's. The TPU kernel's per-program
VMEM limit (`_grid_fill_rotate_pallas` falls back to XLA above 6 MB of
operator) has no counterpart: W streams through the ring, any size works.

Precision: full f32 FMA (the TPU runs this product at HIGHEST).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from . import bind, check_cuda_f32, check_shape, full_f32_matmul, launch
from .fill_rotate_serve import (_MAX_CHUNKS, _MAX_SYM, _TM, _TN, RING, _ChunkTab, _layer_slices,
                                chunk_table, chunks_of, split_k)

#: kernel launches since the count was last set to 0 (incremented only where
#: the CUDA kernel is launched, never by the plain version)
launches = 0

_MAX_LAYERS = 8
#: dynamic shared memory of a block at two blocks an SM (an sm_90 SM has
#: 233472 bytes, the runtime keeps 1024 of them for each block)
BLOCK_SMEM = 233472 // 2 - 1024
_PTR = ctypes.c_void_p
_ARGTYPES = [_PTR] * 4 + [ctypes.c_int] * 9 + [ctypes.POINTER(_ChunkTab), _PTR]
PLAN_ARGTYPES = ([ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 5
                 + [ctypes.POINTER(_ChunkTab), ctypes.c_int])


@dataclass(frozen=True)
class LaunchPlan:
    """P problems a tile; tiles (P problems x 128 subcarriers); KS blocks a
    cluster (each 1/KS of the K steps of a tile); persistent clusters and
    blocks; dynamic shared memory a block (the ring and the parked sums)."""

    P: int
    tiles: int
    KS: int
    clusters: int
    blocks: int
    smem: int


def fill_chunks(layer_slices, nL: int, n_cdm: int):
    """(group, first layer, layers) of each CDM group: K6 runs the product
    once per group, every layer of it at once."""
    return chunks_of(layer_slices, nL, n_cdm, max_layers=_MAX_LAYERS)


def launch_plan(batch: int, nL: int, chunks, n_re: int, n_sc: int, n_sym: int,
                n_sm: int) -> LaunchPlan:
    """The launch as `make_plan` (csrc/fill_rotate.cu) computes it: P, the
    problems of a tile, as large as a product tile's 64 rows take every
    group's 2 P nl rows and the P x 2 x nL x 128 parked sums fit beside the
    ring at two blocks an SM, at most the batch; tiles of P problems x 128
    subcarriers; then K2's split (`split_k`). Raises where the kernel does:
    nL outside 1..8, chunks outside 1..16 or not covering each layer once,
    n_sym outside 1..32."""
    if batch < 1 or n_re < 1 or n_sc < 1 or n_sm < 1:
        raise ValueError(f"no fill launch for batch={batch}, n_re={n_re}, n_sc={n_sc}")
    if not 1 <= nL <= _MAX_LAYERS:
        raise ValueError(f"kernel takes 1..{_MAX_LAYERS} layers, got {nL}")
    if not 1 <= len(chunks) <= _MAX_CHUNKS:
        raise ValueError(f"kernel takes 1..{_MAX_CHUNKS} chunks, got {len(chunks)}")
    if sorted(l for _, l0, n in chunks for l in range(l0, l0 + n)) != list(range(nL)):
        raise ValueError(f"chunks {chunks} do not cover each of {nL} layers once")
    if not 1 <= n_sym <= _MAX_SYM:
        raise ValueError(f"kernel takes 1..{_MAX_SYM} symbols, got {n_sym}")
    nl_max = max(n for _, _, n in chunks)
    park_max = (BLOCK_SMEM - RING) // (4 * 2 * nL * _TN)
    P = max(1, min(batch, _TM // 2 // nl_max, park_max))
    tiles = -(-batch // P) * -(-n_sc // _TN)
    ks, clusters = split_k(tiles, n_re, n_sm)
    return LaunchPlan(P=P, tiles=tiles, KS=ks, clusters=clusters, blocks=clusters * ks,
                      smem=RING + 4 * P * 2 * nL * _TN)


def kernel_plan(batch: int, nL: int, chunks, n_re: int, n_sc: int, n_sym: int,
                n_sm: int) -> LaunchPlan:
    """The kernel's own plan (`srs_fill_rotate_plan` of the built library), to
    hold `launch_plan` to it on the card."""
    out = (ctypes.c_longlong * 6)()
    rc = bind("fill_rotate", "srs_fill_rotate_plan", PLAN_ARGTYPES)(
        out, batch, nL, n_re, n_sc, n_sym, ctypes.byref(chunk_table(chunks)), n_sm)
    if rc != 0:
        raise ValueError(f"srs_fill_rotate_plan refused the shape (CUDA error {rc})")
    return LaunchPlan(*[int(v) for v in out])


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
    tab = chunk_table(fill_chunks(layer_slices, nL, n_cdm))
    launch(
        "fused_fill_rotate", bind("fill_rotate", "srs_fill_rotate_f32", _ARGTYPES), device,
        h_ri.data_ptr(), w.data_ptr(), rot_ri.data_ptr(), out.data_ptr(),
        B, nL, n_re, n_sc, n_sym, out.shape[2], out.shape[3], sc_start, sym_start, ctypes.byref(tab),
    )
    global launches
    launches += 1
    return out
