"""K3 — row-streamed layered min-sum with float32 or bfloat16 messages: `ldpc_stream_posterior`.

Replaces the TPU kernel
`srsran_ce_tpu/ops/pallas/kernels.py:ldpc_stream_posterior`
(`_ldpc_stream_kernel`): the layered schedule walked row by row from wiring
tables, in groups of `group` rows that share one posterior snapshot, with
the check-to-variable messages stored in float32 or bfloat16. A stored
bfloat16 message is the round-to-nearest-even of the float32 update, and L
takes the stored value minus the old one, so it stays consistent with what
is stored. `ops/ldpc.build_decoder(kernels="pallas_stream")` reaches it, and
`kernels="auto"` with `schedule="layered"` on codes over the unroll budget
(NR BG1 at Z=384, the largest code block).

CUDA kernel (csrc/ldpc_stream.cu, the layered sweep of csrc/ldpc_common.cuh
instantiated for both message types; see `ops/kernels/ldpc.py` for the
records and the routes): the messages are kept as one record per (check
row, lane), {r1, r2} in the message type and a word of the first-minimum
slot and the sign bits, 8 B in bfloat16 and 12 B in float32, instead of deg
messages. At NR BG1 Z=384 L takes 104,448 B of a block's shared memory and
the records, 141 KB (bf16) or 212 KB (f32) per codeword, do not fit beside
it: they stay in a global scratch (18 / 27 MB at B=128, both held by the
50 MB L2), one contiguous block of a row group's records, which `cp.async`
brings into a double buffer in shared memory one row step ahead. A block
uses about 112 KB (bf16) or 116 KB (f32) there. Each check lane reads one
record and writes one per row step; its slot loop is unrolled over a
degree bucket, so the row's L reads are in flight together. Smaller codes
take the chip route (every record in shared memory), as K4 does. The TPU
kernel's z padding to 128 lanes and its two-rotation `roll_mod_z` have no
counterpart: a shift is index math mod z. Padded group rows and padded slots
do nothing (the TPU kernel stores 0 there, never norm * 1e30, which is inf
in bfloat16).

What bounds it on the H100: 128 codewords are 128 blocks, one wave on 132
SMs, and each sweep is mb row steps in series; the bytes (the LLRs in, the
posterior out, 27 MB at B=128) need 8 us at 3.35 TB/s, so it is bound by the
latency of the row steps: a barrier, one lane's slot loop (up to 22 slots)
and its two-min fold (see PERF.md). So with groups of one row (the served
call's 96 words, the bench's 128, the host decode path's 512) a block runs
each row step on two threads a check lane, the pair route
(`ops/kernels/ldpc.py`), each thread half the slots; `route_launches`
counts the launches by route.
"""
from __future__ import annotations

import ctypes

import torch

from . import bind, launch
from .ldpc import ROUTES, check_args, layered_plain, prepare, wiring

#: kernel launches since the count was last set to 0 (incremented only where
#: the CUDA kernel is launched, never by the plain version)
launches = 0
#: the same launches by launch-plan route (`ldpc.ROUTES`)
route_launches = dict.fromkeys(ROUTES, 0)

_PTR = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_PTR] * 5 + [_I] * 6 + [ctypes.c_float] + [_I] * 3 + [_PTR]
_C2V_DTYPES = {None: torch.float32, "float32": torch.float32, "bfloat16": torch.bfloat16,
               torch.float32: torch.float32, torch.bfloat16: torch.bfloat16}


def message_dtype(c2v_dtype) -> torch.dtype:
    """The stored message type: None or "float32" -> float32, "bfloat16"."""
    if c2v_dtype not in _C2V_DTYPES:
        raise ValueError(f"c2v_dtype must be None, 'float32' or 'bfloat16', got {c2v_dtype!r}")
    return _C2V_DTYPES[c2v_dtype]


def ldpc_stream_posterior_plain(ch: torch.Tensor, plan, n_iters: int, norm: float,
                                group: int = 1, c2v_dtype=None) -> torch.Tensor:
    """Plain PyTorch version: (B, n) channel LLRs -> (B, n) posterior, the
    kernel's arithmetic in the same order (messages stored as `c2v_dtype`;
    with float64 LLRs and no `c2v_dtype` they are float64)."""
    w = wiring(plan, ch.device)
    cdt = None if c2v_dtype is None else message_dtype(c2v_dtype)
    return layered_plain(ch, w, n_iters, norm, max(1, min(int(group), w.mb)), cdt)


def ldpc_stream_posterior(ch: torch.Tensor, plan, n_iters: int, norm: float,
                          group: int = 1, c2v_dtype=None) -> torch.Tensor:
    """Layered normalized min-sum posterior of (B, n) channel LLRs after
    `n_iters` sweeps, `group` rows per snapshot, messages stored as
    `c2v_dtype` (None/"float32" or "bfloat16"). CPU tensors go through the
    plain version; CUDA tensors launch the kernel."""
    if ch.device.type == "cpu":
        return ldpc_stream_posterior_plain(ch, plan, n_iters, norm, group, c2v_dtype)
    if ch.device.type != "cuda":
        raise ValueError(f"ldpc_stream_posterior runs on CPU or CUDA tensors, not {ch.device}")
    cdt = message_dtype(c2v_dtype)
    device, w = check_args(ch, plan, 1)
    B = ch.shape[0]
    g = max(1, min(int(group), w.mb))
    bf16 = cdt == torch.bfloat16
    lp, rec = prepare(w, device, B, 2 if bf16 else 4, True, g)
    out = torch.empty_like(ch)
    launch("ldpc_stream_posterior", bind("ldpc_stream", "srs_ldpc_stream_posterior", _ARGTYPES),
           device, ch.data_ptr(), out.data_ptr(), None if rec is None else rec.data_ptr(), None,
           w.table.data_ptr(), B, w.n_edges, w.mb, w.nb, w.z, w.d, float(norm), int(n_iters), g,
           int(bf16))
    global launches
    launches += 1
    route_launches[lp.route] += 1
    return out
