"""K4 — all sweeps of normalized min-sum QC-LDPC decoding on chip: `ldpc_posterior`.

Replaces the TPU kernel `srsran_ce_tpu/ops/pallas/kernels.py:ldpc_posterior`
(`_ldpc_kernel`): `n_iters` flooding sweeps, or row-layered sweeps in groups
of `group` rows that share one posterior snapshot, from the channel LLRs to
the posterior, bit-identical to the `"xla"` tier of `ops/ldpc.build_decoder`
(same edge order, same association, the first-minimum tie of `argmin`).
`ops/ldpc.build_decoder(kernels="pallas")` reaches it.

CUDA kernel (csrc/ldpc.cu, with csrc/ldpc_common.cuh): the messages are
kept as records, one per (check row, lane): every message a row stores at a
lane is +-r1 or +-r2 (r1, r2 its stored normalized minima; r2 at the first
minimum), so {r1, r2, a word of the first-minimum slot and the messages' sign
bits} rebuilds each of them bit for bit, -0.0 included. At BG2 Z=208 that is
42 x 208 x 12 B = 105 KB per codeword instead of 219 KB of per-edge
messages. The wiring (packed per edge and per column edge, about 4 KB) is
copied into shared memory once per block; the slot loops are unrolled over
a degree bucket (8, 16 or 27) and leave at the row's degree, so a row's L
reads are in flight together.
`launch_plan` (mirroring `ldpc::make_plan`) picks one of three routes:
- chip: L, the records and (flooding) the LLRs all in shared memory, the
  TPU kernel's all-in-VMEM layout (BG2 Z=208 flooding: 191 KB; BG1 Z=52:
  57 KB; n976: 12 KB), several codewords a block where z is small (lanes
  filling warps while the blocks still cover the SMs);
- stream: L in shared memory, the records in a global scratch that L2 holds,
  for codes whose state does not fit one block (227 KB); the layered sweep
  brings each row group's records in a step ahead with `cp.async`, into a
  double buffer;
- pair: the stream route's records and buffers, with two threads a check
  lane in the layered row step (`layered_kernel_pair`), where the stream
  route would run groups of one row at one codeword a block and 2z <=
  PAIR_THREADS, at any batch. A row step is a serial chain, the lane's L
  reads, the two-min fold through every slot and the apply, that 12 warps
  an SM (z = 384) do not hide: each thread takes a contiguous half of the
  row's slots, N = ceil(deg / 2) each (with deg odd the upper thread masks
  the slot they share), unrolled for N with no branch a slot; the two folds
  merge by warp shuffles into the plain fold's minima, first-minimum slot
  and signs (the lower half's minimum wins a tie), and each thread applies
  its half. The stream route's kernel keeps groups of several rows.
A code whose posterior and row buffers exceed the limit is refused. No route
is chosen by catching an error, and no call falls back.
- Flooding: one thread per variable bit sums ch + the column's messages in
  edge order, each rebuilt from its row's record at lane (a - s) mod z (no
  atomics: their order is not fixed), then one thread per check lane folds
  its row's two minima and rewrites its record in place.
- Layered: one thread per check lane (two on the pair route) of the
  group's rows computes its new record from the L snapshot. With group == 1
  each lane applies new - old to L at once (within one row each variable
  block appears once: a QC base matrix has one shift per (row, column));
  with group > 1 the old records are kept and the rows are applied in
  order, one `__syncthreads()` apart, each delta rebuilt from the old and
  the new record (no delta scratch).
Every add, subtract and product is a `__fadd_rn`/`__fsub_rn`/`__fmul_rn`, so
no FMA contraction moves a bit against the plain version.

What bounds it on the H100: the bytes are tiny (the LLRs read once, the
posterior written once: 11 MB at BG2 Z=208, B=128); the work is about 10
operations per edge lane per sweep, serial through the sweeps and, in the
layered schedule, through the rows. So it is bound by the latency of its
row steps (a barrier, one lane's slot loop and its two-min fold) and, with
wide rows, by one SM's issue rate, not by a roofline (see PERF.md). The
TPU's sublane-z / lane-z tilings and batch tiles are TPU layouts and have no
counterpart.

The wiring tables (`Wiring`, per code and device) serve every tier of
`ops/ldpc.build_decoder`, the plain ones included.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from . import bind, check_cuda_f32, launch

#: kernel launches since the count was last set to 0 (incremented only where
#: the CUDA kernel is launched, never by the plain version)
launches = 0

BIG = 1e30  # the JAX package's mask value for padded check slots (never wins a min)
#: dynamic shared memory one block may use on the H100 (227 KB)
SMEM_LIMIT = 232448
#: a record's word holds the first-minimum slot in 5 bits and one message
#: sign bit per slot in the other 27
MAX_DEGREE = 27
MAX_ROWS = 2048  # a packed column edge holds its row in 11 bits
MAX_THREADS = 512
#: the pair route's largest block: two threads a check lane up to z = 384
PAIR_THREADS = 768
#: route 0: every record in shared memory; 1: records in L2; 2: records in L2
#: and two threads a check lane
ROUTES = ("chip", "stream", "pair")

_PTR = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_PTR] * 5 + [_I] * 7 + [ctypes.c_float, _I, _I, _PTR]
PLAN_ARGTYPES = [ctypes.POINTER(ctypes.c_longlong)] + [_I] * 9


@dataclass(frozen=True)
class Wiring:
    """Index tables of one code on one device (built from its `LdpcPlan`).

    Edges are the plan's, row-major (`plan.edges`): edge e is slot t of check
    row i, on variable block j with shift s; check lane a of edge e reads
    variable bit j*z + (a + s) mod z, and variable bit p of block j takes
    message lane (p - s) mod z.
      gidx (E, z)      the variable bit each check lane of each edge reads
      row_ptr          edges of row i are row_ptr[i]:row_ptr[i + 1]
      slot_gidx (mb*d*z,) gidx in the (row, slot, lane) frame, 0 for pads
      valid (mb, d)    real slots
      info_cols (k,)   systematic positions
      table            int32 [edge_var | edge_shift | row_ptr | col_ptr | col_edge]
                       for the CUDA kernels
      row_lo, row_hi   row_ptr[:-1] and row_ptr[1:] on the device (the parity
                       check's row sums)
    """

    n_edges: int
    mb: int
    nb: int
    z: int
    d: int
    gidx: torch.Tensor
    row_ptr: Tuple[int, ...]
    slot_gidx: torch.Tensor
    valid: torch.Tensor
    info_cols: torch.Tensor
    table: torch.Tensor
    row_lo: torch.Tensor
    row_hi: torch.Tensor


_wiring_cache: dict = {}


def wiring(plan, device) -> Wiring:
    """The `Wiring` of `plan` (an `ops.ldpc.LdpcPlan`) on `device`, cached."""
    device = torch.device(device)
    key = (plan.code, str(device))
    w = _wiring_cache.get(key)
    if w is not None:
        return w
    code = plan.code
    mb, nb, z, d = code.n_check_blocks, code.n_var_blocks, code.z, plan.max_degree
    edges = plan.edges
    E = len(edges)
    ev = np.array([j for _, _, j, _ in edges], np.int64)
    es = np.array([s % z for _, _, _, s in edges], np.int64)
    er = np.array([i for i, _, _, _ in edges], np.int64)
    et = np.array([t for _, t, _, _ in edges], np.int64)
    a = np.arange(z)
    gidx = ev[:, None] * z + (a[None, :] + es[:, None]) % z
    row_ptr = np.searchsorted(er, np.arange(mb + 1)).astype(np.int64)
    col_lists = [[e for e in range(E) if ev[e] == j] for j in range(nb)]  # edge order
    col_ptr = np.cumsum([0] + [len(c) for c in col_lists]).astype(np.int64)
    col_edge = np.array([e for c in col_lists for e in c], np.int64)
    slot_gidx = np.zeros((mb, d, z), np.int64)  # invalid slots read bit 0 (masked)
    slot_gidx[er, et] = gidx
    table = np.concatenate([ev, es, row_ptr, col_ptr, col_edge]).astype(np.int32)
    t = lambda x: torch.as_tensor(np.asarray(x), device=device)
    w = Wiring(
        n_edges=E, mb=mb, nb=nb, z=z, d=d,
        gidx=t(gidx), row_ptr=tuple(int(x) for x in row_ptr),
        slot_gidx=t(slot_gidx.reshape(-1)), valid=t(plan.slot_valid),
        info_cols=t(plan.info_cols), table=t(table), row_lo=t(row_ptr[:-1]), row_hi=t(row_ptr[1:]),
    )
    _wiring_cache[key] = w
    return w


# ---------------------------------------------------------------------------
# plain PyTorch versions (any device, float32 or float64)
# ---------------------------------------------------------------------------


def check_update(v2c: torch.Tensor, valid, norm: float) -> torch.Tensor:
    """Extrinsic normalized min-sum over the slot axis (-2) of a
    (..., rows, slots, z) frame: sign = product of the other signs, magnitude
    = the least of the other magnitudes (the second least at the first
    minimum, `argmin`'s tie). `valid` (rows, slots) masks padded slots, which
    emit 0; None means every slot is real."""
    mag = v2c.abs()
    neg = v2c < 0
    if valid is not None:
        vm = valid[:, :, None]
        mag = torch.where(vm, mag, BIG)
        neg = neg & vm
    i_min = mag.argmin(dim=-2, keepdim=True)
    slot = torch.arange(v2c.shape[-2], device=v2c.device)[:, None]
    onehot = slot == i_min
    min1 = mag.gather(-2, i_min)
    min2 = torch.where(onehot, BIG, mag).amin(dim=-2, keepdim=True)
    r = torch.where(onehot, min2, min1) * norm
    par = (neg.sum(dim=-2, keepdim=True) % 2) == 1
    upd = torch.where(par ^ neg, -r, r)
    if valid is not None:
        upd = torch.where(vm, upd, 0.0)
    return upd


def _roll_z(x: torch.Tensor, s: int, z: int) -> torch.Tensor:
    """Cyclic shift of the last (z) axis by +s: two slices and a cat."""
    s %= z
    if s == 0:
        return x
    return torch.cat([x[..., z - s :], x[..., : z - s]], dim=-1)


def flooding_plain(ch, plan, w: Wiring, n_iters: int, norm: float) -> torch.Tensor:
    """Flooding min-sum, one cyclic shift per edge, each variable block's
    posterior summed in edge order (`plan.edges`), messages in the
    (B, mb, d, z) check frame: the JAX package's "xla" tier, which K4 matches
    bit for bit."""
    mb, nb, d, z = w.mb, w.nb, w.d, w.z
    B = ch.shape[0]
    ch3 = ch.reshape(B, nb, z)

    def accum(c2v):  # (B, mb, d, z) -> posterior (B, nb, z)
        acc = [ch3[:, j] for j in range(nb)]
        for i, t, j, s in plan.edges:
            acc[j] = acc[j] + _roll_z(c2v[:, i, t], s, z)
        return torch.stack(acc, 1)

    def gather(post):  # (B, nb, z) -> check frame (B, mb, d, z)
        zero = post.new_zeros((B, z))
        cols = [[zero] * d for _ in range(mb)]
        for i, t, j, s in plan.edges:
            cols[i][t] = _roll_z(post[:, j], -s, z)
        return torch.stack([torch.stack(row, 1) for row in cols], 1)

    c2v = ch.new_zeros((B, mb, d, z))
    for _ in range(n_iters):
        c2v = check_update(gather(accum(c2v)) - c2v, w.valid, norm)
    return accum(c2v).reshape(B, -1)


def layered_plain(ch, w: Wiring, n_iters: int, norm: float, group: int = 1,
                  c2v_dtype=None) -> torch.Tensor:
    """Row-layered min-sum over groups of `group` rows: each group's messages
    from one L snapshot, then applied row by row. The messages are stored in
    `c2v_dtype` (default: ch's); L takes the stored (rounded) value minus the
    old one, so it stays consistent with what is stored."""
    B = ch.shape[0]
    cdt = ch.dtype if c2v_dtype is None else c2v_dtype
    L = ch.clone()
    c2v = torch.zeros((B, w.n_edges, w.z), dtype=cdt, device=ch.device)
    rows = [(w.row_ptr[i], w.row_ptr[i + 1]) for i in range(w.mb)]
    for _ in range(n_iters):
        for g0 in range(0, w.mb, group):
            deltas = []
            for r0, r1 in rows[g0 : g0 + group]:
                idx = w.gidx[r0:r1]
                old = c2v[:, r0:r1].to(ch.dtype)
                upd = check_update((L[:, idx] - old)[:, None], None, norm)[:, 0]
                stored = upd.to(cdt)
                deltas.append((idx, stored.to(ch.dtype) - old))  # before `old` (a view) is overwritten
                c2v[:, r0:r1] = stored
            for idx, dl in deltas:
                L[:, idx] = L[:, idx] + dl
    return L


def ldpc_posterior_plain(ch: torch.Tensor, plan, n_iters: int, norm: float,
                         schedule: str = "flooding", group: int = 1) -> torch.Tensor:
    """Plain PyTorch version: (B, n) channel LLRs -> (B, n) posterior, the
    kernel's arithmetic in the same order."""
    w = wiring(plan, ch.device)
    if schedule == "layered":
        return layered_plain(ch, w, n_iters, norm, group)
    return flooding_plain(ch, plan, w, n_iters, norm)


@dataclass(frozen=True)
class LaunchPlan:
    """How one call runs (`launch_plan`): the route (`ROUTES`), codewords per
    block, threads per block, blocks, one block's dynamic shared memory, the
    stream route's global record bytes per codeword (0 on the chip route),
    and one codeword's shared-memory region."""

    route: str
    cpb: int
    threads: int
    blocks: int
    smem: int
    scratch: int
    per_cw: int


def _pad16(x: int) -> int:
    return (x + 15) // 16 * 16


def record_stride(z: int, msg_bytes: int) -> int:
    """Bytes of one check row's records: the {r1, r2} plane (2 messages a
    lane) and the word plane, each padded to 16 bytes."""
    return _pad16(2 * msg_bytes * z) + _pad16(4 * z)


def launch_plan(w: Wiring, batch: int, msg_bytes: int, layered: bool, group: int,
                n_sm: int) -> LaunchPlan:
    """The route, codewords per block and shared memory of a launch, as
    `ldpc::make_plan` (csrc/ldpc_common.cuh) computes them; raises when
    neither route fits one block's shared memory.

    Shared memory: the packed wiring, then per codeword L (and, flooding on
    the chip route, the LLRs) and the records: all of them on the chip route
    (plus the group's old records when layered with group > 1), two row-group
    buffers (plus the group's new records when group > 1) on the stream
    route. A block takes the most codewords, c, such that its shared memory
    fits, c times the threads of one row step (one a check lane layered, one
    a bit or check lane flooding) fill at most MAX_THREADS, and
    ceil(batch / c) blocks still cover the `n_sm` SMs. The stream route with
    groups of one row, one codeword a block and 2z <= PAIR_THREADS becomes
    the pair route: 2z threads a block."""
    mb, nb, z, E = w.mb, w.nb, w.z, w.n_edges
    n = nb * z
    G = group if layered else 1
    stride = record_stride(z, msg_bytes)
    # row_ptr, the packed edges, and (flooding) the column lists
    wiring_b = _pad16(4 * (mb + 1)) + _pad16(4 * E) + (0 if layered else _pad16(4 * (nb + 1 + E)))
    lb = _pad16(4 * n)
    chip = lb + (0 if layered else lb) + mb * stride + (G * stride if layered and G > 1 else 0)
    stream = lb + ((3 if G > 1 else 2) * G * stride if layered else 0)
    lanes = G * z if layered else max(mb * z, n)  # threads of one row step
    if wiring_b + chip <= SMEM_LIMIT:
        route, per = "chip", chip
    elif wiring_b + stream <= SMEM_LIMIT:
        route, per = "stream", stream
    else:
        raise ValueError(
            f"the decoder state does not fit one block's shared memory ({SMEM_LIMIT} B): "
            f"z={z}, n={n}, group={G}, {msg_bytes}-byte messages need {wiring_b + stream} B "
            "on the stream route")
    c = 1
    while (wiring_b + (c + 1) * per <= SMEM_LIMIT and (c + 1) * lanes <= MAX_THREADS
           and (batch + c) // (c + 1) >= n_sm):
        c += 1
    threads = min(MAX_THREADS, -(-c * lanes // 32) * 32)
    if layered and G == 1 and route == "stream" and c == 1 and 2 * z <= PAIR_THREADS:
        route, threads = "pair", -(-2 * z // 32) * 32
    return LaunchPlan(route=route, cpb=c, threads=threads, blocks=-(-batch // c),
                      smem=wiring_b + c * per, scratch=0 if route == "chip" else mb * stride,
                      per_cw=per)


def check_args(ch: torch.Tensor, plan, group: int):
    """Validate what the LDPC kernels take; returns (device, Wiring)."""
    device = check_cuda_f32(ch=ch)
    w = wiring(plan, device)
    n = w.nb * w.z
    if ch.dim() != 2 or ch.shape[1] != n or ch.shape[0] < 1:
        raise ValueError(f"ch must be (B >= 1, n={n}), got {tuple(ch.shape)}")
    if w.d > MAX_DEGREE:
        raise ValueError(f"the kernels take check rows of degree <= {MAX_DEGREE}, got {w.d}")
    if w.mb >= MAX_ROWS:
        raise ValueError(f"the kernels take fewer than {MAX_ROWS} check rows, got {w.mb}")
    if 4 * n > SMEM_LIMIT:
        raise ValueError(f"the posterior ({4 * n} B) must fit one block's shared memory "
                         f"({SMEM_LIMIT} B)")
    if group < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    return device, w


def prepare(w: Wiring, device, batch: int, msg_bytes: int, layered: bool, group: int):
    """(LaunchPlan, record scratch or None) of a launch on `device`: the plan
    for its SM count, its shared memory checked against SMEM_LIMIT, and the
    stream route's uint8 scratch (batch x plan.scratch bytes)."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    lp = launch_plan(w, batch, msg_bytes, layered, group, n_sm)
    if lp.smem > SMEM_LIMIT:
        raise ValueError(f"launch needs {lp.smem} B of shared memory, a block has {SMEM_LIMIT}")
    rec = (torch.empty(batch * lp.scratch, dtype=torch.uint8, device=device)
           if lp.scratch else None)
    return lp, rec


def ldpc_posterior(ch: torch.Tensor, plan, n_iters: int, norm: float,
                   schedule: str = "flooding", group: int = 1) -> torch.Tensor:
    """Normalized min-sum posterior of (B, n) channel LLRs after `n_iters`
    flooding or layered sweeps (`group` rows per snapshot). CPU tensors go
    through the plain version; CUDA tensors launch the kernel."""
    if schedule not in ("flooding", "layered"):
        raise ValueError(f"schedule must be 'flooding' or 'layered', got {schedule!r}")
    if ch.device.type == "cpu":
        return ldpc_posterior_plain(ch, plan, n_iters, norm, schedule, group)
    if ch.device.type != "cuda":
        raise ValueError(f"ldpc_posterior runs on CPU or CUDA tensors, not {ch.device}")
    device, w = check_args(ch, plan, group)
    B = ch.shape[0]
    layered = schedule == "layered"
    g = min(group, w.mb)
    _, rec = prepare(w, device, B, 4, layered, g)
    out = torch.empty_like(ch)
    launch("ldpc_posterior", bind("ldpc", "srs_ldpc_posterior_f32", _ARGTYPES), device,
           ch.data_ptr(), out.data_ptr(), None if rec is None else rec.data_ptr(), None,
           w.table.data_ptr(), B, w.n_edges, w.mb, w.nb, w.z, w.d, int(n_iters), float(norm),
           int(layered), g)
    global launches
    launches += 1
    return out
