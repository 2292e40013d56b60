"""Batched QC-LDPC soft decoder (normalized min-sum) + GF(2) systematic encoder.

The port's counterpart of `srsran_ce_tpu/ops/ldpc.py`. The numpy half (the
code and plan classes, the encoders, the routing models and the float64
`decode_reference`) is a copy of the JAX package's, held bit-identical to it
by tests/test_torch_ldpc.py: the port cannot import the JAX package, whose
`__init__` imports `jax`. The device half is `build_decoder`, over the JAX
package's tiers:

- `"xla"`: the per-edge unroll in plain PyTorch, every cyclic shift a
  slice-and-cat over z, the posterior summed in edge order (it is K4's plain
  flooding, `ops/kernels/ldpc.flooding_plain`);
- `"xla_gather"`: one index gather and one `index_add_` per sweep;
- `"pallas"`: K4 `ops/kernels/ldpc.ldpc_posterior` (csrc/ldpc.cu), all
  flooding or (grouped) layered sweeps in one launch, bit-identical to
  `"xla"`;
- `"pallas_stream"`: K3 `ops/kernels/ldpc_stream.ldpc_stream_posterior`
  (csrc/ldpc_stream.cu), layered, messages in float32 or bfloat16;
- `"auto"`: the JAX package's routing, "accelerator" meaning a CUDA device.

The routing models (`_pallas_layout`, `_stream_layout`, the unroll budget)
are the JAX package's TPU models, kept so that `auto`, the gates and
`default_layered_group` pick what the JAX package picks; the port's kernels
choose their own layout. On a CUDA tensor the kernel tiers launch their
kernels (float32 only) or raise; on the CPU, and on any device for the
plain tiers, they run plain PyTorch.

Conventions match the JAX package: LLR > 0 means bit 0 likelier (3GPP
soft-bit sign), so hard decisions are `posterior < 0`; int8 LLRs feed
straight in (cast to float32; min-sum is scale-invariant).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .. import devices
from .kernels import ldpc as _k4
from .kernels import ldpc_stream as _k3

__all__ = [
    "QCLdpcCode",
    "array_code",
    "LdpcPlan",
    "make_ldpc_plan",
    "encode",
    "build_decoder",
    "decode_reference",
    "default_layered_group",
    "select_tier",
    "DecodeResult",
]

_BIG = 1e30  # mask value for padded check-node slots (never wins a min)


@dataclass(frozen=True)
class QCLdpcCode:
    """A quasi-cyclic LDPC code: `base[i][j]` is -1 (no block) or a cyclic
    shift in [0, z); the parity-check matrix is the base matrix with every
    entry s expanded to the ZxZ identity rolled so row a has its one at
    column (a + s) mod z. Frozen + hashable -> plan/jit cache key (the same
    pattern as config.EstimatorConfig)."""

    base: Tuple[Tuple[int, ...], ...]
    z: int

    @property
    def n_check_blocks(self) -> int:
        return len(self.base)

    @property
    def n_var_blocks(self) -> int:
        return len(self.base[0])

    @property
    def n(self) -> int:
        """Codeword length in bits."""
        return self.n_var_blocks * self.z

    @property
    def k(self) -> int:
        """Information length in bits (n - rank(H); QC expansions can be
        rank-deficient, e.g. array codes lose mb-1 dependent rows)."""
        return make_ldpc_plan(self).k


def array_code(n_check_blocks: int, n_var_blocks: int, z: int) -> QCLdpcCode:
    """Fossorier array-LDPC construction: shift(i, j) = (i * j) mod z with z
    prime and n_var_blocks <= z gives a (n_check_blocks, n_var_blocks)-regular
    QC code of girth >= 6. A solid classical family; NR base graphs (TS 38.212
    tables 5.3.2-2/-3) plug into QCLdpcCode directly when available."""
    assert 2 <= n_check_blocks <= n_var_blocks <= z, (n_check_blocks, n_var_blocks, z)
    assert all(z % p for p in range(2, int(z**0.5) + 1)), f"z={z} must be prime"
    base = tuple(
        tuple((i * j) % z for j in range(n_var_blocks)) for i in range(n_check_blocks)
    )
    return QCLdpcCode(base=base, z=z)


def load_base_graph(path, z: int) -> QCLdpcCode:
    """Load a QC base graph from JSON and lift at Z = `z`.

    Format: {"base": [[...], ...]} (or a bare 2-D list), entries -1 for "no
    block" or a shift value; shifts are reduced mod z, the TS 38.212 §5.3.2
    lifting rule (the spec tables give V_{i,j} for the max Z of a set; the
    applied shift is V mod Z). This is the drop-in point for the NR BG1/BG2
    tables — not bundled here because the spec tables are unavailable in this
    environment; export them to JSON and every decoder tier (XLA, both pallas
    layouts), the encoder and the transport layer work unchanged."""
    import json
    import pathlib

    raw = json.loads(pathlib.Path(path).read_text())
    base = raw["base"] if isinstance(raw, dict) else raw
    rows = tuple(
        tuple(-1 if int(s) < 0 else int(s) % int(z) for s in row) for row in base
    )
    assert len({len(r) for r in rows}) == 1, "ragged base matrix"
    return QCLdpcCode(base=rows, z=int(z))


def _expand_h(code: QCLdpcCode) -> np.ndarray:
    """Dense (m, n) uint8 parity-check matrix (plan-time only)."""
    mb, nb, z = code.n_check_blocks, code.n_var_blocks, code.z
    h = np.zeros((mb * z, nb * z), np.uint8)
    rows = np.arange(z)
    for i in range(mb):
        for j, s in enumerate(code.base[i]):
            if s >= 0:
                h[i * z + rows, j * z + (rows + s) % z] = 1
    return h


def _detect_nr_structure(code: QCLdpcCode):
    """Detect the NR base-graph encoding structure (TS 38.212 §5.3.2 shape):
    kb = nb - mb systematic block-columns, 4 core parity columns kb..kb+3 where
    col kb has 3 entries in the first 4 rows (two shifts equal, one unique) and
    cols kb+1..kb+3 form the shift-0 double-diagonal staircase, then an identity
    parity extension (row i >= 4 owns col kb+i at shift 0 and touches only
    columns < kb+4 otherwise). Returns the unique col-kb shift, or None.

    This is what makes encoding O(edges * z) instead of a dense GF(2)
    elimination of the expanded H — for BG1 at Z=384 (n=26112) the dense path
    is minutes of plan build and a 17664x8448 dense generator; the structured
    path is a handful of np.rolls. Official 3GPP tables and ops/nr_ldpc's
    structured stand-ins both satisfy it.
    """
    mb, nb, z = code.n_check_blocks, code.n_var_blocks, code.z
    kb = nb - mb
    if kb < 1 or mb < 5:
        return None
    base = [list(r) for r in code.base]
    # only the CORE rows 0..3 constrain the staircase/col-kb patterns —
    # extension rows may (and in the official tables do) also touch the core
    # parity columns; they are handled after p0..p3 are known.
    col4 = lambda j: [(i, base[i][j]) for i in range(4) if base[i][j] >= 0]
    stair = ({(0, 0), (1, 0)}, {(1, 0), (2, 0)}, {(2, 0), (3, 0)})
    for j, want in zip(range(kb + 1, kb + 4), stair):
        if set(col4(j)) != want:
            return None
    # col kb: 3 entries in the core rows, two equal shifts + one unique
    ckb = col4(kb)
    if len(ckb) != 3:
        return None
    shifts = sorted(s for _, s in ckb)
    if shifts[0] == shifts[1] and shifts[1] != shifts[2]:
        s_unique = shifts[2]
    elif shifts[1] == shifts[2] and shifts[0] != shifts[1]:
        s_unique = shifts[0]
    else:
        return None
    # core rows confined to cols < kb+4; extension rows = identity + cols < kb+4
    for i in range(4):
        if any(base[i][j] >= 0 for j in range(kb + 4, nb)):
            return None
    for i in range(4, mb):
        if base[i][kb + i] != 0:
            return None
        if any(base[i][j] >= 0 for j in range(kb + 4, nb) if j != kb + i):
            return None
    return s_unique


def _roll_last(x: np.ndarray, s: int) -> np.ndarray:
    return np.roll(x, s, axis=-1)


def _encode_structured(code: QCLdpcCode, s_unique: int, u: np.ndarray) -> np.ndarray:
    """NR-structured systematic encode (see _detect_nr_structure): core parity
    p0 by XORing the 4 core rows (staircase cancels pairwise, the two equal
    col-kb shifts cancel, leaving P^{s_unique} p0 = sum of core syndromes),
    then p1..p3 by the staircase recurrence, then the identity extension."""
    mb, nb, z = code.n_check_blocks, code.n_var_blocks, code.z
    kb = nb - mb
    base = code.base
    u = np.asarray(u, np.uint8)
    lead = u.shape[:-1]
    s_blk = u.reshape(lead + (kb, z))

    def syndrome(i, blocks):
        """XOR_j roll(x_j, -shift_ij) over the given {col: bits} dict."""
        acc = np.zeros(lead + (z,), np.uint8)
        for j, x in blocks.items():
            sh = base[i][j]
            if sh >= 0:
                acc ^= _roll_last(x, -sh)
        return acc

    sys_blocks = {j: s_blk[..., j, :] for j in range(kb)}
    lam = [syndrome(i, sys_blocks) for i in range(4)]
    p0 = _roll_last(lam[0] ^ lam[1] ^ lam[2] ^ lam[3], s_unique)
    t = []
    for i in range(3):
        ti = lam[i]
        if base[i][kb] >= 0:
            ti = ti ^ _roll_last(p0, -base[i][kb])
        t.append(ti)
    p1 = t[0]
    p2 = t[1] ^ p1
    p3 = t[2] ^ p2
    par = {kb: p0, kb + 1: p1, kb + 2: p2, kb + 3: p3}
    out = np.zeros(lead + (nb, z), np.uint8)
    out[..., :kb, :] = s_blk
    for j, x in par.items():
        out[..., j, :] = x
    for i in range(4, mb):
        out[..., kb + i, :] = syndrome(i, {**sys_blocks, **par})
    return out.reshape(lead + (nb * z,))


class LdpcPlan:
    """Static decode/encode tables for one code (all numpy, built once).

    Decoder wiring (check frame, D = max check degree in blocks):
      slot_var   (mb, D)    int32  variable-block index per slot (0 for pads)
      slot_shift (mb, D)    int32  cyclic shift per slot
      slot_valid (mb, D)    bool   real edge?
      edges                 list of (check_block, slot, var_block, shift) for
                            every real edge, row-major — the static unroll
                            order shared by the TPU decoder and the numpy
                            reference (same order => same float association)
    Check lane a of block row i reads variable (var, (a + shift) mod z); in
    the batch-last layout that is roll(var_block, -shift) on the z axis, and
    the transpose direction (variable p accumulating check messages) is
    roll(+shift).
    Encoder (GF(2) reduced row echelon of the expanded H):
      info_cols   (k,)      non-pivot columns = systematic info positions
      parity_cols (rank,)   pivot columns
      parity_gen  (rank, k) uint8: codeword[parity_cols] = parity_gen @ u mod 2
    """

    def __init__(self, code: QCLdpcCode):
        mb, nb, z = code.n_check_blocks, code.n_var_blocks, code.z
        self.code = code
        degs = [sum(s >= 0 for s in row) for row in code.base]
        assert min(degs) >= 2, "degree-1 check rows are not a valid LDPC"
        d = max(degs)
        self.max_degree = d
        self.slot_var = np.zeros((mb, d), np.int32)
        self.slot_shift = np.zeros((mb, d), np.int32)
        self.slot_valid = np.zeros((mb, d), bool)
        for i, row in enumerate(code.base):
            t = 0
            for j, s in enumerate(row):
                if s >= 0:
                    self.slot_var[i, t] = j
                    self.slot_shift[i, t] = s
                    self.slot_valid[i, t] = True
                    t += 1
        self.edges = [
            (i, t, int(self.slot_var[i, t]), int(self.slot_shift[i, t]))
            for i in range(mb)
            for t in range(d)
            if self.slot_valid[i, t]
        ]

        # --- systematic encoder ---
        self.nr_structure = _detect_nr_structure(code)
        if self.nr_structure is not None:
            # NR shape: full-rank by construction (double diagonal + identity
            # extension are triangular in the parity part); encode() goes
            # through the O(edges * z) structured path, no dense elimination.
            self.rank = mb * z
            self.k = (nb - mb) * z
            self.info_cols = np.arange(self.k, dtype=np.int64)
            self.parity_cols = np.arange(self.k, nb * z, dtype=np.int64)
            self.parity_gen = None
            return

        # generic QC codes: GF(2) reduced row echelon of the expanded H
        h = _expand_h(code)
        m, n = h.shape
        r = 0
        pivots = []
        for c in range(n):
            hit = np.nonzero(h[r:, c])[0]
            if hit.size == 0:
                continue
            p = r + hit[0]
            if p != r:
                h[[r, p]] = h[[p, r]]
            elim = np.nonzero(h[:, c])[0]
            elim = elim[elim != r]
            h[elim] ^= h[r]
            pivots.append(c)
            r += 1
            if r == m:
                break
        self.rank = r
        self.parity_cols = np.asarray(pivots, np.int64)
        mask = np.ones(n, bool)
        mask[self.parity_cols] = False
        self.info_cols = np.nonzero(mask)[0]
        self.k = n - r
        # row i of the RREF: c[pivot_i] + sum_j R[i, info_j] c[info_j] = 0
        self.parity_gen = h[: self.rank][:, self.info_cols].copy()


@functools.lru_cache(maxsize=None)
def make_ldpc_plan(code: QCLdpcCode) -> LdpcPlan:
    return LdpcPlan(code)


def encode(code: QCLdpcCode, u: np.ndarray) -> np.ndarray:
    """Systematic encode: info bits u (..., k) in {0,1} -> codewords (..., n)
    in the natural (decoder) bit order; `plan.info_cols` positions carry u
    verbatim. Host-side numpy (transmitters live on the host in this
    framework, like demap.modulate)."""
    plan = make_ldpc_plan(code)
    u = np.asarray(u, np.uint8)
    assert u.shape[-1] == plan.k, (u.shape, plan.k)
    if plan.nr_structure is not None:
        return _encode_structured(code, plan.nr_structure, u)
    c = np.zeros(u.shape[:-1] + (code.n,), np.uint8)
    c[..., plan.info_cols] = u
    c[..., plan.parity_cols] = (u @ plan.parity_gen.T) % 2
    return c


@dataclass
class DecodeResult:
    """bits: hard decisions (..., n) uint8; info: (..., k) uint8 systematic
    payload; ok: (...) bool — parity check satisfied (all syndromes zero);
    posterior: (..., n) float soft outputs (same sign convention as input).
    Tensors on the device the LLRs were decoded on."""

    bits: torch.Tensor
    info: torch.Tensor
    ok: torch.Tensor
    posterior: torch.Tensor


# Live-row model vs the ~16 MB scoped-vmem compiler limit: the measured stack
# allocation runs ~2x the model (the sweep's transient v2c/acc values overlap
# the carry), so the model budget is half the hardware limit with margin.
_PALLAS_VMEM_BUDGET = 7 * 2**20

# the streamed kernel's own budget — measured looser than the unrolled
# kernels' half-limit rule (see _stream_layout's calibration note)
_STREAM_VMEM_BUDGET = 9 * 2**20


def _pallas_live_rows(code: QCLdpcCode) -> int:
    """Live (z,)-row count of the VMEM-resident kernel per batch tile: one
    row per edge (the c2v carry) + 2*nb rows (ch + posterior accumulator).
    Computed straight off the base matrix — the layout gate must not force a
    plan build (the plan's GF(2) elimination is expensive for huge codes that
    are only being REJECTED here)."""
    n_edges = sum(s >= 0 for row in code.base for s in row)
    return n_edges + 2 * code.n_var_blocks


def _pallas_layout(code: QCLdpcCode):
    """Pick the VMEM-resident kernel layout for this code, or None if even
    the smallest tile exceeds the scoped-VMEM budget.

    Returns (z_axis, block_b): sublane-z (z_axis=0, 128-lane batch tile, the
    fast layout) when the live set fits; otherwise lane-z (z_axis=1) with the
    largest batch-sublane tile in {32, 16, 8} that fits — Z moves to the lane
    dim so the live set shrinks with the tile instead of being padded to 128
    lanes."""
    rows = _pallas_live_rows(code)
    z8 = -(-code.z // 8) * 8
    if rows * z8 * 128 * 4 <= _PALLAS_VMEM_BUDGET:
        return (0, 128)
    z128 = -(-code.z // 128) * 128
    for block_b in (32, 16, 8):
        if rows * block_b * z128 * 4 <= _PALLAS_VMEM_BUDGET:
            return (1, block_b)
    return None


def _pallas_vmem_fits(code: QCLdpcCode) -> bool:
    return _pallas_layout(code) is not None


def _stream_layout(code: QCLdpcCode, c2v_bf16: bool = False, group: int = 1):
    """Pick the streamed tier's batch tile, or None if even the smallest tile
    blows the VMEM budget. Z is padded to whole 128-lane registers inside the
    kernel (round-5: the dynamic `pltpu.roll` lane rotation needs
    whole-register lengths, so the kernel rotates the padded axis twice and
    lane-selects — ANY lifting size is now eligible; the round-4 z%128 gate
    left BG1 Z∈{192..352} on the 3 Mb/s gather tier).

    Live set per tile: c2v scratch (n_edges+1 rows, f32 or bf16) + the in/out
    L tiles (2*nb rows f32), all (block_b, z_pad). Grouped layering (G rows
    per posterior snapshot) adds ~3*G*d transient rows of stack. The budget
    is calibrated by on-chip measurement (round 5, nr_ldpc BG1 stand-in,
    408 edges): f32 block 16 (13.4 MB model) fails the Mosaic compile while
    bf16 block 16 (8.4 MB model) compiles and runs payload-exact at
    358 Mb/s — the streamed kernel's transients are leaner than the unrolled
    kernel's, so it gets its own 9 MB budget rather than the 7 MB
    half-limit rule."""
    z_pad = -(-code.z // 128) * 128
    n_edges = sum(s >= 0 for row in code.base for s in row)
    d = max(sum(s >= 0 for s in row) for row in code.base)
    c2v_item = 2 if c2v_bf16 else 4
    per_col = (n_edges + 1) * c2v_item + 2 * code.n_var_blocks * 4
    per_col += 3 * max(0, group - 1) * d * 4  # grouped-snapshot transients
    for block_b in (32, 16, 8):
        if per_col * block_b * z_pad <= _STREAM_VMEM_BUDGET:
            return block_b
    return None


def _stream_supported(
    code: QCLdpcCode, group: int = 1, c2v_bf16: bool = False
) -> bool:
    return _stream_layout(code, c2v_bf16=c2v_bf16, group=group) is not None


def _stream_vmem_bytes(code: QCLdpcCode, group: int = 1, c2v_bf16: bool = False) -> int:
    """Smallest-tile (block 8) footprint of the STREAM model — for error text."""
    z_pad = -(-code.z // 128) * 128
    n_edges = sum(s >= 0 for row in code.base for s in row)
    d = max(sum(s >= 0 for s in row) for row in code.base)
    per_col = (n_edges + 1) * (2 if c2v_bf16 else 4) + 2 * code.n_var_blocks * 4
    per_col += 3 * max(0, group - 1) * d * 4
    return per_col * 8 * z_pad


# Compile-budget bound for the STATIC-UNROLL formulations (both the XLA tier's
# per-edge roll/concat unroll and the Pallas kernel's in-body edge sweep):
# program build/compile time grows with edges and with the per-edge operand
# size, and at NR-BG1 Z=384 (316 edges x z=384) both tiers ran past 9 minutes
# in this environment. Codes over this edge*z budget route to the GATHER
# formulation below — one precomputed-index gather + one scatter-add per
# sweep, program size O(1) in edges. Calibrated against the measured-good
# rows: BG1 Z=52 (16k, fine) and BG2 Z=208 (41k, fine) stay unrolled.
_UNROLL_EDGE_Z_BUDGET = 60_000


def _edge_z(code: QCLdpcCode) -> int:
    n_edges = sum(s >= 0 for row in code.base for s in row)
    return n_edges * code.z


def _pallas_vmem_bytes(code: QCLdpcCode) -> int:
    """Smallest-tile footprint (lane-z, 8-row batch tile) — for error text."""
    return _pallas_live_rows(code) * 8 * (-(-code.z // 128) * 128) * 4


def default_layered_group(code: QCLdpcCode) -> int:
    """Measured-rule layered_group for the VMEM-resident layered tiers
    (round-5 verdict item 8: pick G per code, don't pin a global constant).

    Sublane-z codes (small/medium Z, 128-lane batch tiles) keep G=1: the
    serial layered walk already sustains ~2x there (ARCHITECTURE.md). Lane-z
    codes run narrow batch tiles where the serial row chain starves the VPU;
    the v5e sweep measured, vs flooding at matched quality:
      BG2 Z=208 (z_pad 256): G=1 1.76x, G=4 2.8x, G=8 3.0x  -> wide z: G=8
      BG1 Z=52  (z_pad 128): G=1 1.5x,  G=2 2.4x, G=4 2.25x -> one-reg z: G=2
    Streamed-tier codes (over the unroll budget) return G=1 — measured on
    chip at Z=240: G=2 was within relay noise (174 vs 168 Mb/s) and the
    snapshot transients shrink the admissible batch tile. The bench records
    the chosen G per row."""
    if _edge_z(code) > _UNROLL_EDGE_Z_BUDGET:
        # streamed tier: G=1. Measured round 5 (BG1 Z=240, block 8): G=2 gave
        # 174 vs 168 Mb/s — within relay noise — while costing snapshot
        # transients that shrink the admissible batch tile; the streamed
        # walk's per-row work (d slots x full lane rows) already feeds the
        # VPU, unlike the unrolled lane-z kernel's narrow-tile rows.
        return 1
    lay = _pallas_layout(code)
    if lay is not None and lay[0] == 0:
        return 1
    z_pad = -(-code.z // 128) * 128
    return 8 if z_pad >= 256 else 2


def select_tier(
    code: QCLdpcCode,
    kernels: str = "auto",
    schedule: str = "flooding",
    layered_group: int = 1,
    stream_c2v_dtype: Optional[str] = None,
    accelerator: bool = True,
) -> str:
    """The tier `build_decoder` runs for these arguments: the JAX package's
    routing and gates (its `build_decoder`), with `accelerator` (a CUDA
    device) in place of "the JAX backend is not the CPU". Raises the same
    ValueErrors.

    "auto" picks: for codes over the unroll budget (edge*z > 60k), the
    streamed tier when the schedule is layered (on an accelerator, within the
    streamed model), else the gather tier; otherwise "pallas" on an
    accelerator when the VMEM-resident model fits, "xla" elsewhere. The
    layered schedule exists only in the kernel tiers, so "xla" and
    "xla_gather" with schedule="layered" take "pallas" or "pallas_stream"."""
    if kernels not in ("xla", "xla_gather", "pallas", "pallas_stream", "auto"):
        raise ValueError(f"unknown kernels={kernels!r}")
    if schedule not in ("flooding", "layered"):
        raise ValueError(f"unknown schedule={schedule!r}")
    bf16 = stream_c2v_dtype == "bfloat16"
    if kernels == "auto":
        if _edge_z(code) > _UNROLL_EDGE_Z_BUDGET:
            if schedule == "layered":
                if not _stream_supported(code, layered_group, bf16) or not accelerator:
                    raise ValueError(
                        "schedule='layered' needs the streamed pallas tier "
                        f"(edge*z={_edge_z(code)} over the unroll budget), which "
                        "requires an accelerator and a lane-z VMEM fit"
                    )
                kernels = "pallas_stream"
            else:
                kernels = "xla_gather"
        else:
            kernels = "pallas" if _pallas_vmem_fits(code) and accelerator else "xla"
    if kernels == "pallas_stream":
        if schedule != "layered":
            raise ValueError("kernels='pallas_stream' implements the layered schedule only")
        if not _stream_supported(code, layered_group, bf16):
            raise ValueError(
                "streamed pallas tier needs a lane-z VMEM fit (live messages "
                f"+ group transients): z={code.z}, layered_group={layered_group}, "
                f"stream model ~{_stream_vmem_bytes(code, layered_group, bf16)/2**20:.1f} MB "
                f"> the {_STREAM_VMEM_BUDGET/2**20:.0f} MB budget "
                "(stream_c2v_dtype='bfloat16' halves the message set)"
            )
    elif schedule == "layered" and kernels != "pallas":
        if _edge_z(code) <= _UNROLL_EDGE_Z_BUDGET:
            if not _pallas_vmem_fits(code):
                raise ValueError("schedule='layered' needs a pallas tier; code too large")
            kernels = "pallas"
        else:
            if not _stream_supported(code, layered_group, bf16):
                raise ValueError(
                    "schedule='layered' on a code over the unroll budget needs "
                    "the streamed tier (lane-z VMEM fit incl. group transients)"
                )
            kernels = "pallas_stream"
    elif kernels == "pallas" and not _pallas_vmem_fits(code):
        raise ValueError(
            "code too large for the VMEM-resident pallas tier: smallest tile "
            f"(lane-z, 8-row batch) needs ~{_pallas_vmem_bytes(code)/2**20:.1f} MB "
            f"live messages > the {_PALLAS_VMEM_BUDGET/2**20:.0f} MB model budget "
            "(half the 16 MB scoped-vmem limit); use kernels='xla' or 'auto'"
        )
    return kernels


def _gather_flooding(ch, w, n_iters: int, norm: float) -> torch.Tensor:
    """The "xla_gather" tier: one index gather builds the check frame, one
    `index_add_` (its transpose) the posterior. Padded slots read and add to
    bit 0 (their messages are 0)."""
    B = ch.shape[0]
    shape = (B, w.mb, w.d, w.z)

    def accum(c2v):
        return ch.clone().index_add_(1, w.slot_gidx, c2v.reshape(B, -1))

    c2v = ch.new_zeros(shape)
    for _ in range(n_iters):
        c2v = _k4.check_update(accum(c2v)[:, w.slot_gidx].reshape(shape) - c2v, w.valid, norm)
    return accum(c2v)


def _parity_ok(bits: torch.Tensor, w) -> torch.Tensor:
    """(B,) True where every check of the (B, n) hard decisions is satisfied:
    each check lane's bits summed over its row's edges (row-major, so a row's
    sum is the difference of two running sums over the edges)."""
    run = bits[:, w.gidx].to(torch.int32).cumsum(1, dtype=torch.int32)  # (B, E, z)
    run = torch.nn.functional.pad(run, (0, 0, 1, 0))
    par = run[:, w.row_hi] - run[:, w.row_lo]  # (B, mb, z)
    return (par % 2 == 0).flatten(1).all(dim=1)


@functools.lru_cache(maxsize=64)
def build_decoder(
    code: QCLdpcCode,
    n_iters: int = 20,
    norm: float = 0.75,
    kernels: str = "xla",
    schedule: str = "flooding",
    layered_group: int = 1,
    stream_c2v_dtype: Optional[str] = None,
    device="cuda",
):
    """Build the normalized-min-sum decoder of `code` (lru-cached per
    arguments): `decode(llr) -> DecodeResult`.

    `llr` is (..., n) channel LLRs, float or int8 (positive = bit 0), numpy or
    a tensor; any leading axes batch. A numpy array goes to `device` (the card
    by default; raises when there is none); a tensor stays on its own device,
    and the result comes back there. The LLRs are promoted to at least
    float32. `norm` is the min-sum normalization (0.75 the standard choice,
    1.0 pure min-sum); `n_iters` sweeps of `schedule` ("flooding", or
    "layered" in groups of `layered_group` rows per posterior snapshot);
    `ok` is the parity check of the final hard decisions.
    `decode.posterior(llr)` returns the posterior alone (what the JAX
    package's compiler keeps of `decode(llr).posterior`: the bench's chains).

    Tiers (`kernels`, routed by `select_tier` as the JAX package routes them):
    "xla" (plain per-edge unroll), "xla_gather" (plain index gather and
    `index_add_`), "pallas" (K4, bit-identical to "xla" in flooding),
    "pallas_stream" (K3, layered only; `stream_c2v_dtype="bfloat16"` stores
    the messages in bfloat16) and "auto". On a CUDA tensor the kernel tiers
    take float32 and launch their kernel or raise; elsewhere they run their
    plain versions."""
    device = devices.resolve(device)
    tier = select_tier(code, kernels, schedule, layered_group, stream_c2v_dtype,
                       accelerator=device.type == "cuda")
    if tier == "pallas_stream":
        _k3.message_dtype(stream_c2v_dtype)
    plan = make_ldpc_plan(code)
    n = code.n

    def run(llr):
        x = llr if isinstance(llr, torch.Tensor) else torch.as_tensor(np.asarray(llr), device=device)
        if x.dim() < 1 or x.shape[-1] != n:
            raise ValueError(f"llr must be (..., n={n}), got {tuple(x.shape)}")
        lead = tuple(x.shape[:-1])
        ch = x.reshape(-1, n).to(torch.promote_types(x.dtype, torch.float32)).contiguous()
        w = _k4.wiring(plan, ch.device)
        if tier == "pallas_stream":
            post = _k3.ldpc_stream_posterior(ch, plan, n_iters, norm, group=layered_group,
                                             c2v_dtype=stream_c2v_dtype)
        elif tier == "pallas":
            post = _k4.ldpc_posterior(ch, plan, n_iters, norm, schedule=schedule,
                                      group=layered_group)
        elif tier == "xla":
            post = _k4.flooding_plain(ch, plan, w, n_iters, norm)
        else:
            post = _gather_flooding(ch, w, n_iters, norm)
        return post, lead, w

    def posterior(llr) -> torch.Tensor:
        post, lead, _ = run(llr)
        return post.reshape(lead + (n,))

    def decode(llr) -> DecodeResult:
        post, lead, w = run(llr)
        bits = (post < 0).to(torch.uint8)
        return DecodeResult(
            bits=bits.reshape(lead + (n,)),
            info=bits[:, w.info_cols].reshape(lead + (plan.k,)),
            ok=_parity_ok(bits, w).reshape(lead),
            posterior=post.reshape(lead + (n,)),
        )

    decode.tier = tier
    decode.posterior = posterior
    return decode


def decode_reference(
    code: QCLdpcCode,
    llr: np.ndarray,
    n_iters: int = 20,
    norm: float = 0.75,
    schedule: str = "flooding",
    layered_group: int = 1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Float64 numpy flooding normalized-min-sum with the identical schedule
    (same edge order, same per-variable summation association as the
    batch-last TPU decoder) — the correctness anchor for `build_decoder`
    (same role utils/oracle.py plays for the estimator). Returns
    (bits (..., n) uint8, ok (...) bool, posterior (..., n) float64)."""
    plan = make_ldpc_plan(code)
    mb, nb, d, z = code.n_check_blocks, code.n_var_blocks, plan.max_degree, code.z
    edges = plan.edges
    valid = plan.slot_valid[None, :, :, None]
    lead = np.asarray(llr).shape[:-1]
    ch = np.asarray(llr, np.float64).reshape(-1, nb, z)
    b = ch.shape[0]

    def accum(c2v):  # (b, mb, d, z) -> (b, nb, z)
        acc = ch.copy()
        for i, t, j, s in edges:
            acc[:, j] += np.roll(c2v[:, i, t], s, axis=-1)
        return acc

    def gather(post):  # (b, nb, z) -> (b, mb, d, z)
        out = np.zeros((b, mb, d, z), post.dtype)
        for i, t, j, s in edges:
            out[:, i, t] = np.roll(post[:, j], -s, axis=-1)
        return out

    c2v = np.zeros((b, mb, d, z))
    if schedule == "layered":
        # row-serial mirror of the pallas layered sweep: identical row order,
        # identical two-min/tie semantics (np.argmin = first minimum)
        L = ch.copy()
        cv = {e: np.zeros((b, z)) for e in range(len(edges))}
        row_eids = [[e for e, (i2, _, _, _) in enumerate(edges) if i2 == i] for i in range(mb)]
        for _ in range(n_iters):
            for g0 in range(0, mb, layered_group):
                chunk = range(g0, min(g0 + layered_group, mb))
                upds = {}
                for i in chunk:
                    eids = row_eids[i]
                    v2c = np.stack(
                        [np.roll(L[:, edges[e][2]], -edges[e][3], axis=-1) - cv[e] for e in eids],
                        axis=1,
                    )  # (b, deg, z)
                    mag = np.abs(v2c)
                    neg = v2c < 0
                    i_min = np.argmin(mag, axis=1)
                    onehot = np.arange(len(eids))[:, None] == i_min[:, None, :]
                    min1 = np.min(mag, axis=1, keepdims=True)
                    min2 = np.min(np.where(onehot, _BIG, mag), axis=1, keepdims=True)
                    ext = np.where(onehot, min2, min1)
                    par = np.logical_xor.reduce(neg, axis=1, keepdims=True)
                    sgn = 1.0 - 2.0 * np.logical_xor(par, neg)
                    upds[i] = norm * sgn * ext
                for i in chunk:
                    for t_, e in enumerate(row_eids[i]):
                        j, s = edges[e][2], edges[e][3]
                        L[:, j] += np.roll(upds[i][:, t_] - cv[e], s, axis=-1)
                        cv[e] = upds[i][:, t_]
        posterior = L.reshape(b, code.n)
        bits = (posterior < 0).astype(np.uint8)
        par2 = np.sum(gather(bits.reshape(b, nb, z).astype(np.int64)) * valid, axis=-2) % 2
        ok = ~np.any(par2, axis=(-2, -1))
        return (
            bits.reshape(lead + (code.n,)),
            ok.reshape(lead),
            posterior.reshape(lead + (code.n,)),
        )
    for _ in range(n_iters):
        post = accum(c2v)
        v2c = gather(post) - c2v
        mag = np.where(valid, np.abs(v2c), _BIG)
        sgn = np.where(valid & (v2c < 0), -1.0, 1.0)
        ext_sign = np.prod(sgn, axis=-2, keepdims=True) * sgn
        i_min = np.argmin(mag, axis=-2)
        onehot = np.arange(d)[:, None] == i_min[..., None, :]
        min1 = np.min(mag, axis=-2, keepdims=True)
        min2 = np.min(np.where(onehot, _BIG, mag), axis=-2, keepdims=True)
        ext = np.where(onehot, min2, min1)
        c2v = np.where(valid, norm * ext_sign * ext, 0.0)
    posterior = accum(c2v).reshape(b, code.n)
    bits = (posterior < 0).astype(np.uint8)
    par = np.sum(gather(bits.reshape(b, nb, z).astype(np.int64)) * valid, axis=-2) % 2
    ok = ~np.any(par, axis=(-2, -1))
    return (
        bits.reshape(lead + (code.n,)),
        ok.reshape(lead),
        posterior.reshape(lead + (code.n,)),
    )
