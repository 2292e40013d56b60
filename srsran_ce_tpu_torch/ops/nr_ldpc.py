"""TS 38.212 NR LDPC coding chain: lifting sizes, base-graph selection, code-block
segmentation, and §5.4.2 rate matching (circular-buffer bit selection + bit
interleaving) around the generic QC-LDPC engine in ops/ldpc.

A numpy copy of `srsran_ce_tpu/ops/nr_ldpc.py` (the port cannot import the JAX
package, whose `__init__` imports `jax`), held bit-identical to it by
tests/test_torch_ldpc.py; it builds on the port's own `ops/ldpc.py`.

What is SPEC-EXACT here (TS 38.212, V16):
  * the 51-value lifting-size table Z = a * 2^j and its 8 set indices iLS
    (Table 5.3.2-1);
  * base-graph selection (§7.2.2): BG2 iff A <= 292, or (A <= 3824 and R <= 0.67),
    or R <= 0.25;
  * K_b selection for BG2 (§5.2.2): 10 / 9 / 8 / 6 by payload size;
  * code-block segmentation with per-block CRC24B (§5.2.2): K_cb = 8448 (BG1) /
    3840 (BG2), C = ceil(B / (K_cb - 24)) blocks;
  * rate matching (§5.4.2.1): circular buffer d = c[2Z:] (the first 2Z systematic
    bits are never transmitted), N_cb = 66Z (BG1) / 50Z (BG2), starting position
    k0 per redundancy version rv from Table 5.4.2.1-2
    (BG1: {0, 17, 33, 56} * N_cb/66 floored to a multiple of Z;
     BG2: {0, 13, 25, 43} * N_cb/50), filler bits skipped during selection,
    wrap-around repetition when E exceeds the buffer;
  * the bit interleaver (§5.4.2.2): f_{i + j*Qm} = e_{i*(E/Qm) + j}.

What is NOT the official spec data: the base-graph SHIFT COEFFICIENT tables
(Tables 5.3.2-2/-3: 316 + 197 entries x 8 lifting sets). Those ~4,000 arbitrary
constants are not available in this environment and cannot be derived; this module
builds base graphs with the spec's exact STRUCTURE (dimensions 46x68 / 42x52, 22/10
systematic block-columns, 4 core parity columns in the double-diagonal arrangement,
identity parity extension, high-degree first two punctured columns, realistic
degree profiles) and deterministic per-(bg, iLS) pseudorandom shifts. The resulting
codes are valid full-rank NR-shaped QC-LDPC codes that exercise every code path at
the spec's exact geometries (e.g. BG1 Z=384: n=26112 pre-puncture), but they are
NOT bit-compatible with 3GPP encoders. Drop the official tables in via
`ops.ldpc.load_base_graph` (JSON) or pass an explicit shift table to
`nr_base_graph(..., shifts=...)` for bit-exact conformance.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .ldpc import QCLdpcCode

__all__ = [
    "LIFTING_SETS",
    "lifting_sizes",
    "lifting_set_index",
    "select_lifting_size",
    "select_base_graph",
    "base_graph_params",
    "nr_base_graph",
    "load_official_base_graph",
    "export_base_graph_entries",
    "validate_nr_base_graph",
    "segment_payload",
    "desegment_payload",
    "RateMatch",
    "make_rate_match",
]

# Official edge counts of Tables 5.3.2-2 / 5.3.2-3 (number of (i, j) pairs with
# an entry, i.e. ones in the base matrix) — the widely published figures used
# to sanity-check a transcribed table.
OFFICIAL_EDGE_COUNT = {1: 316, 2: 197}

# Table 5.3.2-1: Z = a * 2^j, grouped into 8 sets by a (iLS = row index).
LIFTING_SETS: Tuple[Tuple[int, ...], ...] = (
    (2, 4, 8, 16, 32, 64, 128, 256),
    (3, 6, 12, 24, 48, 96, 192, 384),
    (5, 10, 20, 40, 80, 160, 320),
    (7, 14, 28, 56, 112, 224),
    (9, 18, 36, 72, 144, 288),
    (11, 22, 44, 88, 176, 352),
    (13, 26, 52, 104, 208),
    (15, 30, 60, 120, 240),
)


def lifting_sizes() -> List[int]:
    """All 51 valid NR lifting sizes, ascending."""
    return sorted(z for s in LIFTING_SETS for z in s)


def lifting_set_index(z: int) -> int:
    """iLS of a lifting size (Table 5.3.2-1 row)."""
    for i, s in enumerate(LIFTING_SETS):
        if z in s:
            return i
    raise ValueError(f"{z} is not an NR lifting size")


def base_graph_params(bg: int) -> Tuple[int, int, int]:
    """(m_b check rows, n_b variable columns, k_b systematic columns)."""
    if bg == 1:
        return 46, 68, 22
    if bg == 2:
        return 42, 52, 10
    raise ValueError(f"base graph must be 1 or 2: {bg}")


def select_base_graph(a_bits: int, rate: float) -> int:
    """§7.2.2 base-graph selection for payload size A and target rate R."""
    if a_bits <= 292 or (a_bits <= 3824 and rate <= 0.67) or rate <= 0.25:
        return 2
    return 1


def _kb_for(bg: int, k_prime: int) -> int:
    """§5.2.2: systematic columns actually used for the lifting-size search.

    The spec keys the BG2 thresholds on B (total payload+CRC bits); this keys
    on K' (per-code-block bits). The results coincide everywhere reachable:
    for C == 1, K' == B; for C > 1, segmentation only triggers at B > 3840
    (§5.2.2), which forces K' = B/C + 24 > 640 on every branch — the same
    K_b = 10 the B-keyed rule gives. Keep this equivalence in mind if the
    segmentation thresholds are ever changed."""
    if bg == 1:
        return 22
    if k_prime > 640:
        return 10
    if k_prime > 560:
        return 9
    if k_prime > 192:
        return 8
    return 6


def select_lifting_size(bg: int, k_prime: int) -> int:
    """Smallest valid Z with K_b * Z >= K' (§5.2.2)."""
    kb = _kb_for(bg, k_prime)
    for z in lifting_sizes():
        if kb * z >= k_prime:
            return z
    raise ValueError(f"K'={k_prime} exceeds the largest NR code block (Z=384)")


def validate_nr_base_graph(code: QCLdpcCode, bg: int, strict: bool = True) -> None:
    """Structural conformance gate for a (possibly externally sourced) NR base
    graph: exact spec dimensions, the §5.3.2 encodable shape (double-diagonal
    core + identity extension, checked by ldpc._detect_nr_structure), and —
    strict mode — the official Table 5.3.2-2/-3 edge counts (316 / 197).
    Raises ValueError with a specific message on any violation, so a corrupted
    or mis-transcribed table drop fails loudly instead of decoding garbage."""
    from .ldpc import _detect_nr_structure

    mb, nbv, kb = base_graph_params(bg)
    if (code.n_check_blocks, code.n_var_blocks) != (mb, nbv):
        raise ValueError(
            f"BG{bg} must be {mb}x{nbv} blocks: got "
            f"{code.n_check_blocks}x{code.n_var_blocks}"
        )
    if _detect_nr_structure(code) is None:
        raise ValueError(
            f"BG{bg} table lacks the §5.3.2 encoding structure (double-diagonal "
            "core parity + identity extension) — transcription error?"
        )
    n_edges = sum(s >= 0 for row in code.base for s in row)
    if strict and n_edges != OFFICIAL_EDGE_COUNT[bg]:
        raise ValueError(
            f"BG{bg} has {n_edges} edges, official tables have "
            f"{OFFICIAL_EDGE_COUNT[bg]}; pass strict=False if this is a "
            "deliberately modified graph"
        )


def export_base_graph_entries(bg: int, seed: int = 0) -> dict:
    """Export a base graph family in the OFFICIAL table layout: one entry per
    edge position (i, j) with the shift value V for each of the 8 lifting sets
    (exactly how TS 38.212 Tables 5.3.2-2/-3 are printed). Used to produce the
    JSON golden for the loader test; running it over the official data instead
    of the stand-in shifts is the 3GPP-bit-exactness data drop."""
    mb, nbv, _ = base_graph_params(bg)
    # export at each set's LARGEST Z: every smaller Z in a set divides it
    # (a*2^j series), so (V mod z_max) mod z == V mod z and the reload is
    # exact at every lifting size of the set
    codes = [nr_base_graph(bg, LIFTING_SETS[ils][-1], seed=seed) for ils in range(8)]
    support = [
        (i, j)
        for i in range(mb)
        for j in range(nbv)
        if any(c.base[i][j] >= 0 for c in codes)
    ]
    entries = []
    for i, j in support:
        vs = [int(c.base[i][j]) for c in codes]
        if any(v < 0 for v in vs):
            raise ValueError(f"edge ({i},{j}) missing from some lifting sets")
        entries.append([i, j, vs])
    return {"bg": bg, "entries": entries}


def load_official_base_graph(path, z: int, strict: bool = True) -> QCLdpcCode:
    """Load an NR base graph from the official-table JSON layout and lift at Z.

    Schema (the printed layout of Tables 5.3.2-2/-3):
        {"bg": 1 | 2,
         "entries": [[i, j, [V_iLS0, ..., V_iLS7]], ...]}
    where (i, j) is the (check row, variable column) block position and the
    8-vector gives the shift value V for each lifting set index iLS; the
    applied shift is V mod Z (§5.3.2). Missing (i, j) pairs are no-edge.
    A bare {"bg":..., "shifts": [[...]]} dense (m_b, n_b) single-set table is
    also accepted. The result passes `validate_nr_base_graph` before use, so
    bit-exact 3GPP conformance is exactly one data drop away: serialize the
    official tables into this schema and every tier (XLA unrolled, xla_gather,
    both pallas layouts), the structured encoder, segmentation and §5.4.2 rate
    matching work unchanged."""
    import json
    import pathlib

    raw = json.loads(pathlib.Path(path).read_text())
    bg = int(raw["bg"])
    mb, nbv, _ = base_graph_params(bg)
    if "shifts" in raw:
        shifts = raw["shifts"]
    else:
        ils = lifting_set_index(z)
        table = np.full((mb, nbv), -1, np.int64)
        for i, j, vs in raw["entries"]:
            i, j = int(i), int(j)
            # Fail loudly on corrupted indices: numpy negative indexing would
            # silently wrap an (i, j) like (-3, 70) into a *different* valid
            # edge and (with strict=False) build a wrong but working-looking
            # code (ADVICE r03).
            if not (0 <= i < mb and 0 <= j < nbv):
                raise ValueError(
                    f"entry ({i},{j}) outside the BG{bg} {mb}x{nbv} block grid"
                )
            if len(vs) != 8:
                raise ValueError(
                    f"entry ({i},{j}) has {len(vs)} shift values, need 8 "
                    "(one per lifting set iLS 0..7)"
                )
            if table[i, j] >= 0:
                raise ValueError(f"duplicate entry for edge ({i},{j})")
            table[i, j] = int(vs[ils])
        shifts = table.tolist()
    code = nr_base_graph(bg, z, shifts=shifts)
    validate_nr_base_graph(code, bg, strict=strict)
    return code


def segment_payload(b_bits: int, bg: int) -> Tuple[int, int]:
    """§5.2.2 code-block segmentation: (C blocks, K' bits per block incl. the
    per-block CRC24B when C > 1). b_bits = transport block + its CRC."""
    k_cb = 8448 if bg == 1 else 3840
    if b_bits <= k_cb:
        return 1, b_bits
    c = -(-b_bits // (k_cb - 24))
    return c, -(-b_bits // c) + 24


def desegment_payload(c: int, k_prime: int, b_bits: int) -> int:
    """Payload bits carried per block before the per-block CRC."""
    return k_prime - (24 if c > 1 else 0)


# ---------------------------------------------------------------------------
# NR-structured base graphs
# ---------------------------------------------------------------------------


def nr_base_graph(
    bg: int,
    z: int,
    shifts: Optional[Sequence[Sequence[int]]] = None,
    seed: int = 0,
) -> QCLdpcCode:
    """Build an NR base graph lifted at Z = `z`.

    With `shifts` (an (m_b, n_b) table, -1 for no edge — e.g. the official
    Table 5.3.2-2/-3 data loaded from JSON) this is the exact §5.3.2 lifting
    (applied shift = V mod Z). Without it, the SUPPORT and STRUCTURE follow the
    spec exactly (see module docstring): ONE support per base graph (the
    official tables share the edge pattern across all 8 lifting sets; only the
    V values differ), with deterministic pseudorandom shifts per
    (bg, iLS(z), seed) — same shifts for every Z in a lifting set, mirroring
    how the official tables specialize by set.
    """
    mb, nbv, kb = base_graph_params(bg)
    if z not in set(lifting_sizes()):
        raise ValueError(f"{z} is not an NR lifting size")
    if shifts is not None:
        rows = [list(r) for r in shifts]
        assert len(rows) == mb and all(len(r) == nbv for r in rows), "bad shift table"
        base = tuple(
            tuple(-1 if s < 0 else int(s) % z for s in r) for r in rows
        )
        return QCLdpcCode(base=base, z=z)

    ils = lifting_set_index(z)
    # support is drawn per (bg, seed) ONLY — shared across lifting sets like
    # the official tables; the shift draw below reseeds per (bg, ils, seed)
    rng = np.random.default_rng((bg, seed))
    support = np.zeros((mb, nbv), dtype=bool)

    # Core: 4 rows over the systematic columns + the 4-column double-diagonal
    # parity part (cols kb..kb+3). NR's core rows carry most of the row weight
    # (BG1 rows 0-3 have degree 19); emulate with 19/22 (BG1) or 8/10 (BG2)
    # systematic entries per core row, always including the two punctured
    # high-degree columns 0 and 1.
    core_sys_deg = 19 if bg == 1 else 8
    for i in range(4):
        support[i, 0] = support[i, 1] = True
        extra = rng.choice(np.arange(2, kb), size=core_sys_deg - 2, replace=False)
        support[i, extra] = True
    # Double diagonal: col kb hits rows 0,1,2,3 is NOT the NR shape — NR puts
    # col kb on rows {0,1,3} (weight 3) and cols kb+1..kb+3 on the staircase
    # {0,1}, {1,2}, {2,3}.
    support[0, kb] = support[1, kb] = support[3, kb] = True
    support[0, kb + 1] = support[1, kb + 1] = True
    support[1, kb + 2] = support[2, kb + 2] = True
    support[2, kb + 3] = support[3, kb + 3] = True

    # Extension rows: one identity parity column each (col kb+i, shift 0) plus a
    # declining number of entries over the systematic + core-parity columns.
    # Keep columns 0/1 (the punctured ones) high-degree: NR connects them to
    # ~60% of all rows so the receiver can re-inflate the never-transmitted
    # 2Z systematic bits.
    for i in range(4, mb):
        support[i, kb + i] = True
        deg = max(3, (10 if bg == 1 else 8) - (i - 4) // 6)
        if rng.random() < 0.6:
            support[i, int(rng.integers(0, 2))] = True
        pool = np.arange(2, kb + 4)
        extra = rng.choice(pool, size=min(deg - 1, pool.size), replace=False)
        support[i, extra] = True

    base = np.full((mb, nbv), -1, dtype=np.int64)
    shift_rng = np.random.default_rng((bg, ils, seed))
    shifts_rand = shift_rng.integers(0, 384, size=(mb, nbv))
    base[support] = shifts_rand[support]
    # Identity extension columns use shift 0 (the spec's I(0) extension), and the
    # double-diagonal col kb+1..kb+3 staircase uses shift 0 like the spec core.
    for i in range(4, mb):
        base[i, kb + i] = 0
    for (r, c) in ((0, kb + 1), (1, kb + 1), (1, kb + 2), (2, kb + 2), (2, kb + 3), (3, kb + 3)):
        base[r, c] = 0
    # Col kb in the NR-canonical encodable pattern: one unique shift (row 0)
    # plus two equal shifts that cancel when the core rows are XORed — this is
    # what lets ops/ldpc._encode_structured solve p0 with a single roll.
    base[0, kb], base[1, kb], base[3, kb] = 1 % z, 0, 0
    base = tuple(tuple(-1 if s < 0 else int(s) % z for s in row) for row in base)
    return QCLdpcCode(base=base, z=z)


# ---------------------------------------------------------------------------
# Rate matching (§5.4.2)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RateMatch:
    """Static rate-matching map for one (code, rv, E, Qm, fillers) tuple.

    tx_sel: (E,) positions into the FULL n-bit codeword (systematic + parity,
    *including* the 2Z punctured head so it composes with ops/ldpc's frames);
    transmitted bit t carries codeword bit tx_sel[t]. Repetition (E > usable
    buffer) yields duplicate positions — receivers must soft-combine.
    filler_pos: (n_filler,) codeword positions that hold known-zero fillers
    (skipped by tx_sel; pin them to +max LLR before decoding).
    """

    n: int
    e: int
    qm: int
    tx_sel: np.ndarray
    filler_pos: np.ndarray


def _k0(bg: int, rv: int, n_cb: int, z: int) -> int:
    """Table 5.4.2.1-2 starting position (full buffer N_cb = 66Z / 50Z)."""
    if bg == 1:
        num = {0: 0, 1: 17, 2: 33, 3: 56}[rv]
        return (num * n_cb // (66 * z)) * z
    num = {0: 0, 1: 13, 2: 25, 3: 43}[rv]
    return (num * n_cb // (50 * z)) * z


def make_rate_match(
    bg: int,
    z: int,
    n_blocks: int,
    e: int,
    qm: int,
    rv: int = 0,
    n_filler: int = 0,
    k_prime: Optional[int] = None,
) -> RateMatch:
    """Bit selection + interleaving map for one code block (§5.4.2.1/.2).

    n_blocks = the lifted code's n_var_blocks (68/52 for full BG1/BG2); e = E
    coded bits to transmit (must be a multiple of qm, as the spec guarantees);
    n_filler = filler bits at the tail of the systematic part (positions
    k_prime-n_filler..k_prime-1 of the codeword where k_prime defaults to kb*z).
    """
    mb, nbv, kb = base_graph_params(bg)
    assert n_blocks == nbv, f"expected full {nbv}-column base graph, got {n_blocks}"
    assert e % qm == 0, f"E={e} must be a multiple of Qm={qm} (§5.4.2.2)"
    assert rv in (0, 1, 2, 3)
    n = nbv * z
    n_cb = n - 2 * z  # full circular buffer (no UE soft-buffer limitation)
    if k_prime is None:
        k_prime = kb * z
    filler_pos = np.arange(k_prime - n_filler, k_prime, dtype=np.int64)
    is_filler = np.zeros(n_cb, dtype=bool)
    # buffer position j corresponds to codeword position j + 2z
    in_buf = filler_pos - 2 * z
    is_filler[in_buf[(in_buf >= 0) & (in_buf < n_cb)]] = True

    k0 = _k0(bg, rv, n_cb, z)
    # §5.4.2.1 bit selection: walk the circular buffer from k0, skipping fillers,
    # until E bits are taken (wraps => repetition).
    order = (k0 + np.arange(n_cb)) % n_cb
    usable = order[~is_filler[order]]
    if usable.size == 0:
        raise ValueError("rate matching: no transmittable bits (all fillers)")
    reps = -(-e // usable.size)
    sel_buf = np.tile(usable, reps)[:e]
    sel = sel_buf + 2 * z  # back to full-codeword positions

    # §5.4.2.2 bit interleaver: f_{i + j*Qm} = e_{i*(E/Qm) + j}.
    rows = e // qm
    il = (np.arange(e) % qm) * rows + (np.arange(e) // qm)
    tx_sel = sel[il]
    return RateMatch(n=n, e=e, qm=qm, tx_sel=tx_sel, filler_pos=filler_pos)
