"""Frozen copy of `srsran_ce_tpu_torch/ops/nr_ldpc.py` (TS 38.212 base graphs and rate matching), taken at adbd83d.

The benchmark makes its inputs and its reference from this copy, never from
the program, so that a later change to the program cannot move the
yardstick. Numpy only, and cut to what the benchmark calls. Edit nothing
here; a new generator is a new file.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .ldpc_code import QCLdpcCode

__all__ = [
    "LIFTING_SETS",
    "lifting_sizes",
    "lifting_set_index",
    "base_graph_params",
    "nr_base_graph",
    "RateMatch",
    "make_rate_match",
]

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
