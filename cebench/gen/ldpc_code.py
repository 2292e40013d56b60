"""Frozen copy of `srsran_ce_tpu_torch/ops/ldpc.py` (the QC-LDPC code, its plan and the systematic encoder; the decoders left out), taken at adbd83d.

The benchmark makes its inputs and its reference from this copy, never from
the program, so that a later change to the program cannot move the
yardstick. Numpy only, and cut to what the benchmark calls. Edit nothing
here; a new generator is a new file.
"""
from __future__ import annotations

import functools
import json
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


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
