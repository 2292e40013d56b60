"""3GPP TS 38.211 pilot-sequence generation: Gold-sequence DM-RS and low-PAPR
Zadoff-Chu SRS sequences.

A numpy copy of `srsran_ce_tpu/ops/sequences.py` (the port cannot import the
JAX package, whose `__init__` imports `jax`); tests/test_torch_plan.py holds
the two packages' sequences bit-identical.

The reference implementation (and the estimator core here) treats the pilot values
as *given inputs* — its harness reads them from srsRAN's binary test vectors
(the reference's scripts/validation/validate_all.py:373, `np.fromfile(pilots)`).
That leaves a real framework gap: a user cannot *produce* the standard-compliant
pilots the estimator de-spreads. This module closes the loop so the framework runs
end to end from physical-layer parameters alone:

  * `gold_sequence` / `pseudo_random_qpsk` — the length-31 Gold pseudo-random
    generator of TS 38.211 §5.2.1 (block-vectorized numpy; sequences are static
    per-configuration, so generation is plan-time host work, never traced).
  * `pusch_dmrs_pilots` — PUSCH/PDSCH DM-RS configuration type 1 (comb-2, OCC-2
    frequency cover codes) in this framework's `(n_re, n_dsym, n_layers)` pilot
    layout, per TS 38.211 §6.4.1.1.
  * `low_papr_base_sequence` / `srs_pilots` — Zadoff-Chu low-PAPR sequences
    (TS 38.211 §5.2.2) with SRS cyclic shifts and group/sequence hopping
    (§6.4.1.4), the "pilot (ZC-sequence) de-spreading" input of the SRS chain.

All generators are deterministic functions of standard identifiers (N_ID, slot,
symbol, port); outputs are float64-precision complex128 numpy arrays in the exact
layout `models/estimator.estimate` and `serving.process` consume.

Validation note: 3GPP conformance vectors for sequence generation are not available
in this environment, so the tests pin these generators down structurally instead —
the vectorized Gold LFSR against a naive bit-by-bit implementation, ZC unit modulus
+ ideal periodic autocorrelation + measured PAPR, OCC orthogonality, determinism —
and end-to-end: estimator conformance and channel-NMSE quality on synthetic cases
driven by these pilots (tests/test_sequences.py).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np

from ..config import NRE, HopConfig

_NC = 1600  # Gold-sequence fast-forward offset (TS 38.211 §5.2.1)


# ---------------------------------------------------------------------------
# Gold pseudo-random sequence (TS 38.211 §5.2.1)
# ---------------------------------------------------------------------------


def _lfsr_fill(x: np.ndarray, taps: Tuple[int, ...]) -> None:
    """Fill x[31:] in place from the degree-31 recurrence x[n+31] = XOR_t x[n+t].

    Because the smallest feedback gap is 31 - max(taps) = 28 samples, blocks of 28
    outputs depend only on already-computed values — so the whole fill is ~N/28
    vectorized XORs instead of a Python bit loop.
    """
    n = x.size
    i = 31
    while i < n:
        j = min(i + 28, n)
        blk = x[i - 31 + taps[0] : j - 31 + taps[0]].copy()
        for t in taps[1:]:
            blk ^= x[i - 31 + t : j - 31 + t]
        x[i:j] = blk
        i = j


@functools.lru_cache(maxsize=256)
def _gold_cached(c_init: int, length: int) -> np.ndarray:
    total = _NC + length + 31
    x1 = np.zeros(total, dtype=np.uint8)
    x1[0] = 1
    _lfsr_fill(x1, (0, 3))  # x1(n+31) = (x1(n+3) + x1(n)) mod 2
    x2 = np.zeros(total, dtype=np.uint8)
    for b in range(31):
        x2[b] = (c_init >> b) & 1
    _lfsr_fill(x2, (0, 1, 2, 3))  # x2(n+31) = x2(n+3)+x2(n+2)+x2(n+1)+x2(n)
    out = (x1[_NC : _NC + length] ^ x2[_NC : _NC + length]).astype(np.uint8)
    out.setflags(write=False)
    return out


def gold_sequence(c_init: int, length: int) -> np.ndarray:
    """c(n), n = 0..length-1: the length-31 Gold sequence of TS 38.211 §5.2.1.

    x1 seeded with 1, x2 seeded with the bits of `c_init`; both advanced by
    Nc = 1600 before output. Returns uint8 bits (read-only, cached per config).
    """
    if not (0 <= int(c_init) < 2**31):
        raise ValueError(f"c_init must be in [0, 2^31): {c_init}")
    return _gold_cached(int(c_init), int(length))


def pseudo_random_qpsk(c_init: int, n: int, start: int = 0) -> np.ndarray:
    """r(m) = ((1-2c(2m)) + j(1-2c(2m+1))) / sqrt(2) for m = start..start+n-1.

    The QPSK mapping of TS 38.211 §6.4.1.1.1 / §7.4.1.1.1. `start` skips sequence
    positions (an allocation beginning at PRB p consumes the sequence from that
    PRB's pilot ordinal, with generation anchored at the grid reference point).
    """
    c = gold_sequence(c_init, 2 * (start + n)).astype(np.float64)
    re = 1.0 - 2.0 * c[2 * start :: 2]
    im = 1.0 - 2.0 * c[2 * start + 1 :: 2]
    return (re + 1j * im) / np.sqrt(2.0)


def dmrs_c_init(
    slot: int, symbol: int, n_id: int, n_scid: int = 0, n_symbols_per_slot: int = 14
) -> int:
    """DM-RS scrambling init (TS 38.211 §6.4.1.1.1.1 / §7.4.1.1.2.1):

    c_init = (2^17 (N_symb^slot n_slot + l + 1)(2 N_ID + 1) + 2 N_ID + n_SCID) mod 2^31
    """
    return int(
        (2**17 * (n_symbols_per_slot * slot + symbol + 1) * (2 * n_id + 1)
         + 2 * n_id + n_scid)
        % 2**31
    )


# DM-RS frequency cover code w_f(k') per antenna port (TS 38.211 Tables
# 6.4.1.1.3-1/-2): within a CDM group the second port alternates sign over k'.
# Config type 1: CDM group λ rides the comb offset Δ = λ (6 REs/PRB, k = 4n+2k'+Δ).
# Config type 2: CDM group λ rides two adjacent-RE clusters per PRB at
# Δ = 2λ (4 REs/PRB, k = 6n+k'+Δ). Both map sequence ordinal m = 2n + k'.
_OCC2_WF = {0: (1.0, 1.0), 1: (1.0, -1.0)}


def dmrs_re_mask(config_type: int, n_cdm: int = 1) -> np.ndarray:
    """(12, n_cdm) per-PRB DM-RS RE mask of TS 38.211 §6.4.1.1.3.

    Type 1: CDM group λ occupies the comb-2 offsets {Δ, Δ+2, .., Δ+10}, Δ = λ
    (6 REs/PRB; λ in 0..1). Type 2: CDM group λ occupies the adjacent pairs
    {Δ, Δ+1, Δ+6, Δ+7}, Δ = 2λ (4 REs/PRB; λ in 0..2).
    """
    mask = np.zeros((NRE, n_cdm), dtype=bool)
    if config_type == 1:
        if not 1 <= n_cdm <= 2:
            raise ValueError(f"DM-RS type 1 has 2 CDM groups, got n_cdm={n_cdm}")
        for lam in range(n_cdm):
            mask[lam::2, lam] = True
    elif config_type == 2:
        if not 1 <= n_cdm <= 3:
            raise ValueError(f"DM-RS type 2 has 3 CDM groups, got n_cdm={n_cdm}")
        for lam in range(n_cdm):
            for k in (2 * lam, 2 * lam + 1, 2 * lam + 6, 2 * lam + 7):
                mask[k, lam] = True
    else:
        raise ValueError(f"DM-RS configuration type must be 1 or 2: {config_type}")
    return mask


def _dmrs_sequence_ordinals(
    sc_idx: np.ndarray, delta: int, config_type: int, comb: int
) -> np.ndarray:
    """Sequence ordinals m of pilot subcarriers (anchored at grid PRB 0).

    Type 1: k = 4n + 2k' + Δ  ->  m = 2n + k' = (k - Δ) / comb (standard comb = 2;
            wider combs generalize the same uniform-lattice rule).
    Type 2: k = 6n + k' + Δ   ->  m = 2n + k' = 2*((k-Δ) // 6) + (k-Δ) % 6.
    In both, w_f alternates with k' = m mod 2.
    """
    off = sc_idx - delta
    if config_type == 1:
        if np.any(off % comb):
            raise ValueError(f"type-1 DM-RS RE mask is not a comb-{comb} at offset Δ")
        return off // comb
    if np.any(off % 6 > 1):
        raise ValueError("type-2 DM-RS RE mask is not adjacent pairs at offset Δ")
    return 2 * (off // 6) + off % 6


def pusch_dmrs_pilots(
    hop: HopConfig,
    n_layers: int,
    slot: int,
    n_id: int,
    n_scid: int = 0,
    config_type: int = 1,
) -> np.ndarray:
    """Standard DM-RS (configuration type 1 or 2) pilots for one hop, framework layout.

    Returns (n_re, n_dsym, n_layers) complex128 where n_re = n_prbs * pilots-per-PRB
    of CDM group 0 — the layout `models/estimator.estimate` consumes (layer pairs
    [0,1] ride CDM group 0, [2,3] CDM group 1; both groups carry the *same*
    scrambling sequence mapped onto their own frequency offsets, §6.4.1.1.3).

    The per-symbol sequence is r(m) with c_init = dmrs_c_init(slot, l, ...) and the
    sequence ordinals anchored at the grid reference point (PRB 0) and derived from
    the hop's *actual* PRB mask — hops at different PRB starts, and allocations with
    interior maskPRBs holes, take exactly the slice of the slot-wide sequence the
    standard maps onto their REs. OCC-2 w_f from Tables 6.4.1.1.3-1/-2 separates
    the two ports of a CDM group — the exact ±1 alternation the estimator's CDM
    pair-averaging inverts (type 2's k' pairs are *adjacent* subcarriers, so the
    constant-channel pairing assumption is even stronger than type 1's).
    """
    if not 1 <= n_layers <= 4:
        raise ValueError(f"DM-RS supports 1..4 layers here, got {n_layers}")
    if config_type not in (1, 2):
        raise ValueError(f"DM-RS configuration type must be 1 or 2: {config_type}")
    re_mask = hop.dmrs_re_mask_np  # (12, n_cdm)
    per_prb = int(re_mask[:, 0].sum())
    comb = NRE // per_prb
    if config_type == 2 and per_prb != 4:
        raise ValueError(
            f"DM-RS type 2 has 4 REs/PRB per CDM group, hop RE mask has {per_prb}"
        )
    sym_idx = np.nonzero(hop.dmrs_symbol_mask_np)[0]
    # Sequence ordinals of the hop's pilot REs, anchored at PRB 0 of the grid.
    sc_idx = np.nonzero(np.kron(hop.prb_mask_np, re_mask[:, 0]))[0]
    delta = int(np.nonzero(re_mask[:, 0])[0][0])  # frequency offset of CDM group 0
    m_idx = _dmrs_sequence_ordinals(sc_idx, delta, config_type, comb)
    n_re = m_idx.size

    pilots = np.zeros((n_re, len(sym_idx), n_layers), dtype=np.complex128)
    occ = np.where(m_idx % 2 == 0, 1.0, -1.0)
    for j, l_sym in enumerate(sym_idx):
        r = pseudo_random_qpsk(dmrs_c_init(slot, int(l_sym), n_id, n_scid), int(m_idx[-1]) + 1)
        r = r[m_idx]
        for layer in range(n_layers):
            wf = occ if (layer % 2) else 1.0
            pilots[:, j, layer] = r * wf
    return pilots


# ---------------------------------------------------------------------------
# Low-PAPR (Zadoff-Chu) sequences (TS 38.211 §5.2.2) and SRS (§6.4.1.4)
# ---------------------------------------------------------------------------


def largest_prime_below(n: int) -> int:
    for cand in range(n - 1, 1, -1):
        if all(cand % p for p in range(2, int(cand**0.5) + 1)):
            return cand
    raise ValueError(f"no prime below {n}")


def zadoff_chu(q: int, n_zc: int) -> np.ndarray:
    """x_q(m) = exp(-j pi q m (m+1) / N_ZC), m = 0..N_ZC-1 (TS 38.211 §5.2.2.1)."""
    m = np.arange(n_zc, dtype=np.float64)
    return np.exp(-1j * np.pi * q * m * (m + 1.0) / n_zc)


@functools.lru_cache(maxsize=256)
def _low_papr_cached(u: int, v: int, m_zc: int) -> np.ndarray:
    if m_zc == 30:
        # TS 38.211 §5.2.2.2: for M_ZC = 30 the base sequence is given in closed
        # form, r̄(n) = exp(-j π (u+1)(n+1)(n+2) / 31) — a length-31 Zadoff-Chu of
        # root u+1 sampled at m = n+1 (no cyclic extension, no φ table).
        n = np.arange(30, dtype=np.float64)
        out = np.exp(-1j * np.pi * (u + 1) * (n + 1.0) * (n + 2.0) / 31.0)
        out.setflags(write=False)
        return out
    n_zc = largest_prime_below(m_zc)
    qbar = n_zc * (u + 1) / 31.0
    q = int(np.floor(qbar + 0.5)) + v * (-1) ** int(np.floor(2.0 * qbar))
    x = zadoff_chu(q, n_zc)
    out = x[np.arange(m_zc) % n_zc]  # cyclic extension to M_ZC
    out.setflags(write=False)
    return out


def low_papr_base_sequence(u: int, v: int, m_zc: int) -> np.ndarray:
    """Base sequence r̄_{u,v}(n), n = 0..M_ZC-1 (TS 38.211 §5.2.2).

    M_ZC >= 36 (§5.2.2.1): cyclically-extended Zadoff-Chu of root q(u, v) and
    length N_ZC = largest prime < M_ZC. M_ZC = 30 (§5.2.2.2): the closed-form
    length-31 ZC expression (5 PRBs at comb-2 / 10 at comb-4). Group u in 0..29,
    base number v in {0, 1} (v = 1 only defined for M_ZC >= 72).

    Lengths in {6, 12, 18, 24} use tabulated computer-generated φ(n) sequences in
    the spec (Tables 5.2.2.2-1..4); the tables are not available in this
    environment, so those lengths raise rather than silently substituting wrong
    pilots — use >= 5 PRBs at comb-2 (M_ZC = 30) or >= 6 (M_ZC >= 36).
    """
    if m_zc < 36 and m_zc != 30:
        raise ValueError(
            f"M_ZC={m_zc} requires the tabulated short sequences of TS 38.211 "
            "§5.2.2.2 Tables -1..-4 (not implemented); supported: M_ZC == 30 or >= 36."
        )
    if not 0 <= u < 30:
        raise ValueError(f"sequence group u must be in 0..29: {u}")
    if v not in (0, 1) or (v == 1 and m_zc < 72):
        raise ValueError(f"base number v={v} invalid for M_ZC={m_zc}")
    return _low_papr_cached(int(u), int(v), int(m_zc))


def srs_group_sequence(
    n_id: int,
    slot: int,
    symbol: int,
    m_zc: int,
    hopping: str = "neither",
    n_symbols_per_slot: int = 14,
) -> Tuple[int, int]:
    """(u, v) for one SRS symbol (TS 38.211 §6.4.1.4.2).

    hopping = "neither":       u = n_ID mod 30, v = 0.
    hopping = "groupHopping":  u = (f_gh + n_ID) mod 30 with f_gh the 8-bit Gold
                               word at position 8*(14*slot + symbol), c_init = n_ID;
                               v = 0.
    hopping = "sequenceHopping": u = n_ID mod 30; v = c(14*slot + symbol) when
                               M_ZC >= 72, else 0.
    """
    if hopping == "neither":
        return n_id % 30, 0
    if hopping == "groupHopping":
        pos = 8 * (n_symbols_per_slot * slot + symbol)
        bits = gold_sequence(n_id % 2**31, pos + 8)[pos : pos + 8].astype(np.int64)
        f_gh = int((bits * (1 << np.arange(8))).sum()) % 30
        return (f_gh + n_id) % 30, 0
    if hopping == "sequenceHopping":
        pos = n_symbols_per_slot * slot + symbol
        v = int(gold_sequence(n_id % 2**31, pos + 1)[pos]) if m_zc >= 72 else 0
        return n_id % 30, v
    raise ValueError(f"unknown SRS hopping mode {hopping!r}")


def srs_pilots(
    hop: HopConfig,
    n_layers: int,
    slot: int,
    n_id: int,
    n_cs: int = 0,
    hopping: str = "neither",
) -> np.ndarray:
    """Low-PAPR ZC SRS pilots for one hop, framework layout (n_re, n_dsym, n_layers).

    Per TS 38.211 §6.4.1.4.3 the ports of a multi-port SRS share one base sequence
    and are separated by cyclic shifts α_i = 2π n_cs,i / n_cs_max (n_cs_max = 8 at
    comb-2, 12 at comb-4). Within a CDM pair this implementation spaces the shifts
    by n_cs_max/2, so the second port's sequence is the first times e^{jπn} = (-1)^n
    — exactly the OCC-2 alternation the estimator's CDM pair-averaging separates;
    CDM groups (layer pairs) ride the hop's RE-mask comb offsets as usual.

    n_cs is the configured base cyclic shift (0 <= n_cs < n_cs_max); group /
    sequence hopping select (u, v) per symbol via `srs_group_sequence`.
    """
    if not 1 <= n_layers <= 4:
        raise ValueError(f"SRS supports 1..4 ports, got {n_layers}")
    re_mask = hop.dmrs_re_mask_np
    per_prb = int(re_mask[:, 0].sum())
    comb = NRE // per_prb
    n_cs_max = {2: 8, 4: 12}.get(comb, 2 * per_prb)
    n_re = hop.n_prbs * per_prb
    sym_idx = np.nonzero(hop.dmrs_symbol_mask_np)[0]

    n = np.arange(n_re, dtype=np.float64)
    pilots = np.zeros((n_re, len(sym_idx), n_layers), dtype=np.complex128)
    for j, l_sym in enumerate(sym_idx):
        u, v = srs_group_sequence(n_id, slot, int(l_sym), n_re, hopping)
        base = low_papr_base_sequence(u, v, n_re)
        for layer in range(n_layers):
            cs = (n_cs + (layer % 2) * (n_cs_max // 2)) % n_cs_max
            alpha = 2.0 * np.pi * cs / n_cs_max
            pilots[:, j, layer] = base * np.exp(1j * alpha * n)
    return pilots


def papr_db(seq: np.ndarray, oversample: int = 4) -> float:
    """Peak-to-average power ratio (dB) of a frequency-domain sequence after
    oversampled IFFT — the figure of merit 'low-PAPR' refers to."""
    n = seq.size
    t = np.fft.ifft(seq, n * oversample) * oversample
    p = np.abs(t) ** 2
    return float(10.0 * np.log10(p.max() / p.mean()))


def pusch_scrambling_c_init(rnti: int, n_id: int, q: int = 0) -> int:
    """TS 38.211 §6.3.1.1 PUSCH data-scrambling initializer:
    c_init = n_RNTI * 2^15 + q * 2^14 + n_ID (q = codeword index, 0 for the
    single-codeword uplink). The sequence itself is `gold_sequence(c_init, n)`.
    """
    rnti, n_id, q = int(rnti), int(n_id), int(q)
    if not (0 <= rnti < 2**16):
        raise ValueError(f"rnti must be in [0, 2^16): {rnti}")
    if not (0 <= n_id < 1024):
        raise ValueError(f"n_id must be in [0, 1024): {n_id}")
    if q not in (0, 1):
        raise ValueError(f"q must be 0 or 1: {q}")
    return rnti * 2**15 + q * 2**14 + n_id


def scramble_bits(bits: np.ndarray, c_init: int, start: int = 0) -> np.ndarray:
    """b XOR c over the trailing-flattened bit stream (TS 38.211 §6.3.1.1).

    Transmitter-side host helper (the inverse of demap.descramble_llrs on the
    receive side): bits any shape in {0,1}; the Gold sequence is consumed in
    C-order over the flattened array, offset by `start` sequence positions.
    """
    b = np.asarray(bits)
    c = gold_sequence(int(c_init), start + b.size)[start:].reshape(b.shape)
    return (b.astype(np.uint8) ^ c).astype(b.dtype)
