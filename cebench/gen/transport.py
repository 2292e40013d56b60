"""Frozen copy of `srsran_ce_tpu_torch/transport.py` (TS 38.212 transport layout, scrambling planes, placement and CRC), taken at adbd83d.

The benchmark makes its inputs and its reference from this copy, never from
the program, so that a later change to the program cannot move the
yardstick. Numpy only, and cut to what the benchmark calls. Edit nothing
here; a new generator is a new file.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .nrconfig import NRE, HopConfig
from .ldpc_code import QCLdpcCode, make_ldpc_plan


@dataclass(frozen=True)
class TransportCoding:
    """The transmitter's side of the coding agreement for one transport
    stream (the program's TransportCoding, its decoder fields left out).

    scramble_c_init: TS 38.211 §6.3.1.1 initializer
    (sequences.pusch_scrambling_c_init); None = unscrambled payload.
    crc: optional TS 38.212 §5.1 CRC attached to each codeword's systematic
    payload ("crc24a"/"crc24b"/"crc16"/"crc11"/"crc6").
    tx_bits: E of TS 38.212 §5.4.2 rate matching at rv 0 (2Z-puncture
    circular buffer, filler skip, Qm bit interleaver — nr_ldpc.make_rate_match;
    requires an NR base-graph code, e.g. nr_ldpc.nr_base_graph); None = one
    full buffer pass. The PRP
    channel interleaver (interleave_seed) maps the transmitted stream onto
    REs: it plays the role of NR's frequency-distributed resource mapping,
    not of the §5.4.2.2 bit interleaver.
    n_filler: known-zero filler bits at the tail of the systematic part
    (§5.2.2 when K' < K_b*Z): never transmitted, excluded from payload_bits."""

    code: QCLdpcCode
    interleave_seed: int = 0
    scramble_c_init: Optional[int] = None
    crc: Optional[str] = None
    tx_bits: Optional[int] = None
    n_filler: int = 0


@dataclass(frozen=True)
class TransportLayout:
    """Static per-geometry layout: where each codeword bit of each word lives.

    mask: (n_sc, n_sym) bool payload REs; perm: (c_words * tx_bits,)
    positions into the flattened scored bit stream (mask C-order, then
    (layer, bit)); total: scored bits; k/n: code dimensions; tx_bits = n
    unless IR-punctured (TransportCoding.tx_bits)."""

    mask: np.ndarray
    perm: np.ndarray
    c_words: int
    total: int
    k: int
    n: int
    tx_bits: int  # coded bits transmitted per word (n unless IR-punctured)
    cw_sel: np.ndarray  # (tx_bits,) codeword positions this RV transmits
    # "nr" rate matching only: known-zero filler codeword positions (pinned to
    # +max LLR on extraction) and whether cw_sel repeats positions (E beyond
    # one circular-buffer pass -> extraction soft-combines duplicates).
    filler_pos: Optional[np.ndarray] = None
    has_repeats: bool = False


def data_mask(
    hop1: HopConfig, hop2: Optional[HopConfig], n_sc: int, n_sym: int
) -> np.ndarray:
    """Scored-payload RE mask: union over hops of (PRB band x allocated
    symbols), minus each hop's DM-RS symbols entirely (at DM-RS symbols the
    non-pilot REs still carry signal; they are just not scored — matching
    utils/synthetic.make_mimo_case)."""
    mask = np.zeros((n_sc, n_sym), dtype=bool)
    for hop in [hop1] + ([hop2] if hop2 is not None and not hop2.is_empty else []):
        band = np.kron(hop.prb_mask_np, np.ones(NRE, dtype=bool))
        if band.size < n_sc:
            band = np.concatenate([band, np.zeros(n_sc - band.size, bool)])
        alloc = np.zeros(n_sym, dtype=bool)
        alloc[hop.start_symbol : hop.start_symbol + hop.n_allocated_symbols] = True
        alloc[np.nonzero(hop.dmrs_symbol_mask_np[:n_sym])[0]] = False
        mask |= band[:n_sc, None] & alloc[None, :]
    return mask


def layout(
    coding: TransportCoding,
    hop1: HopConfig,
    hop2: Optional[HopConfig],
    n_sc: int,
    n_sym: int,
    n_layers: int,
    nbits: int,
) -> TransportLayout:
    """Compute the full static layout for one (coding, geometry) pair."""
    mask = data_mask(hop1, hop2, n_sc, n_sym)
    total = int(mask.sum()) * n_layers * nbits
    n = coding.code.n
    from . import nr_ldpc as _nr

    nbv = coding.code.n_var_blocks
    bg = {68: 1, 52: 2}.get(nbv)
    if bg is None:
        raise ValueError(
            f"rate_match='nr' needs a full NR base graph (68/52 block cols), got {nbv}"
        )
    z = coding.code.z
    if coding.tx_bits is not None:
        tx_bits = coding.tx_bits
        # validate here (not just in make_rate_match's assert, which
        # vanishes under python -O): tx_bits <= 0 would reach the
        # `total // tx_bits` division below, and a non-Qm-multiple E is
        # not a valid §5.4.2 rate-match output length
        if tx_bits < 1:
            raise ValueError(f"tx_bits must be >= 1: {tx_bits}")
        if tx_bits % nbits != 0:
            raise ValueError(
                f"rate_match='nr' needs tx_bits to be a multiple of Qm={nbits}: {tx_bits}"
            )
    else:
        # default E: one full circular-buffer pass, rounded down to Qm
        tx_bits = ((n - 2 * z - coding.n_filler) // nbits) * nbits
    rm = _nr.make_rate_match(
        bg, z, nbv, tx_bits, qm=nbits, n_filler=coding.n_filler
    )
    cw_sel = rm.tx_sel
    filler_pos = rm.filler_pos
    has_repeats = bool(np.unique(cw_sel).size < cw_sel.size)
    c_words = total // tx_bits
    if c_words < 1:
        raise ValueError(
            f"allocation carries {total} scored bits < one {tx_bits}-bit transmission"
        )
    rng = np.random.default_rng(coding.interleave_seed)
    perm = rng.permutation(total)[: c_words * tx_bits]
    plan = make_ldpc_plan(coding.code)
    return TransportLayout(
        mask=mask, perm=perm, c_words=c_words, total=total, k=plan.k, n=n,
        tx_bits=tx_bits, cw_sel=cw_sel, filler_pos=filler_pos,
        has_repeats=has_repeats,
    )


def scramble_planes(
    c_init: int, n_sc: int, n_sym: int, n_layers: int, nbits: int
) -> np.ndarray:
    """Scrambling bits aligned with a (n_sc, n_sym, n_layers, nbits)
    payload-bit grid: layer l consumes the l-th length-L window of one
    TS 38.211 Gold stream (gold_sequence(c_init, n_layers*L)[l*L:(l+1)*L]) —
    independent per-layer streams, the convention
    utils/synthetic.make_mimo_case transmits with.

    Deliberate deviation from TS 38.211 §6.3.1.1 (which scrambles the
    per-codeword BIT STREAM before layer mapping, not per-(sc, sym, layer)
    grid planes): this framework scrambles after placement so the planes are
    static per geometry and the device-side descramble is a sign flip on the
    LLR grid. TX and RX share this one implementation so the chain is
    self-consistent; bit-exact §6.3.1.1 conformance against external NR
    vectors would need the pre-layer-mapping order (same Gold generator)."""
    from . import sequences

    n = n_sc * n_sym * nbits
    c = sequences.gold_sequence(int(c_init), n_layers * n)
    planes = [c[l * n : (l + 1) * n].reshape(n_sc, n_sym, nbits) for l in range(n_layers)]
    return np.stack(planes, axis=2)  # (n_sc, n_sym, n_layers, nbits)


def place_codewords(
    lay: TransportLayout,
    codewords: np.ndarray,
    n_layers: int,
    nbits: int,
    fill_rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Transmitter side: scatter encoded words into a PRE-scrambling payload
    bit grid (n_sc, n_sym, n_layers, nbits). Positions the codewords don't
    fill get random bits from `fill_rng` (zeros if None)."""
    codewords = np.asarray(codewords, np.uint8).reshape(lay.c_words, lay.n)
    stream = (
        fill_rng.integers(0, 2, lay.total, dtype=np.uint8)
        if fill_rng is not None
        else np.zeros(lay.total, np.uint8)
    )
    stream[lay.perm] = codewords[:, lay.cw_sel].reshape(-1)
    n_sc, n_sym = lay.mask.shape
    bits = np.zeros((n_sc, n_sym, n_layers, nbits), np.uint8)
    bits[lay.mask] = stream.reshape(-1, n_layers, nbits)
    return bits


# --- CRC attachment (TS 38.212 §5.1) -------------------------------------

_CRC_POLYS = {
    # name: (degree, generator polynomial WITHOUT the leading x^deg term)
    "crc24a": (24, 0x864CFB),
    "crc24b": (24, 0x800063),
    "crc16": (16, 0x1021),
    "crc11": (11, 0x621),
    "crc6": (6, 0x61),
}


@functools.lru_cache(maxsize=32)
def _crc_table(kind: str, m: int) -> np.ndarray:
    """(ceil(m / 8), 256) uint32 table of the CRC over m-bit messages, by
    byte: entry [j, v] is the parity that byte j of the message (bits 8j ..
    8j + 7, MSB first) adds when it holds v. Built from the per-bit parities
    x^(m-1-i+deg) mod P, reached by stepping the register once per bit from
    x^deg mod P (the last message bit's)."""
    deg, poly = _CRC_POLYS[kind]
    top, mask = 1 << (deg - 1), (1 << deg) - 1
    n_bytes = -(-m // 8)
    rows = np.zeros(8 * n_bytes, np.int64)  # bits past m (the packing's zero fill) add nothing
    r = poly
    for i in range(m - 1, -1, -1):
        rows[i] = r
        r = ((r << 1) & mask) ^ (poly if r & top else 0)
    bit = (np.arange(256)[:, None] >> np.arange(7, -1, -1)) & 1  # (256, 8), MSB first
    table = np.bitwise_xor.reduce(bit * rows.reshape(n_bytes, 1, 8), axis=-1).astype(np.uint32)
    table.setflags(write=False)
    return table


def crc_bits(bits: np.ndarray, kind: str) -> np.ndarray:
    """CRC parity bits for message `bits` (..., m) in {0,1}, MSB-first
    (TS 38.212 §5.1 conventions: a0 is the highest-order coefficient and the
    parity bits follow the message). Vectorized over leading axes.

    The CRC with a zero register is linear over GF(2), so the parity is the
    XOR of one table entry per message byte, the table cached per (kind, m):
    integer numpy only, no BLAS call. Bit-identical to the bit-serial
    register of the JAX package's `transport.crc_bits`."""
    deg, _ = _CRC_POLYS[kind]
    b = np.asarray(bits, np.uint8)
    lead = b.shape[:-1]
    b = b.reshape(-1, b.shape[-1])  # raises at m = 0, as the JAX function does
    table = _crc_table(kind, b.shape[1])
    parity = table[np.arange(table.shape[0]), np.packbits(b, axis=1)]  # (words, bytes)
    reg = np.bitwise_xor.reduce(parity, axis=1).astype(np.int64)
    out = ((reg[:, None] >> np.arange(deg - 1, -1, -1)) & 1).astype(np.uint8)
    return out.reshape(lead + (deg,))


def crc_attach(bits: np.ndarray, kind: str) -> np.ndarray:
    """Append the CRC parity to message bits: (..., m) -> (..., m + deg)."""
    return np.concatenate([np.asarray(bits, np.uint8), crc_bits(bits, kind)], axis=-1)


def payload_bits(coding: TransportCoding, k: int) -> int:
    """Usable payload bits per codeword: code dimension k minus fillers and CRC.

    Raises when fillers + CRC leave no room for payload — the decoded-serving
    path would otherwise slice with a non-positive bound and silently return
    empty payloads."""
    deg = _CRC_POLYS[coding.crc][0] if coding.crc is not None else 0
    p = k - coding.n_filler - deg
    if p <= 0:
        raise ValueError(
            f"code dimension k={k} leaves no payload after {coding.n_filler} "
            f"fillers and {coding.crc or 'no'} CRC ({deg} parity bits)"
        )
    return p

