"""Frozen copy of `srsran_ce_tpu_torch/ops/demap.py` (the Gray-QAM modulator), taken at adbd83d.

The benchmark makes its inputs and its reference from this copy, never from
the program, so that a later change to the program cannot move the
yardstick. Numpy only, and cut to what the benchmark calls. Edit nothing
here; a new generator is a new file.
"""
from __future__ import annotations

import math

import numpy as np

# m = bits per PAM axis; levels are odd integers scaled by 1/sqrt(norm)
# (TS 38.211 §5.1.3-§5.1.6 normalizations).
_QAM_NORM = {1: 2.0, 2: 10.0, 3: 42.0, 4: 170.0, 5: 682.0}

MODULATIONS = ("bpsk", "qpsk", "16qam", "64qam", "256qam", "1024qam")


def bits_per_symbol(modulation: str) -> int:
    try:
        return {
            "bpsk": 1, "qpsk": 2, "16qam": 4, "64qam": 6, "256qam": 8,
            "1024qam": 10,
        }[modulation]
    except KeyError:
        raise ValueError(f"modulation must be one of {MODULATIONS}: {modulation!r}")


def _pam_level(bits) -> float:
    """TS 38.211 Gray PAM level (odd integer, unnormalized) for axis bits
    (b_sign, b_mag1, b_mag2, ...), the spec's nested form built innermost-out."""
    f = 1.0
    p = 2.0
    for b in reversed(bits[1:]):
        f = p - (1.0 - 2.0 * b) * f
        p *= 2.0
    return (1.0 - 2.0 * bits[0]) * f


def constellation(modulation: str) -> np.ndarray:
    """Unit-energy Gray-mapped constellation indexed by the TS 38.211 bit word
    (b0..b_{n-1} -> index sum b_k 2^(n-1-k)), host-side numpy."""
    nbits = bits_per_symbol(modulation)
    if nbits == 1:
        # TS 38.211 5.1.2 BPSK: d = (1-2b)(1+j)/sqrt(2)
        return np.array([(1 + 1j), (-1 - 1j)]) / np.sqrt(2.0)
    m = nbits // 2
    s = np.sqrt(_QAM_NORM[m])
    pts = np.empty(1 << nbits, np.complex128)
    for w in range(1 << nbits):
        b = [(w >> (nbits - 1 - k)) & 1 for k in range(nbits)]
        pts[w] = (_pam_level(b[0::2]) + 1j * _pam_level(b[1::2])) / s
    return pts


def modulate(bits: np.ndarray, modulation: str) -> np.ndarray:
    """Host-side Gray-QAM modulator: bits (..., n_sym * nbits) in {0, 1} ->
    unit-energy symbols (..., n_sym). Inverse of `llrs`' hard decisions."""
    nbits = bits_per_symbol(modulation)
    pts = constellation(modulation)
    b = np.asarray(bits)
    assert b.shape[-1] % nbits == 0, (b.shape, nbits)
    words = b.reshape(b.shape[:-1] + (-1, nbits))
    idx = np.zeros(words.shape[:-1], np.int64)
    for k in range(nbits):
        idx = (idx << 1) | words[..., k]
    return pts[idx]
