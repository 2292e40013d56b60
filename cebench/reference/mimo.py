"""The multi-layer receiver's plain reference: per-RE MMSE equalization, the
post-MMSE SINR and the exact max-log LLRs of TS 38.211 §5.1 Gray QAM, in
float64 numpy, on the channel and noise of the float64 estimator
(`oracle.estimate`). It imports nothing of the program.

For a slot of n_rx antennas and nL layers (`gen.slots.Slot`), on every RE of
each hop's allocated symbols:

  H        (n_rx, nL): antenna r's row is `oracle.estimate` on its grid,
           CFO rotation included
  s        sigma^2 / beta^2: the antennas' mean of the estimator's noise over
           the data REs' amplitude squared (1 in the PUSCH chain)
  x_hat    (H^H H + s I)^-1 H^H y / beta
  sinr_l   1 / (s [(H^H H + s I)^-1]_ll) - 1, at least 0
  LLR      of bit k of layer l: sinr_l (min |x~ - c|^2 over the points c
           whose bit k is 1, less the same over bit k = 0), x~ = x_hat / alpha,
           alpha = sinr / (1 + sinr): the scalar channel x_hat = alpha x + z
           with noise variance 1 / sinr on x~. Positive: bit 0 likelier.

The minima are a search over the 2^m PAM levels of each axis (the I and the Q
bits of a square Gray QAM demap apart), the levels built from TS 38.211's
nested form; nothing here folds the search into a closed form. Bit order is
the spec's word order: b0, b2, ... on I, b1, b3, ... on Q.

Where the program departs from this definition (`models/receiver.py`,
`ops/equalize.py`, `ops/demap.py`):
  - it computes in float32, from its own float32 estimate, and returns
    round(8 LLR) clipped to [-127, 127] as int8;
  - with `time_interp="none"` it equalizes in the factored form: each
    antenna's per-symbol CFO rotation taken out of y, one inverse a
    subcarrier and hop. The rotations have unit modulus, so the Gram matrix
    and the filter are the dense form's;
  - it floors s [inv]_ll at 1e-30 before the reciprocal and gives an RE of
    SINR 0 all-zero LLRs (an erasure); so does this module where sinr is 0;
  - it demaps with a closed-form fold of the max-log search (exact for these
    constellations).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from . import oracle

_BITS = {"qpsk": 2, "16qam": 4, "64qam": 6, "256qam": 8, "1024qam": 10}


def pam_axis(m: int) -> Tuple[np.ndarray, np.ndarray]:
    """(levels (2^m,), bits (2^m, m)) of one axis of the TS 38.211 square Gray
    QAM with m bits an axis, unnormalized: level = (1 - 2 c0) g with
    g = 2^(m-1) - (1 - 2 c1) (2^(m-2) - (1 - 2 c2) (... (2 - (1 - 2 c_{m-1})))),
    as §5.1.3-5.1.6 write 16QAM to 256QAM."""
    bits = np.array([[(w >> (m - 1 - k)) & 1 for k in range(m)] for w in range(1 << m)])
    levels = np.empty(1 << m)
    for w, c in enumerate(bits):
        g = 1.0
        for k in range(m - 1, 0, -1):
            g = 2.0 ** (m - k) - (1 - 2 * c[k]) * g
        levels[w] = (1 - 2 * c[0]) * g
    return levels, bits


def maxlog_llrs(x_tilde: np.ndarray, sinr: np.ndarray, modulation: str) -> np.ndarray:
    """x_tilde (...) complex, sinr (...) -> (..., nbits) max-log LLRs with
    noise variance 1 / sinr on x_tilde; 0 where sinr is 0."""
    nbits = _BITS[modulation]
    m = nbits // 2
    levels, bits = pam_axis(m)
    norm = 2.0 * np.mean(levels ** 2)  # the constellation's mean energy, unnormalized
    out = np.zeros(x_tilde.shape + (nbits,))
    for axis, t in ((0, x_tilde.real), (1, x_tilde.imag)):
        d = (t[..., None] * np.sqrt(norm) - levels) ** 2  # (..., 2^m) in level units
        for k in range(m):
            one, zero = bits[:, k] == 1, bits[:, k] == 0
            out[..., 2 * k + axis] = (d[..., one].min(-1) - d[..., zero].min(-1)) * sinr / norm
    return out


def receive(slot, modulation: str, data_beta: float = 1.0):
    """(x_hat (n_sc, n_sym, nL) complex, sinr (n_sc, n_sym, nL), llrs
    (n_sc, n_sym, nL, nbits)) of the slot, zero outside the hops' allocated
    symbols."""
    ests = [oracle.estimate(np.asarray(slot.rg[r], np.complex128),
                            np.asarray(slot.pilots, np.complex128), slot.beta, slot.hop1,
                            slot.hop2, slot.config) for r in range(slot.rg.shape[0])]
    h = np.stack([o.channel_est_rg for o in ests], axis=-2)  # (n_sc, n_sym, n_rx, nL)
    y = np.moveaxis(np.asarray(slot.rg, np.complex128), 0, -1)  # (n_sc, n_sym, n_rx)
    s = float(np.mean([o.noise_est for o in ests])) / data_beta ** 2
    n_sc, n_sym, _, nL = h.shape
    hh = np.conj(np.swapaxes(h, -1, -2))  # (n_sc, n_sym, nL, n_rx)
    inv = np.linalg.inv(hh @ h + s * np.eye(nL))
    x = (inv @ (hh @ y[..., None]))[..., 0] / data_beta
    d = np.real(np.diagonal(inv, axis1=-2, axis2=-1))
    sinr = np.maximum(1.0 / np.maximum(d * s, 1e-30) - 1.0, 0.0)
    alloc = np.zeros(n_sym, bool)
    for hop in (slot.hop1, slot.hop2):
        if hop is not None and not hop.is_empty:
            alloc[hop.start_symbol:hop.start_symbol + hop.n_allocated_symbols] = True
    x[:, ~alloc] = 0.0
    sinr[:, ~alloc] = 0.0
    alpha = sinr / (1.0 + sinr)
    x_tilde = np.where(sinr > 0, x / np.where(sinr > 0, alpha, 1.0), 0.0)
    return x, sinr, maxlog_llrs(x_tilde, sinr, modulation)
