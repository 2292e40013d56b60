"""The work of one channel estimation problem, for the estimator's roofline
share (`estimator_roofline_pct`).

It counts the work of the estimation and not of an implementation: the
configuration's sizes and the steps of the frozen float64 estimator
(`reference/oracle.py`, one hop, time_interp "none"), so the share reads the
same work whatever computes it. The card's peaks and the least time are in
`roofline.py`. DM-RS type 1 only (the configurations this file counts).

Sizes of a problem: n_sc = 12 x n_prbs subcarriers; n_cdm = ceil(nL / 2)
CDM groups of two ports; n_re = n_sc / comb pilot REs of a CDM group in a
DM-RS symbol; nd DM-RS symbols; nL layers (ports); n_sym symbols. Then
R = n_re x nd x n_cdm received DM-RS REs, P = n_re x nd x nL pilot REs of
the layers, H = n_re x nL pilot positions of the layers' profiles.

Bytes, each counted once, a complex value as two float32 (8 B):
  the grid's DM-RS REs       8 x nd x n_sc          (in)
  the pilots, as handed in   8 x n_re x nd x nL     (in; each problem carries
                                                     its own)
  beta                       4                      (in)
  the profiles               8 x nL x n_sc          (out: one hop, rank 1)
  the symbol rotations       8 x n_sym              (out)
  the five scalars           4 x 5                  (out: noise, RSRP, EPRE,
                                                     time alignment, CFO)

Operations (float32; a complex product 6, a complex sum 2, a real times a
complex 2, a squared magnitude 3, an accumulation 1 real or 2 complex):
  EPRE          4 x R     |y|^2 of each received DM-RS RE, summed
  LS            6 x P     y x conj(x) for each layer of the RE's CDM group
  CFO           8 x H     the correlation of the first two DM-RS symbols,
                          conj(a) b summed over the pilots of each layer
  CFO removal   6 x P     each LS product times its symbol's rotation
  time average  2 x P     the sum over the DM-RS symbols and 1 / (beta nd)
  CDM despread  2 x H     the mean of each RE pair of a layer
  smoothing     4 x taps x H    the raised-cosine filter (`oracle.get_rc_filter`
                          at the configuration's stride: 15 taps), real taps
                          on complex values; the virtual pilots at the band's
                          edges (two fits of 7 points a layer) left out
  TA            5 x N log2 N x nL   the N = 4096-point inverse FFT of each
                          layer's pilot estimates (the delay profile), and
                          4 x 2 half_cp x nL for the power of the bins the
                          search reads (half_cp = 144 at N = 4096)
  noise         16 x P + 6 x R      each layer's pilot rebuilt (profile times
                          rotation, times pilot, times beta, summed into its
                          CDM group's RE), then the residual's |.|^2 summed
  RSRP          4 x H     |h|^2 of each profile value, summed
  fill          6 x (n_sc - n_re) x nL   the linear interpolation of each
                          profile onto the subcarriers between its pilots
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from cebench.reference import oracle

NRE = 12
#: the delay profile's FFT size and the half cyclic prefix it searches
#: (oracle._process_hop)
FFT_SIZE = 4096
HALF_CP = int(math.floor((144 / 2) * FFT_SIZE / 2048))


@dataclass(frozen=True)
class Work:
    """Bytes and float32 operations of one estimation problem."""

    bytes: float
    ops: float


def sizes(cfg: dict) -> dict:
    """The sizes of one problem of the configuration `cfg`."""
    if int(cfg["dmrs_type"]) != 1:
        raise ValueError(f"DM-RS type {cfg['dmrs_type']}: this count holds type 1 only")
    n_sc = NRE * int(cfg["n_prbs"])
    comb = int(cfg["comb"])
    nl = int(cfg["n_layers"])
    return dict(n_sc=n_sc, n_re=n_sc // comb, n_cdm=math.ceil(nl / 2), nd=int(cfg["n_dmrs_syms"]),
                nl=nl, n_sym=int(cfg["n_sym"]), stride=comb, n_prbs=int(cfg["n_prbs"]))


def smoothing_taps(cfg: dict) -> int:
    """The raised-cosine filter's taps at the configuration's pilot stride."""
    s = sizes(cfg)
    rc, _ = oracle.get_rc_filter(s["stride"], min(3, s["n_prbs"]))
    return int(rc.size)


def problem(cfg: dict) -> Work:
    """The bytes and operations of one problem (one antenna of a UE-slot)."""
    s = sizes(cfg)
    n_sc, n_re, nd, nl = s["n_sc"], s["n_re"], s["nd"], s["nl"]
    nbytes = (8 * nd * n_sc + 8 * n_re * nd * nl + 4  # in
              + 8 * nl * n_sc + 8 * s["n_sym"] + 4 * 5)  # out
    r, p, h = n_re * nd * s["n_cdm"], n_re * nd * nl, n_re * nl
    ta = 5 * FFT_SIZE * math.log2(FFT_SIZE) * nl + 4 * 2 * HALF_CP * nl
    ops = (4 * r + 6 * p + 8 * h + 6 * p + 2 * p + 2 * h + 4 * smoothing_taps(cfg) * h + ta
           + 16 * p + 6 * r + 4 * h + 6 * (n_sc - n_re) * nl)
    return Work(bytes=float(nbytes), ops=float(ops))
