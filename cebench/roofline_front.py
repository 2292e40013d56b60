"""The work of the estimation's front for one problem, for K1's roofline share
(`k1_roofline_pct`).

The steps of `roofline_estimator.py` up to the smoothed pilot estimates and
the five scalars: the LS de-spread, EPRE, the first-pair CFO and its
removal, the time average, the CDM despread, the smoothing, the TA search,
noise and RSRP, counted as that file counts them (the same float32
operations, the virtual pilots left out). Left out are the fill of the
profiles over the band and their write, and the symbol rotations, which
follow the front. So the share reads the front's work, whatever computes it.

Bytes, each counted once, a complex value as two float32 (8 B):
  the grid's DM-RS REs       8 x nd x n_sc          (in)
  the pilots, as handed in   8 x n_re x nd x nL     (in)
  beta                       4                      (in)
  the smoothed estimates     8 x n_re x nL          (out: one hop)
  the five scalars           4 x 5                  (out)
"""
from __future__ import annotations

import math

from cebench import roofline_estimator as re_


def problem(cfg: dict) -> re_.Work:
    """The bytes and operations of the front of one problem."""
    s = re_.sizes(cfg)
    n_sc, n_re, nd, nl = s["n_sc"], s["n_re"], s["nd"], s["nl"]
    nbytes = 8 * nd * n_sc + 8 * n_re * nd * nl + 4 + 8 * n_re * nl + 4 * 5
    r, p, h = n_re * nd * s["n_cdm"], n_re * nd * nl, n_re * nl
    ta = 5 * re_.FFT_SIZE * math.log2(re_.FFT_SIZE) * nl + 4 * 2 * re_.HALF_CP * nl
    ops = (4 * r + 6 * p + 8 * h + 6 * p + 2 * p + 2 * h + 4 * re_.smoothing_taps(cfg) * h + ta
           + 16 * p + 6 * r + 4 * h)
    return re_.Work(bytes=float(nbytes), ops=float(ops))
