"""The measurement scalars every served result carries, how far a program's
reading may sit from the reference's, and the lower precision of the control.

A scalar's error is |program - reference| / max(|reference|, floor): relative
for the powers (noise, RSRP, EPRE are positive and far from 0), and against a
floor for the time alignment (one sample at 30 kHz x 4096, about 8 ns, where
the reference reads 0 on a channel whose first tap is the strongest) and the
CFO (1 Hz, against CFOs of some hundred Hz).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

SCALARS = ("noise_est", "rsrp", "epre", "time_alignment", "cfo_hz")
FLOORS = {"noise_est": 1e-30, "rsrp": 1e-30, "epre": 1e-30, "time_alignment": 1e-9,
          "cfo_hz": 1.0}


def scalars_of(result) -> Dict[str, float]:
    """The five scalars of a served result (or of an oracle result)."""
    return {n: float(getattr(result, n)) for n in SCALARS}


def scalar_err(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    """The worst of the five scalars' errors (a NaN reads as infinite)."""
    worst = 0.0
    for n in SCALARS:
        e = abs(prog[n] - ref[n]) / max(abs(ref[n]), FLOORS[n])
        worst = max(worst, e if np.isfinite(e) else np.inf)
    return worst


def tf32(x: np.ndarray) -> np.ndarray:
    """`x` rounded to TF32 (float32 with 10 mantissa bits, to nearest even),
    returned in float64 / complex128: the operands of a TF32 product."""
    x = np.asarray(x)
    if np.iscomplexobj(x):
        return tf32(x.real) + 1j * tf32(x.imag)
    f = np.array(x, np.float32)
    i = f.view(np.uint32)
    i += np.uint32(0xFFF) + ((i >> np.uint32(13)) & np.uint32(1))
    i &= np.uint32(0xFFFFE000)
    return f.astype(np.float64)


def nmse(est: np.ndarray, ref: np.ndarray) -> float:
    """sum |est - ref|^2 / sum |ref|^2 (a NaN reads as infinite)."""
    e = float(np.sum(np.abs(est.astype(np.complex128) - ref) ** 2) / np.sum(np.abs(ref) ** 2))
    return e if np.isfinite(e) else np.inf
