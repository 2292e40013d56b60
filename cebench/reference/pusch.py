"""What a correct PUSCH result is, and the numbers that judge one.

A slot's result is correct when every code block's payload equals the payload
sent, every block's CRC / parity flag is set, and the five measurement
scalars lie within the configuration's limit of the reference's: the float64
estimator (`oracle.estimate`) run on each receive antenna's grid as the
program received it, averaged over the antennas (the receiver folds its
antennas into the estimator and reports the port mean).

Numbers of one slot (a run sums the counts and takes the worst error):
  payload_bit_errors  payload bits that differ from those sent (limit 0)
  blocks_not_ok       code blocks whose CRC / parity flag is not set (limit 0)
  scalar_rel_err      the worst scalar error (numbers.scalar_err)
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

from . import numbers, oracle

AGGREGATE = {"payload_bit_errors": "sum", "blocks_not_ok": "sum", "scalar_rel_err": "max"}


def reference(slot, quantize: Callable = None) -> Dict[str, float]:
    """The antennas' mean of the float64 estimator's scalars; `quantize`
    rounds the inputs first (the control's lower precision)."""
    q = quantize or (lambda x: np.asarray(x, np.complex128))
    per_port = [oracle.estimate(q(slot.rg[r]), q(slot.pilots), slot.beta, slot.hop1, slot.hop2,
                                slot.config) for r in range(slot.rg.shape[0])]
    return {n: float(np.mean([getattr(o, n) for o in per_port])) for n in numbers.SCALARS}


def judge_slot(slot, results: List, ref: Dict[str, float]) -> Dict[str, float]:
    """The numbers of one slot's results (one result, with `info`, `ok` and
    the five scalars)."""
    if len(results) != 1:
        return {"payload_bit_errors": int(slot.payload.size),
                "blocks_not_ok": int(slot.payload.shape[0]), "scalar_rel_err": np.inf}
    (r,) = results
    info = np.asarray(r.info)
    ok = np.asarray(r.ok, bool)
    return {
        "payload_bit_errors": (int(np.count_nonzero(info != slot.payload))
                               if info.shape == slot.payload.shape else int(slot.payload.size)),
        "blocks_not_ok": (int(np.count_nonzero(~ok)) if ok.shape == slot.payload.shape[:1]
                          else int(slot.payload.shape[0])),
        "scalar_rel_err": numbers.scalar_err(numbers.scalars_of(r), ref),
    }


class ControlResult:
    """The reference in the program's place at the control's precision: the
    payload as sent (the reference has no decoder to get it wrong), every
    flag set, and the scalars of the estimator on TF32-rounded inputs."""

    def __init__(self, slot):
        self.info = slot.payload.copy()
        self.ok = np.ones(slot.payload.shape[0], bool)
        for n, v in reference(slot, numbers.tf32).items():
            setattr(self, n, v)


def control(slot) -> List:
    return [ControlResult(slot)]
