"""What a correct channel estimate is, and the numbers that judge one.

An estimation slot is one UE's DM-RS on each of the radio's antennas, one
problem an antenna. The program returns each problem's estimate in rank-1
factored form (per hop, a profile over subcarriers for each layer, and one
phase rotation per OFDM symbol) and the five measurement scalars. The
reference expands the factored form itself (zero outside each hop's
allocated symbols) and compares it with the float64 estimator
(`oracle.estimate`) run on the same grid.

Numbers of one slot (a run takes the worst):
  channel_nmse    the worst problem's NMSE of the expanded estimate against
                  the reference's grid (numbers.nmse)
  scalar_rel_err  the worst scalar error (numbers.scalar_err)
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

from . import numbers, oracle

AGGREGATE = {"channel_nmse": "max", "scalar_rel_err": "max"}


def reference(slot, quantize: Callable = None) -> List:
    """The float64 estimator's result for each antenna of the slot;
    `quantize` rounds the inputs first (the control's lower precision)."""
    q = quantize or (lambda x: np.asarray(x, np.complex128))
    return [oracle.estimate(q(slot.rg[r]), q(slot.pilots), slot.beta, slot.hop1, slot.hop2,
                            slot.config) for r in range(slot.rg.shape[0])]


def expand(profiles: np.ndarray, sym_rot: np.ndarray, slot) -> np.ndarray:
    """(n_sc, n_sym, n_layers) grid of a factored estimate: profiles (n_hops,
    n_layers, n_sc) times sym_rot (n_sym,) over each hop's allocated symbols."""
    n_sym = sym_rot.shape[0]
    hops = [slot.hop1] + ([slot.hop2] if slot.hop2 is not None and not slot.hop2.is_empty else [])
    out = np.zeros((profiles.shape[2], n_sym, profiles.shape[1]), np.complex128)
    for h, hop in enumerate(hops):
        s0, s1 = hop.start_symbol, hop.start_symbol + hop.n_allocated_symbols
        out[:, s0:s1, :] = (profiles[h].T[:, None, :].astype(np.complex128)
                            * sym_rot[None, s0:s1, None].astype(np.complex128))
    return out


def judge_slot(slot, results: List, ref: List) -> Dict[str, float]:
    """The numbers of one slot's results: one factored result an antenna,
    with `profiles`, `sym_rot` and the five scalars."""
    if len(results) != len(ref):
        return {"channel_nmse": np.inf, "scalar_rel_err": np.inf}
    worst_n = worst_s = 0.0
    for r, o in zip(results, ref):
        prof, rot = np.asarray(r.profiles), np.asarray(r.sym_rot)
        grid = (expand(prof, rot, slot) if prof.ndim == 3 and rot.ndim == 1
                else np.full_like(o.channel_est_rg, np.nan))
        e = numbers.nmse(grid, o.channel_est_rg) if grid.shape == o.channel_est_rg.shape \
            else np.inf
        worst_n = max(worst_n, e)
        worst_s = max(worst_s, numbers.scalar_err(numbers.scalars_of(r), numbers.scalars_of(o)))
    return {"channel_nmse": worst_n, "scalar_rel_err": worst_s}


class ControlResult:
    """The reference in the program's place at the control's precision: the
    float64 estimator on TF32-rounded inputs, factored as the program returns
    it (the time-invariant profile of each layer and the CFO's rotation)."""

    def __init__(self, o, slot):
        ch = o.channel_est_rg  # (n_sc, n_sym, n_layers), CFO-rotated per symbol
        s0 = slot.hop1.start_symbol
        mag = np.abs(ch[:, s0, :]).sum()
        k = np.unravel_index(np.argmax(np.abs(ch[:, s0, :])), ch[:, s0, :].shape)
        rot = ch[k[0], :, k[1]] / ch[k[0], s0, k[1]] if mag > 0 else np.ones(ch.shape[1])
        self.sym_rot = rot
        self.profiles = ch[:, s0, :].T[None]  # (1, n_layers, n_sc): hop 1 only
        for n in numbers.SCALARS:
            setattr(self, n, getattr(o, n))


def control(slot) -> List:
    return [ControlResult(o, slot) for o in reference(slot, numbers.tf32)]
