"""Conformance runner of the port: replay srsRAN vectors (or the synthetic
goldens of `synth_vectors`) through the port's estimator, with asserted NMSE
bounds. Counterpart of `srsran_ce_tpu/validation/conformance.py`: the same case
heuristics (hop grouping, hop-boundary split, pilot-layout search; the
reference's scripts/validation/validate_all.py:366-571), the "xla" tier in the
reference layout, float64 by default, on an explicit torch device.

Every (pilot ordering x RX port) problem of a case runs in one batched call:
the JAX runner's fixed power-of-two chunks and its single-problem executable
for small searches exist to bound XLA compiles, which eager PyTorch does not
have. `debug_case` gives the failure forensics of one case.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from .. import devices
from ..config import EstimatorConfig, HopConfig, normal_cp_durations_ms
from ..models import estimator
from ..utils import vectors
from ..utils.vectors import ParsedCase


@dataclass
class CaseResult:
    idx: int
    max_err: float
    rms_err: float
    nmse: float
    ordering: str
    n_layers: int
    passed: bool
    message: str = ""


def build_hop_config(
    dmrs_symbols: np.ndarray,
    mask_prbs: np.ndarray,
    dmrs_re_mask: np.ndarray,
    start_symbol: int,
    n_alloc_syms: int,
) -> HopConfig:
    """numpy masks -> HopConfig (reference build_hop_config, validate_all.py:286-303)."""
    mask_prbs = np.asarray(mask_prbs, dtype=bool)
    n_prbs = int(mask_prbs.sum())
    prb_start = int(np.nonzero(mask_prbs)[0][0]) if n_prbs > 0 else 0
    return HopConfig.make(
        dmrs_symbols, np.asarray(dmrs_re_mask, dtype=bool).reshape(12, -1),
        prb_start, n_prbs, mask_prbs, start_symbol, n_alloc_syms,
    )


def _group_hops(case: ParsedCase):
    """Group per-layer-repeated hop entries, stack their RE-mask columns, split DMRS
    symbols at the hop boundary (validate_all.py:393-437)."""
    raw = []
    for hop in case.hops:
        raw.append(
            (
                np.array(hop.dmrs_symbols, dtype=bool),
                np.array(hop.mask_prbs, dtype=bool),
                np.array(hop.dmrs_re_mask, dtype=bool).reshape(12, -1),
                hop.hop_symbol,
            )
        )
    if not raw:
        raise ValueError(f"case {case.idx}: no hops parsed")

    grouped = []
    for dm, pm, rm, hs in raw:
        for i, (gdm, gpm, grm, ghs) in enumerate(grouped):
            if np.array_equal(dm, gdm) and np.array_equal(pm, gpm) and hs == ghs:
                grouped[i] = (gdm, gpm, np.concatenate([grm, rm], axis=1), ghs)
                break
        else:
            grouped.append((dm, pm, rm, hs))
    grouped = [
        (dm, pm, vectors.dedupe_re_mask_columns(rm), hs) for dm, pm, rm, hs in grouped
    ]

    union = np.logical_or.reduce([g[0] for g in grouped])
    sym_idx = np.nonzero(union)[0].tolist()
    n_hops = len(grouped)

    if n_hops == 2 and any(g[3] is not None for g in grouped):
        hop_symbol = next(g[3] for g in grouped if g[3] is not None)
        subsets = [
            [i for i in sym_idx if i < hop_symbol],
            [i for i in sym_idx if i >= hop_symbol],
        ]
    elif n_hops == 2:
        hop_symbol = case.n_alloc_syms // 2  # mid-slot heuristic
        subsets = [
            [i for i in sym_idx if i < hop_symbol],
            [i for i in sym_idx if i >= hop_symbol],
        ]
    elif n_hops == 1:
        subsets = [sym_idx]
    else:
        merged = (
            np.logical_or.reduce([g[0] for g in grouped]),
            np.logical_or.reduce([g[1] for g in grouped]),
            grouped[0][2],
            None,
        )
        grouped = [merged]
        subsets = [sym_idx]

    hops = []
    for (dm, pm, rm, _), subset in zip(grouped, subsets):
        mask = np.zeros_like(dm)
        mask[subset] = True
        hops.append((mask, pm, rm))
    return hops


def run_case(
    case: ParsedCase,
    data_dir,
    nmse_bound_db: float = -40.0,
    use_x64: bool = True,
    device="cuda",
) -> CaseResult:
    """Replay one srsRAN vector case through the port's estimator on `device`;
    assert the NMSE bound. The best of all pilot orderings is kept. `device`
    is the card by default; raises when there is none."""
    device = devices.resolve(device)
    data_dir = Path(data_dir)
    rg_entries = vectors.load_entries(
        data_dir / f"port_channel_estimator_test_input_rg{case.idx}.dat"
    )
    ch_entries = vectors.load_entries(
        data_dir / f"port_channel_estimator_test_output_ch_est{case.idx}.dat"
    )
    pilots_flat = np.fromfile(
        data_dir / f"port_channel_estimator_test_pilots{case.idx}.dat", dtype=np.complex64
    )

    n_sc = case.grid_size_prbs * 12
    n_sym = max(
        case.n_alloc_syms,
        int(rg_entries["sym"].max()) + 1 if rg_entries.size else 0,
        int(ch_entries["sym"].max()) + 1 if ch_entries.size else 0,
        14,
    )
    rg_all = vectors.entries_to_grid(rg_entries, n_sc, n_sym)  # (n_sc, n_sym, n_rx)
    n_rx = rg_all.shape[2]

    hops = _group_hops(case)
    hop1 = build_hop_config(*hops[0], case.start_symbol, case.n_alloc_syms)
    hop2 = (
        build_hop_config(*hops[1], case.start_symbol, case.n_alloc_syms)
        if len(hops) > 1
        else None
    )
    config = EstimatorConfig(
        scs_hz=case.scs_hz,
        cp_durations_ms=tuple(normal_cp_durations_ms(case.scs_hz, 14)),
        smoothing=case.smoothing,
        cfo_compensate=case.cfo_compensate,
    )

    n_dsym_total = sum(h[0].sum() for h in hops)
    dmrs_per_prb = int(hops[0][2][:, 0].sum())
    n_re = dmrs_per_prb * int(hops[0][1].sum())
    if pilots_flat.size % (n_dsym_total * n_re) != 0:
        raise ValueError(
            f"case {case.idx}: pilots size {pilots_flat.size} not divisible by "
            f"{n_dsym_total * n_re}"
        )
    n_layers = pilots_flat.size // (n_dsym_total * n_re)
    if n_rx > 1 and n_layers != 1:
        # With several RX ports AND several TX layers, the entry port code is
        # ambiguous (layer vs RX port) — srsRAN's port_channel_estimator vectors
        # never mix the two.
        raise ValueError(
            f"case {case.idx}: multi-RX-port grids supported for single-layer cases only"
        )

    dtype = np.complex128 if use_x64 else np.complex64
    ref_vals = ch_entries["value"].astype(np.complex128)
    ref_power = float(np.mean(np.abs(ref_vals) ** 2)) + 1e-30

    # every (pilot ordering x RX port) problem of the case in one batched call
    cands = vectors.pilot_candidates(pilots_flat, int(n_dsym_total), int(n_re), int(n_layers))
    problems = [(ci, p) for ci in range(len(cands)) for p in range(n_rx)]
    rg_ports = [estimator.split_ri(rg_all[:, :, p].astype(dtype)) for p in range(n_rx)]
    pil_ris = [estimator.split_ri(pil.astype(dtype)) for _, pil in cands]
    fn = estimator.build_ri(hop1, hop2, config, int(n_layers), batched=True)
    rg_b = torch.as_tensor(np.stack([rg_ports[p] for _, p in problems]), device=device)
    pil_b = torch.as_tensor(np.stack([pil_ris[ci] for ci, _ in problems]), device=device)
    beta_b = torch.full((len(problems),), case.beta_dmrs, dtype=rg_b.dtype, device=device)
    ch_all = np.moveaxis(fn(rg_b, pil_b, beta_b).channel_est_rg.cpu().numpy(), 1, 0)
    ch_all = estimator.merge_ri(ch_all)  # (n_problems, n_sc, n_sym, nL)

    best: Optional[CaseResult] = None
    for ci, (ordering, _) in enumerate(cands):
        # One estimate per RX port (srsRAN's per-port channel estimator); for
        # n_rx == 1 the output port axis indexes TX layers, for n_rx > 1 RX ports.
        ch_ports = [ch_all[ci * n_rx + p] for p in range(n_rx)]
        ch = ch_ports[0] if n_rx == 1 else np.concatenate(ch_ports, axis=2)
        est_vals = ch[ch_entries["sc"], ch_entries["sym"], ch_entries["port"]].astype(
            np.complex128
        )
        diff = est_vals - ref_vals
        max_err = float(np.max(np.abs(diff))) if diff.size else 0.0
        rms_err = float(np.sqrt(np.mean(np.abs(diff) ** 2))) if diff.size else 0.0
        nmse = float(np.mean(np.abs(diff) ** 2)) / ref_power
        cand = CaseResult(
            idx=case.idx,
            max_err=max_err,
            rms_err=rms_err,
            nmse=nmse,
            ordering=ordering,
            n_layers=int(n_layers),
            passed=10.0 * math.log10(nmse + 1e-300) < nmse_bound_db,
        )
        if best is None or cand.rms_err < best.rms_err:
            best = cand
    return best


def debug_case(case: ParsedCase, data_dir, use_x64: bool = True, device="cuda") -> dict:
    """Failure forensics for one vector case on `device` (the card by
    default; raises when there is none): the reference's DEBUG_CASES dump
    (validate_all.py:490-525) plus validate_case4.py:152-167's complex-gain
    alignment, float64 by default.

    Returns a JSON-able dict with, per pilot-ordering candidate (best first):
      * rms/nmse at every reference coordinate (what run_case scores),
      * rms at the DM-RS coordinates only (where the estimate is anchored: a
        case good here but bad elsewhere failed in interp/fill, not in
        LS/smoothing),
      * the best-fit complex scalar g = <est, ref> / <est, est> and the
        residual NMSE after applying it, which tells "wrong by a global
        complex gain/phase" (a pilot convention mismatch) from "wrong".
    Plus the case's DMRS coordinate sets and candidate pilot shapes.
    """
    device = devices.resolve(device)
    data_dir = Path(data_dir)
    ch_entries = vectors.load_entries(
        data_dir / f"port_channel_estimator_test_output_ch_est{case.idx}.dat"
    )
    rg_entries = vectors.load_entries(
        data_dir / f"port_channel_estimator_test_input_rg{case.idx}.dat"
    )
    pilots_flat = np.fromfile(
        data_dir / f"port_channel_estimator_test_pilots{case.idx}.dat", dtype=np.complex64
    )
    n_sc = case.grid_size_prbs * 12
    n_sym = max(case.n_alloc_syms, int(rg_entries["sym"].max()) + 1 if rg_entries.size else 0, 14)
    rg_all = vectors.entries_to_grid(rg_entries, n_sc, n_sym)

    hops = _group_hops(case)
    hop1 = build_hop_config(*hops[0], case.start_symbol, case.n_alloc_syms)
    hop2 = (
        build_hop_config(*hops[1], case.start_symbol, case.n_alloc_syms)
        if len(hops) > 1
        else None
    )
    config = EstimatorConfig(
        scs_hz=case.scs_hz,
        cp_durations_ms=tuple(normal_cp_durations_ms(case.scs_hz, 14)),
        smoothing=case.smoothing,
        cfo_compensate=case.cfo_compensate,
    )
    n_dsym_total = sum(h[0].sum() for h in hops)
    dmrs_per_prb = int(hops[0][2][:, 0].sum())
    n_re = dmrs_per_prb * int(hops[0][1].sum())
    n_layers = pilots_flat.size // max(n_dsym_total * n_re, 1)

    # DM-RS coordinate sets per hop (sc indices x dmrs symbol indices)
    dmrs_coords = []
    for mask, pm, rm in hops:
        sc0 = 12 * int(np.nonzero(np.asarray(pm, bool))[0][0])
        band = np.kron(np.asarray(pm, bool), np.ones(12, bool))
        re_any = np.asarray(rm, bool).any(axis=1)
        scs_hop = np.nonzero(band & np.tile(re_any, band.size // 12))[0]
        dmrs_coords.append(
            dict(
                dmrs_symbols=np.nonzero(mask)[0].tolist(),
                first_sc=int(scs_hop[0]) if scs_hop.size else None,
                n_dmrs_sc=int(scs_hop.size),
                sc_band_start=sc0,
            )
        )
    dmrs_sym_set = sorted({s for d in dmrs_coords for s in d["dmrs_symbols"]})
    at_dmrs = np.isin(ch_entries["sym"], dmrs_sym_set)

    dtype = np.complex128 if use_x64 else np.complex64
    ref_vals = ch_entries["value"].astype(np.complex128)
    ref_power = float(np.mean(np.abs(ref_vals) ** 2)) + 1e-30
    fn = estimator.build(hop1, hop2, config, int(n_layers), device=device)
    cand_reports = []
    for ordering, pil in vectors.pilot_candidates(
        pilots_flat, int(n_dsym_total), int(n_re), int(n_layers)
    ):
        ch_ports = [
            fn(rg_all[:, :, p].astype(dtype), pil.astype(dtype), case.beta_dmrs).channel_est_rg
            for p in range(rg_all.shape[2])
        ]
        ch = ch_ports[0] if rg_all.shape[2] == 1 else np.concatenate(ch_ports, axis=2)
        est = ch[ch_entries["sc"], ch_entries["sym"], ch_entries["port"]].astype(np.complex128)
        diff = est - ref_vals
        # best-fit complex gain (validate_case4.py:152-167)
        den = float(np.sum(np.abs(est) ** 2)) + 1e-300
        g = complex(np.sum(np.conj(est) * ref_vals) / den)
        resid = est * g - ref_vals
        dm_rms = (
            float(np.sqrt(np.mean(np.abs(diff[at_dmrs]) ** 2))) if at_dmrs.any() else None
        )
        cand_reports.append(
            dict(
                ordering=ordering,
                pilot_shape=list(pil.shape),
                rms=float(np.sqrt(np.mean(np.abs(diff) ** 2))),
                nmse=float(np.mean(np.abs(diff) ** 2)) / ref_power,
                dmrs_rms=dm_rms,
                gain_abs=abs(g),
                gain_deg=float(np.angle(g, deg=True)),
                nmse_after_gain=float(np.mean(np.abs(resid) ** 2)) / ref_power,
            )
        )
    cand_reports.sort(key=lambda r: r["rms"])
    return dict(
        idx=case.idx,
        n_layers=int(n_layers),
        n_rx=int(rg_all.shape[2]),
        n_re=int(n_re),
        n_dsym=int(n_dsym_total),
        dmrs_coords=dmrs_coords,
        n_ref_coords=int(ch_entries.size),
        candidates=cand_reports,
    )


def run_suite(
    header_path,
    data_dir,
    nmse_bound_db: float = -40.0,
    case_filter: Optional[List[int]] = None,
    device="cuda",
) -> dict:
    """Replay the full vector suite on `device`; returns a JSON-able report
    with pass/fail. A case that raises is recorded as failed with its message.
    `device` is the card by default; without one the suite raises."""
    device = devices.resolve(device)
    cases = vectors.parse_test_header(header_path)
    if case_filter:
        cases = [c for c in cases if c.idx in set(case_filter)]
    results = []
    for case in cases:
        try:
            r = run_case(case, data_dir, nmse_bound_db, device=device)
            results.append(r)
        except Exception as e:  # record failures, keep going
            results.append(
                CaseResult(case.idx, float("inf"), float("inf"), float("inf"), "-", 0, False, str(e))
            )
    n_pass = sum(r.passed for r in results)
    worst = max(results, key=lambda r: r.rms_err) if results else None
    return {
        "n_cases": len(results),
        "n_pass": n_pass,
        "nmse_bound_db": nmse_bound_db,
        "worst_case": worst.idx if worst else None,
        "worst_rms": worst.rms_err if worst else None,
        "results": [r.__dict__ for r in results],
    }
