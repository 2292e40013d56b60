"""Synthetic srsRAN-format vector-suite generator.

The reference's conformance fixtures (testvector_outputs/: C++ config header +
binary .dat dumps) are MATLAB-generated and not shipped (SURVEY.md §4). This module
writes a *synthetic* suite in the exact same on-disk format — config header blocks,
expected_entry_t record files, raw complex64 pilot dumps — with golden outputs
produced by the float64 numpy oracle. The conformance runner can then be tested,
end to end and hermetically, through the identical code path it would use on the
real srsRAN vectors.

A numpy copy of `generate_suite` of `srsran_ce_tpu/validation/synth_vectors.py`
(the port cannot import the JAX package, whose `__init__` imports `jax`);
tests/test_torch_plan.py holds the two suites byte-identical. The fuzzed
header generator of that module serves the deep selftest, which the port does
not carry yet (ROADMAP.md queue 1, item 11).
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import numpy as np

from ..config import NRE
from ..utils import oracle, synthetic, vectors


def _arr(vals) -> str:
    return "{" + ", ".join(str(int(v)) for v in vals) + "}"


def _hop_block(hop, hop_symbol: Optional[int], n_prb_mask: int = 52) -> str:
    sym_mask = _arr(hop.dmrs_symbol_mask_np.astype(int))
    prb = np.zeros(n_prb_mask, dtype=int)
    pm = hop.prb_mask_np.astype(int)
    prb[: pm.size] = pm
    prb_mask = _arr(prb)
    # RE mask flattened so that numpy reshape(12, -1) (row-major) recovers the
    # (12, n_cdm) columns: flat[i*k + j] = col_j[i].
    rm = hop.dmrs_re_mask_np.astype(int)  # (12, n_cdm)
    re_mask = _arr(rm.reshape(-1))
    parts = [sym_mask, prb_mask]
    if hop_symbol is not None:
        parts.append(str(int(hop_symbol)))
    parts.append(re_mask)
    return "{" + ", ".join(parts) + "}"


def generate_suite(out_dir, case_specs: List[dict], seed0: int = 5000) -> Path:
    """Write a complete synthetic testvector_outputs/ directory.

    case_specs: list of synthetic.make_case kwargs (grid must be <= 52 PRBs wide to
    match srsRAN's fixed-length PRB masks). Returns the header path.
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    blocks = []
    for idx, spec in enumerate(case_specs):
        # srsRAN's header format uses fixed 52-entry PRB masks, so every synthetic
        # case lives on a 52-PRB grid (allocations can be narrower via prb_start).
        spec = dict(spec, n_prb_total=52)
        # Multi-RX-port cases (n_rx_ports > 1): one shared pilot sequence, one
        # per-port received grid (port p = a deterministic complex gain + fresh
        # AWGN on top of the base channel), one per-port expected estimate. This
        # exercises the runner's per-port estimation path — the reference harness
        # rejected such grids outright (validate_all.py infers a single port).
        n_rx = int(spec.pop("n_rx_ports", 1))
        case = synthetic.make_case(seed=seed0 + idx, **spec)
        if n_rx > 1:
            assert case.pilots.shape[2] == 1, "multi-rx-port cases use n_layers == 1"
        n_prb_total = len(case.hop1.prb_mask)
        assert n_prb_total == 52, "synthetic suite uses srsRAN's 52-entry PRB masks"

        rng = np.random.default_rng(seed0 + idx + 990_001)
        port_grids = [case.received_rg]
        for p in range(1, n_rx):
            g = (rng.standard_normal() + 1j * rng.standard_normal()) / np.sqrt(2.0)
            noise = 10 ** (-30.0 / 20.0) * (
                rng.standard_normal(case.received_rg.shape)
                + 1j * rng.standard_normal(case.received_rg.shape)
            ) / np.sqrt(2.0)
            port_grids.append(g * case.received_rg + noise)
        results = [
            oracle.estimate(rg_p, case.pilots, case.beta, case.hop1, case.hop2, case.config)
            for rg_p in port_grids
        ]

        # --- input resource grid dump: every allocated RE, all RX ports ---
        n_sc, n_sym = case.received_rg.shape
        sc, sym = np.meshgrid(np.arange(n_sc), np.arange(n_sym), indexing="ij")
        vectors.write_entries(
            out_dir / f"port_channel_estimator_test_input_rg{idx}.dat",
            np.tile(sym.reshape(-1), n_rx),
            np.repeat(np.arange(n_rx), sym.size),
            np.tile(sc.reshape(-1), n_rx),
            np.concatenate([g.astype(np.complex64).reshape(-1) for g in port_grids]),
        )

        # --- pilots dump: (sym, re, layer) storage order ---
        pil = np.transpose(case.pilots, (1, 0, 2)).astype(np.complex64)
        pil.reshape(-1).tofile(out_dir / f"port_channel_estimator_test_pilots{idx}.dat")

        # --- expected channel estimate at allocated coordinates ---
        # Entry port code = TX layer for single-RX-port cases, RX port otherwise.
        hops = [case.hop1] + ([case.hop2] if case.hop2 is not None else [])
        syms_list, ports_list, scs_list, vals_list = [], [], [], []
        n_layers = case.pilots.shape[2]
        n_out_ports = n_layers if n_rx == 1 else n_rx
        for hop in hops:
            sc0 = NRE * hop.prb_start
            scs_h = np.arange(sc0, sc0 + NRE * hop.n_prbs)
            syms_h = np.arange(hop.start_symbol, hop.start_symbol + hop.n_allocated_symbols)
            g_sc, g_sym, g_l = np.meshgrid(scs_h, syms_h, np.arange(n_out_ports), indexing="ij")
            syms_list.append(g_sym.reshape(-1))
            ports_list.append(g_l.reshape(-1))
            scs_list.append(g_sc.reshape(-1))
            if n_rx == 1:
                vals_list.append(results[0].channel_est_rg[g_sc, g_sym, g_l].reshape(-1))
            else:
                ch_ports = np.stack(
                    [r.channel_est_rg[:, :, 0] for r in results], axis=2
                )  # (n_sc, n_sym, n_rx)
                vals_list.append(ch_ports[g_sc, g_sym, g_l].reshape(-1))
        vectors.write_entries(
            out_dir / f"port_channel_estimator_test_output_ch_est{idx}.dat",
            np.concatenate(syms_list),
            np.concatenate(ports_list),
            np.concatenate(scs_list),
            np.concatenate(vals_list),
        )

        # --- header block ---
        scs_khz = int(case.config.scs_hz / 1000)
        smoothing = case.config.smoothing
        cfo = "true" if case.config.cfo_compensate else "false"
        hop2_block = (
            _hop_block(case.hop2, case.hop2.start_symbol, n_prb_total)
            if case.hop2 is not None
            else "std::nullopt"
        )
        hop1_block = _hop_block(
            case.hop1, case.hop2.start_symbol if case.hop2 is not None else None, n_prb_total
        )
        blocks.append(
            "  {{{{\"uplink\", subcarrier_spacing::kHz{khz}, cyclic_prefix::NORMAL, "
            "{start}, {nalloc}, {beta}, "
            "port_channel_estimator_fd_smoothing_strategy::{sm}, {cfo}, {grid}, "
            "{h1}, {h2}}}, "
            "{{\"port_channel_estimator_test_input_rg{idx}.dat\"}}, "
            "{{\"port_channel_estimator_test_pilots{idx}.dat\"}}, "
            "{{\"port_channel_estimator_test_output_ch_est{idx}.dat\"}}}},".format(
                khz=scs_khz,
                start=0,
                nalloc=n_sym,
                beta=float(case.beta),
                sm=smoothing,
                cfo=cfo,
                grid=n_prb_total,
                h1=hop1_block,
                h2=hop2_block,
                idx=idx,
            )
        )

    header = (
        "// Synthetic port_channel_estimator conformance vectors (oracle-generated).\n"
        "static const std::vector<test_case_t> port_channel_estimator_test_data = {\n"
        + "\n".join(blocks)
        + "\n};\n"
    )
    header_path = out_dir / "port_channel_estimator_test_data.h"
    header_path.write_text(header)
    return header_path
