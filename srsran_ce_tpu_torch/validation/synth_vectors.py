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
header generator `generate_fuzz_header` (with its helpers) is a copy too,
for the deep selftest's header fuzz; tests/test_torch_fuzz.py holds its
text identical to the JAX package's.
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


# ---------------------------------------------------------------------------
# Full-fidelity header fuzzing (parser + hop-regrouping hardening)
# ---------------------------------------------------------------------------
#
# The real 248-vector header (absent from this environment) is messier than
# generate_suite's output: per-layer repeated hop blocks, multiple 52-length
# maskPRBs runs inside one hop block, hop_symbol present/absent, std::nullopt
# second hops, PRB masks with interior holes, erratic whitespace. These are
# exactly the spots where a parser rewrite silently diverges
# (validate_all.py:150-197, 419-437). generate_fuzz_header emits randomized
# headers with ALL of those quirks FROM INTENT — the returned expectation
# describes the true hop structure, so the fuzz test checks that
# vectors.parse_test_header + conformance._group_hops recover the intent, not
# that they reproduce their own output.


def _fmt_arr(vals, rng) -> str:
    """C++ array literal with randomized whitespace/newlines (the generated
    headers wrap lines at arbitrary points)."""
    parts = [str(int(v)) for v in vals]
    out = "{"
    for i, p in enumerate(parts):
        if i:
            out += "," + ("\n   " if rng.random() < 0.08 else " ")
        out += p
    return out + "}"


def _re_cols(rng, n_cdm: int):
    """Distinct (12,) DMRS RE-mask columns, 4-6 REs each."""
    cols = []
    seen = set()
    while len(cols) < n_cdm:
        c = np.zeros(12, dtype=int)
        c[rng.choice(12, size=int(rng.integers(4, 7)), replace=False)] = 1
        key = c.tobytes()
        if key not in seen:
            seen.add(key)
            cols.append(c)
    return cols


def _prb_mask(rng, grid: int, holes: bool):
    m = np.zeros(52, dtype=int)
    n = int(rng.integers(2, max(3, grid)))
    start = int(rng.integers(0, grid - n + 1))
    m[start : start + n] = 1
    if holes and n >= 4:
        # punch 1-2 interior holes (maskPRBs runs with gaps)
        for _ in range(int(rng.integers(1, 3))):
            m[start + int(rng.integers(1, n - 1))] = 0
    return m


def generate_fuzz_header(rng: np.random.Generator, n_cases: int):
    """Randomized full-fidelity header text + per-case intent.

    Returns (header_text, expected) where expected[i] is a dict with the
    scalar fields and `hops`: the TRUE grouped hop structure as a list of
    (dmrs_symbol_indices, prb_mask52, re_cols (12, n_cdm)) tuples.
    """
    blocks, expected = [], []
    for idx in range(n_cases):
        scs = int(rng.choice([15, 30]))
        smoothing = str(rng.choice(["filter", "mean", "none"]))
        cfo = bool(rng.integers(0, 2))
        grid = int(rng.integers(6, 53))
        beta = round(float(rng.uniform(0.5, 2.0)), 4)
        kind = str(
            rng.choice(["single", "single_rep", "dual_hs", "dual_mid", "multi_prb_runs"])
        )
        start = 0 if kind in ("dual_mid", "multi_prb_runs") else int(rng.integers(0, 3))
        n_alloc = int(rng.integers(6, 15 - start))
        n_cdm = int(rng.integers(1, 3))
        cols = _re_cols(rng, n_cdm)
        rm_flat = np.stack(cols, axis=1).reshape(-1)  # (12, n_cdm) column-recoverable

        # len-14 vs len-n_alloc DMRS masks both occur in the real header; they
        # coincide only when start == 0, and a case uses ONE convention.
        use_short = start == 0 and rng.random() < 0.4

        def dmrs_mask_arr(sym_idx):
            m14 = np.zeros(14, dtype=int)
            m14[list(sym_idx)] = 1
            return m14[:n_alloc] if use_short else m14

        hop_blocks = []  # raw per-block text pieces
        if kind in ("single", "single_rep"):
            n_ds = int(rng.integers(1, 5))
            syms = sorted(
                int(s) for s in rng.choice(np.arange(start, start + n_alloc), n_ds, False)
            )
            pm = _prb_mask(rng, grid, holes=rng.random() < 0.4)
            reps = int(rng.integers(2, 5)) if kind == "single_rep" else 1
            # per-layer repetition: either full multi-column RE mask each time,
            # or one column per layer (both occur; grouping concat+dedupe
            # recovers the same columns)
            per_layer_cols = reps > 1 and n_cdm > 1 and rng.random() < 0.5
            for r in range(reps):
                if per_layer_cols:
                    rm_r = cols[r % n_cdm].reshape(-1)
                else:
                    rm_r = rm_flat
                hop_blocks.append(
                    (dmrs_mask_arr(syms), [pm], None, rm_r)
                )
            exp_hops = [(syms, pm, np.stack(cols, axis=1))]
            if per_layer_cols and reps < n_cdm:
                exp_hops = [(syms, pm, np.stack(cols[:reps], axis=1))]
            hop2_field = "std::nullopt" if rng.random() < 0.5 else None
        elif kind == "dual_hs":
            boundary = start + n_alloc // 2 + int(rng.integers(-1, 2))
            boundary = min(max(boundary, start + 1), start + n_alloc - 1)
            s1 = sorted(
                int(s) for s in rng.choice(np.arange(start, boundary),
                                           int(rng.integers(1, min(3, boundary - start) + 1)), False)
            )
            s2 = sorted(
                int(s) for s in rng.choice(np.arange(boundary, start + n_alloc),
                                           int(rng.integers(1, min(3, start + n_alloc - boundary) + 1)), False)
            )
            pm1 = _prb_mask(rng, grid, holes=rng.random() < 0.3)
            pm2 = _prb_mask(rng, grid, holes=rng.random() < 0.3)
            hs2 = boundary if rng.random() < 0.5 else None
            hop_blocks.append((dmrs_mask_arr(s1), [pm1], boundary, rm_flat))
            hop_blocks.append((dmrs_mask_arr(s2), [pm2], hs2, rm_flat))
            exp_hops = [(s1, pm1, np.stack(cols, axis=1)), (s2, pm2, np.stack(cols, axis=1))]
            hop2_field = None
        elif kind == "dual_mid":
            # two hop blocks, NO hop_symbol anywhere -> mid-slot heuristic
            mid = n_alloc // 2
            s1 = sorted(int(s) for s in rng.choice(np.arange(0, mid),
                                                   int(rng.integers(1, min(3, mid) + 1)), False))
            s2 = sorted(int(s) for s in rng.choice(np.arange(mid, n_alloc),
                                                   int(rng.integers(1, min(3, n_alloc - mid) + 1)), False))
            pm1 = _prb_mask(rng, grid, holes=False)
            pm2 = _prb_mask(rng, grid, holes=False)
            hop_blocks.append((dmrs_mask_arr(s1), [pm1], None, rm_flat))
            hop_blocks.append((dmrs_mask_arr(s2), [pm2], None, rm_flat))
            exp_hops = [(s1, pm1, np.stack(cols, axis=1)), (s2, pm2, np.stack(cols, axis=1))]
            hop2_field = None
        else:  # multi_prb_runs: ONE dmrs block, TWO 52-length maskPRBs runs
            mid = n_alloc // 2
            s1 = sorted(int(s) for s in rng.choice(np.arange(0, mid),
                                                   int(rng.integers(1, min(3, mid) + 1)), False))
            s2 = sorted(int(s) for s in rng.choice(np.arange(mid, n_alloc),
                                                   int(rng.integers(1, min(3, n_alloc - mid) + 1)), False))
            pm1 = _prb_mask(rng, grid, holes=False)
            pm2 = _prb_mask(rng, grid, holes=False)
            hop_blocks.append((dmrs_mask_arr(sorted(s1 + s2)), [pm1, pm2], None, rm_flat))
            exp_hops = [(s1, pm1, np.stack(cols, axis=1)), (s2, pm2, np.stack(cols, axis=1))]
            hop2_field = None

        hop_texts = []
        for dm, pms, hs, rm in hop_blocks:
            parts = [_fmt_arr(dm, rng)]
            parts += [_fmt_arr(p, rng) for p in pms]
            if hs is not None:
                parts.append(str(int(hs)))
            parts.append(_fmt_arr(rm, rng))
            hop_texts.append("{" + ", ".join(parts) + "}")
        if hop2_field:
            hop_texts.append(hop2_field)

        blocks.append(
            "  {{{{\"uplink\", subcarrier_spacing::kHz{khz}, cyclic_prefix::NORMAL, "
            "{start}, {nalloc}, {beta}, "
            "port_channel_estimator_fd_smoothing_strategy::{sm}, {cfo}, {grid}, "
            "{hops}}}, "
            "{{\"port_channel_estimator_test_input_rg{idx}.dat\"}}, "
            "{{\"port_channel_estimator_test_pilots{idx}.dat\"}}, "
            "{{\"port_channel_estimator_test_output_ch_est{idx}.dat\"}}}},".format(
                khz=scs, start=start, nalloc=n_alloc, beta=beta, sm=smoothing,
                cfo="true" if cfo else "false", grid=grid,
                hops=", ".join(hop_texts), idx=idx,
            )
        )
        expected.append(
            dict(
                idx=idx, scs_hz=scs * 1000.0, start_symbol=start,
                n_alloc_syms=n_alloc, beta_dmrs=beta, smoothing=smoothing,
                cfo_compensate=cfo, grid_size_prbs=grid, hops=exp_hops,
            )
        )

    header = (
        "// Fuzzed synthetic header (full structural fidelity).\n"
        "static const std::vector<test_case_t> port_channel_estimator_test_data = {\n"
        + "\n".join(blocks)
        + "\n};\n"
    )
    return header, expected
