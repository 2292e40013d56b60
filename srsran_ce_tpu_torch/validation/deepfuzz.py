"""Deep-fuzz evidence runner of the port: `srsran_ce_tpu/validation/deepfuzz.py` in torch.

`cli selftest --deep` runs the sweeps at depth on one device and writes an
auditable JSON report (cases run, NMSE histogram, worst case):

  geometry  random (PRBs, layers, comb, SCS, smoothing, CFO, interp, hops,
            holes, pilot source, time-interp, Doppler) configurations through
            `estimator.estimate` in float64 on the device against the float64
            numpy oracle (NMSE < GEOMETRY_NMSE_BOUND), the factored layout
            against the dense grid;
  coded     random (modulation, code options, CRC, schedule, scramble, MIMO)
            configurations through the whole served chain
            (`serving.process(out="decoded")`, the host and the device decode
            paths): exact payload recovery;
  header    the test-header parser and hop regrouping on fuzzed headers
            generated from intent (`synth_vectors.generate_fuzz_header`).

The draws are the JAX package's, so a trial number names the same
configuration in both packages. The JAX runner's fourth sweep, randomized
geometries across the subcarrier-sharded builders, needs the parallel paths,
which the port does not carry yet (ROADMAP.md queue 1, item 10): `run_all`
reports it as not run and asking for it raises.

All functions return plain dicts; pass/fail policy lives in the callers
(pytest asserts, the CLI's exit code).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .. import devices

# NMSE bound for the geometry sweep: the float64 estimator matches the oracle
# to reassociation error (the JAX package's bound)
GEOMETRY_NMSE_BOUND = 1e-18


def draw_geometry(rng: np.random.Generator) -> dict:
    """One random estimator geometry (the JAX package's draw)."""
    two_hops = bool(rng.random() < 0.25)
    smoothing = rng.choice(["filter", "filter", "mean", "none", "wiener"])
    comb = int(rng.choice([2, 2, 3, 4, 6]))
    n_layers = int(rng.choice([1, 1, 2, 3, 4]))
    if two_hops:
        n_prbs = int(rng.choice([3, 6, 12, 24, 52]))
    else:
        n_prbs = int(rng.choice([1, 2, 5, 16, 24, 52, 106, 273]))
    n_dmrs_syms = int(rng.choice([2, 4] if two_hops else [1, 2, 4]))
    kw = dict(
        n_prbs=n_prbs,
        n_layers=n_layers,
        comb=comb,
        scs_hz=float(rng.choice([15e3, 30e3])),
        smoothing=str(smoothing),
        cfo_compensate=bool(rng.random() < 0.7),
        interp=str(rng.choice(["linear", "linear", "cnn"])),
        cnn_alpha=float(rng.choice([0.0, 0.0, 0.3])),
        two_hops=two_hops,
        n_dmrs_syms=n_dmrs_syms,
        snr_db=float(rng.uniform(10.0, 40.0)),
        cfo_hz=float(rng.uniform(-300.0, 300.0)),
        beta=float(rng.choice([1.0, 1.0, 1.4125])),
        time_interp=str(rng.choice(["none", "none", "linear"])),
        doppler_hz=float(rng.choice([0.0, 0.0, 300.0])),
        cfo_estimator=str(rng.choice(["first_pair", "first_pair", "wls"])),
    )
    if not two_hops and rng.random() < 0.3:
        # offset band inside a wider carrier
        pad = int(rng.integers(1, 30))
        kw["n_prb_total"] = n_prbs + 2 * pad
        kw["prb_start"] = pad
    if n_prbs >= 4 and rng.random() < 0.2:
        # non-contiguous maskPRBs: an interior hole
        h0 = int(rng.integers(1, n_prbs - 2))
        h1 = int(rng.integers(h0 + 1, n_prbs))
        kw["prb_hole"] = (h0, h1)
    if comb == 2 and rng.random() < 0.3:
        # standard TS 38.211 sequences instead of random QPSK pilots
        hole = kw.get("prb_hole")
        n_prbs_eff = n_prbs - (hole[1] - hole[0] if hole else 0)
        m_zc = n_prbs_eff * 6
        if m_zc >= 36 or m_zc == 30:  # 30 = closed-form short sequence
            kw["pilot_source"] = str(rng.choice(["dmrs", "srs"]))
        else:
            kw["pilot_source"] = "dmrs"
        if kw["pilot_source"] == "dmrs" and rng.random() < 0.3:
            kw["dmrs_type"] = 2  # adjacent-pair clusters, 4 REs/PRB
    return kw


def check_geometry(draw: int, seed_base: int = 0xCE_F0, device="cuda") -> dict:
    """One fuzzed geometry through `estimator.estimate` in float64 on `device`
    (the card by default) and the float64 oracle; returns {draw, kwargs,
    nmse, scalar_errs, factored_err, ok}."""
    from ..models import estimator
    from ..utils import oracle, synthetic

    dev = devices.resolve(device)
    rng = np.random.default_rng(seed_base + draw)
    kw = draw_geometry(rng)
    case = synthetic.make_case(seed=int(rng.integers(0, 2**31)), **kw)
    res_p = estimator.estimate(case.received_rg, case.pilots, case.beta, case.hop1, case.hop2,
                               case.config, device=dev)
    res_o = oracle.estimate(case.received_rg, case.pilots, case.beta, case.hop1, case.hop2,
                            case.config)
    ch_p = np.asarray(res_p.channel_est_rg)
    ch_o = res_o.channel_est_rg
    nmse = float(np.sum(np.abs(ch_p - ch_o) ** 2) / (np.sum(np.abs(ch_o) ** 2) + 1e-30))

    def rel(a, b, atol=0.0):
        # allclose semantics: an absolute floor covers true-zero quantities
        # (smoothing="none" with one DM-RS symbol reconstructs the pilots
        # exactly, so the noise estimate is pure rounding)
        return float(abs(a - b) / (abs(b) + atol / 1e-7 + 1e-300))

    scalar_errs = {
        "noise": rel(float(res_p.noise_est), res_o.noise_est, atol=1e-20),
        "rsrp": rel(float(res_p.rsrp), res_o.rsrp),
        "epre": rel(float(res_p.epre), res_o.epre),
        "ta": float(abs(float(res_p.time_alignment) - res_o.time_alignment)),
    }
    if res_o.cfo_hz is None:
        scalar_errs["cfo"] = 0.0 if np.isnan(float(res_p.cfo_hz)) else float("inf")
    else:
        scalar_errs["cfo"] = rel(float(res_p.cfo_hz), res_o.cfo_hz)

    factored_err = None
    if case.config.time_interp == "none":
        n_layers = case.pilots.shape[2]
        r_fac = estimator.build_ri(case.hop1, case.hop2, case.config, n_layers,
                                   out_layout="factored")(
            torch.as_tensor(estimator.split_ri(case.received_rg), device=dev),
            torch.as_tensor(estimator.split_ri(case.pilots), device=dev),
            float(case.beta),
        )
        grid = estimator.reconstruct_factored(
            estimator.merge_ri(r_fac.profiles.cpu().numpy()),
            estimator.merge_ri(r_fac.sym_rot.cpu().numpy()),
            case.hop1,
            case.hop2,
        )
        factored_err = float(np.max(np.abs(grid - ch_p)) / (np.max(np.abs(ch_p)) + 1e-30))

    ok = (
        nmse < GEOMETRY_NMSE_BOUND
        and scalar_errs["noise"] < 1e-7
        and scalar_errs["rsrp"] < 1e-8
        and scalar_errs["epre"] < 1e-8
        and scalar_errs["ta"] < 1e-12
        and scalar_errs["cfo"] < 1e-7
        and (factored_err is None or factored_err < 1e-11)
    )
    return {
        "draw": draw,
        "kwargs": {k: (list(v) if isinstance(v, tuple) else v) for k, v in kw.items()},
        "nmse": nmse,
        "scalar_errs": scalar_errs,
        "factored_err": factored_err,
        "ok": ok,
    }


def run_geometry_fuzz(n: int, seed_base: int = 0xCE_F0, progress=None, device="cuda") -> dict:
    """N geometry draws on `device`; a report with an NMSE histogram (log10
    bins) and the worst case's full configuration."""
    t0 = time.time()
    rows = []
    for d in range(n):
        rows.append(check_geometry(d, seed_base, device=device))
        if progress and (d + 1) % 10 == 0:
            progress(f"geometry {d + 1}/{n}")
    nmses = np.array([r["nmse"] for r in rows])
    worst = max(rows, key=lambda r: r["nmse"])
    hist = {}
    for r in rows:
        b = "<=-24" if r["nmse"] <= 1e-24 else str(int(np.ceil(np.log10(r["nmse"]))))
        hist[b] = hist.get(b, 0) + 1
    return {
        "n_cases": n,
        "n_pass": int(sum(r["ok"] for r in rows)),
        "nmse_bound": GEOMETRY_NMSE_BOUND,
        "nmse_log10_histogram": dict(sorted(hist.items())),
        "nmse_max": float(nmses.max()),
        "nmse_median": float(np.median(nmses)),
        "worst_case": worst,
        "failures": [r for r in rows if not r["ok"]],
        "elapsed_s": time.time() - t0,
    }


def coded_trial(trial: int, device="cuda") -> dict:
    """One coded-chain fuzz trial (the JAX package's draw) on `device`: the
    whole served TX -> RX chain must recover the exact payload. Every third
    trial (trial % 3 == 2) decodes on the device (`decode_on_device=True`,
    which ignores early_iters, so those draws pin them off)."""
    from .. import serving, transport
    from ..ops import demap, ldpc, sequences
    from ..utils import synthetic

    dev = devices.resolve(device)
    rng = np.random.default_rng(8800 + trial)
    two_hops = bool(trial % 3 == 1)
    n_prbs = int(rng.choice([6, 12, 18] if not two_hops else [4, 6]))
    n_layers = int(rng.choice([1, 2]))
    n_rx = int(rng.choice([1, 2, 3]))
    if n_rx < n_layers:
        n_rx = n_layers
    modulation = str(rng.choice(["bpsk", "qpsk", "16qam", "256qam", "1024qam"]))
    scramble = bool(rng.integers(0, 2))
    crc = str(rng.choice(["crc16", "crc24b"])) if rng.integers(0, 2) else None
    schedule = "layered" if rng.integers(0, 2) else "flooding"
    early = int(rng.choice([0, 6]))  # 0 -> disabled
    code = ldpc.array_code(4, 8, 23)  # n=184, rate ~0.5
    plan = ldpc.make_ldpc_plan(code)
    nbits = demap.bits_per_symbol(modulation)
    snr_db = {"256qam": 35.0, "1024qam": 42.0}.get(modulation, 30.0)
    if modulation in ("256qam", "1024qam"):
        n_rx = max(n_rx, n_layers + 1)
    seed = 9100 + trial
    rnti = 0x17A3
    c_init = sequences.pusch_scrambling_c_init(rnti, seed % 1024) if scramble else None
    coding = transport.TransportCoding(
        code=code, n_iters=25, interleave_seed=trial,
        scramble_c_init=c_init, crc=crc, schedule=schedule,
        early_iters=early or None,
    )
    geo = synthetic.make_case(
        seed=seed, snr_db=snr_db, n_prbs=n_prbs, n_layers=n_layers, two_hops=two_hops
    )
    n_sc, n_sym = geo.received_rg.shape
    lay = transport.layout(coding, geo.hop1, geo.hop2, n_sc, n_sym, n_layers, nbits)
    kp = transport.payload_bits(coding, plan.k)
    u = rng.integers(0, 2, (lay.c_words, kp), dtype=np.uint8)
    payload = transport.crc_attach(u, crc) if crc else u
    bits = transport.place_codewords(
        lay, ldpc.encode(code, payload), n_layers, nbits, fill_rng=rng
    )
    case = synthetic.make_mimo_case(
        seed=seed, snr_db=snr_db, bits=bits, n_rx=n_rx, modulation=modulation,
        scramble=scramble, rnti=rnti, n_prbs=n_prbs, n_layers=n_layers,
        two_hops=two_hops,
    )
    prob = serving.Problem(
        case.received_rg.astype(np.complex64), case.pilots.astype(np.complex64),
        case.beta, case.hop1, case.hop2, case.config,
    )
    on_device = bool(trial % 3 == 2)
    if on_device and early:
        coding = dataclasses.replace(coding, early_iters=None)
    res = serving.process(
        [prob], batch_size=4, out="decoded", modulation=modulation, coding=coding,
        matmul_precision=None, decode_on_device=on_device, device=dev,
    )[0]
    cfg = dict(mod=modulation, prbs=n_prbs, nL=n_layers, rx=n_rx, hops=two_hops,
               scr=scramble, crc=crc, sched=schedule, early=early, words=lay.c_words,
               dev=on_device)
    ok = (
        res.info.shape == (lay.c_words, kp)
        and bool(np.asarray(res.ok).all())
        and np.array_equal(res.info, u)
    )
    return {"trial": trial, "config": cfg, "ok": bool(ok)}


def run_coded_fuzz(n: int, progress=None, device="cuda") -> dict:
    t0 = time.time()
    rows = []
    for t in range(n):
        rows.append(coded_trial(t, device=device))
        if progress and (t + 1) % 5 == 0:
            progress(f"coded {t + 1}/{n}")
    return {
        "n_cases": n,
        "n_pass": int(sum(r["ok"] for r in rows)),
        "configs": [r["config"] for r in rows],
        "failures": [r for r in rows if not r["ok"]],
        "elapsed_s": time.time() - t0,
    }


def _check(cond, msg="") -> None:
    if not cond:
        raise AssertionError(msg)


def run_header_fuzz(n_cases: int, seed: int = 20260820, tmp_dir: Optional[str] = None) -> dict:
    """Header-parser and hop-regrouping fuzz: the parsed cases and their
    regrouped hops must recover the intent the headers were generated from
    (the JAX package's checks; host only)."""
    import tempfile
    from pathlib import Path

    from ..utils import vectors
    from . import conformance, synth_vectors

    t0 = time.time()
    rng = np.random.default_rng(seed)
    header, expected = synth_vectors.generate_fuzz_header(rng, n_cases)
    with tempfile.TemporaryDirectory(dir=tmp_dir) as td:
        path = Path(td) / "port_channel_estimator_test_data.h"
        path.write_text(header)
        cases = vectors.parse_test_header(path)

    failures = []
    if len(cases) != n_cases:
        failures.append(f"parsed {len(cases)} cases, emitted {n_cases}")
    for case, exp in zip(cases, expected):
        try:
            _check(case.idx == exp["idx"])
            _check(case.scs_hz == exp["scs_hz"])
            _check(case.start_symbol == exp["start_symbol"])
            _check(case.n_alloc_syms == exp["n_alloc_syms"])
            _check(abs(case.beta_dmrs - exp["beta_dmrs"]) < 1e-9)
            _check(case.smoothing == exp["smoothing"])
            _check(case.cfo_compensate == exp["cfo_compensate"])
            _check(case.grid_size_prbs == exp["grid_size_prbs"])
            hops = conformance._group_hops(case)
            _check(len(hops) == len(exp["hops"]), f"hop count {len(hops)} != {len(exp['hops'])}")
            for (mask, pm, rm), (e_syms, e_pm, e_rm) in zip(hops, exp["hops"]):
                got_syms = np.nonzero(mask)[0].tolist()
                _check(got_syms == list(e_syms), (got_syms, e_syms))
                _check(np.array_equal(np.asarray(pm, bool), np.asarray(e_pm, bool)))
                got_cols = {rm[:, i].tobytes() for i in range(rm.shape[1])}
                want_cols = {np.asarray(e_rm[:, i], bool).tobytes() for i in range(e_rm.shape[1])}
                _check(got_cols == want_cols, "re-mask columns mismatch")
                conformance.build_hop_config(mask, pm, rm, case.start_symbol, case.n_alloc_syms)
        except AssertionError as e:
            failures.append(f"case {exp['idx']}: {e}")
    return {
        "n_cases": n_cases,
        "n_pass": n_cases - len(failures),
        "failures": failures[:20],
        "elapsed_s": time.time() - t0,
    }


def run_all(
    n_geometry: int = 100,
    n_coded: int = 30,
    n_header: int = 120,
    n_sp: int = 0,
    progress=None,
    device="cuda",
) -> dict:
    """The deep-fuzz sweep on `device` (the card by default; raises when
    there is none); the CLI writes this dict as the JSON report. `n_sp` > 0
    (the sharded sweep) raises: the parallel paths are not ported."""
    if n_sp:
        raise NotImplementedError(
            f"n_sp={n_sp}: the sharded-seam sweep needs the parallel paths, not ported yet "
            "(ROADMAP.md queue 1, item 10); pass 0")
    dev = devices.resolve(device)
    report = {
        "device": str(dev),
        "device_name": devices.name(dev),
        "float64": True,  # the geometry sweep's dtype (the JAX report's x64)
        "geometry": run_geometry_fuzz(n_geometry, progress=progress, device=dev),
        "coded": run_coded_fuzz(n_coded, progress=progress, device=dev),
        "header": run_header_fuzz(n_header),
        "sp": {"ported": False},
    }
    report["all_pass"] = all(
        report[k]["n_pass"] == report[k]["n_cases"] for k in ("geometry", "coded", "header")
    )
    return report
