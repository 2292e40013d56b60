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

  sp        random geometries across the subcarrier-sharded builders
            (`parallel/subcarrier.py`): estimator draws against the float64
            oracle (learned ones against the unsharded path), receiver and
            tracked draws against their unsharded builders. Each draw's shard
            count is 2, 4 or 8; the draws are grouped by it and each group runs
            in one spawned world of that many ranks (`parallel.launch`: NCCL
            when the machine has a card a rank, gloo otherwise).

The draws are the JAX package's, so a trial number names the same
configuration in both packages.

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


def draw_sp_case(rng: np.random.Generator) -> dict:
    """One random geometry for the sharded-seam sweep (the JAX package's
    draw): the kind (estimator / joint receiver / tracked), the shard count,
    hopped routes, non-divisible shard counts (pad + mask) and the smoothing
    and interpolation modes the sharded builders take."""
    kind = str(rng.choice(["est", "est", "est", "est", "receiver", "tracked"]))
    n_sp = int(rng.choice([2, 4, 8]))
    two_hops = bool(rng.random() < 0.25)
    smoothings = ["filter", "filter", "mean", "none", "wiener"]
    if kind == "est" and not two_hops:
        smoothings.append("learned")
    smoothing = str(rng.choice(smoothings))
    if two_hops:
        n_prbs = int(rng.choice([4, 6, 12, 25]))
    else:
        n_prbs = int(rng.choice([16, 24, 25, 27, 32, 52, 106, 273]))
    n_layers = int(rng.choice([1, 2, 2, 4] if kind != "receiver" else [1, 2]))
    comb = int(rng.choice([2, 2, 4]))
    if not two_hops:
        # the shard plan's contracts: even per-shard pilot counts with >= 2
        # layers, and learned smoothing only on divisible splits whose blocks
        # cover the denoiser's halo: walk n_prbs up until the split is valid
        def _split_ok(p):
            n_re = p * (12 // comb)
            r = -(-n_re // n_sp)
            n_rlast = r - (n_sp * r - n_re)
            if n_layers >= 2 and (r % 2 or n_rlast % 2):
                return False
            if smoothing == "learned" and (n_re % n_sp or n_re // n_sp < 24):
                return False
            return True
        while not _split_ok(n_prbs):
            n_prbs += 1
    kw = dict(
        n_prbs=n_prbs,
        n_layers=n_layers,
        comb=comb,
        scs_hz=float(rng.choice([15e3, 30e3])),
        smoothing=smoothing,
        cfo_compensate=bool(rng.random() < 0.7),
        interp=str(rng.choice(["linear", "linear", "cnn"])),
        cnn_alpha=float(rng.choice([0.0, 0.0, 0.3])),
        two_hops=two_hops,
        snr_db=float(rng.uniform(10.0, 35.0)),
        cfo_hz=float(rng.uniform(-300.0, 300.0)),
        cfo_estimator=str(rng.choice(["first_pair", "first_pair", "wls"])),
    )
    if kind == "est" and rng.random() < 0.25 and smoothing != "learned":
        kw["time_interp"] = "linear"
        kw["doppler_hz"] = 300.0
    draw = dict(kind=kind, n_sp=n_sp, kw=kw)
    if kind == "est":
        draw["batched"] = bool(rng.random() < 0.5)
        draw["factored"] = bool(kw.get("time_interp", "none") == "none" and rng.random() < 0.3)
    if kind == "receiver":
        draw["n_rx"] = int(rng.choice([2, 3]))
        draw["modulation"] = str(rng.choice(["", "", "qpsk", "16qam"])) or None
    return draw


def _max_rel(a, b) -> float:
    """max |a - b| / max |b| (complex or real)."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300))


def check_sp_case(draw_idx: int, seed_base: int = 0xCE_59, device="cpu", mesh=None) -> dict:
    """One fuzzed geometry across the sharded builders, inside a world whose
    mesh has |sp| = the draw's shard count (`mesh`, or a (world / n_sp, n_sp)
    mesh made here; every rank calls this with the same draw), in float64:
    estimator draws against the float64 oracle (NMSE < GEOMETRY_NMSE_BOUND;
    learned draws against the unsharded path, relative 1e-6: the denoiser is
    float32), the factored layout against the grid (relative 1e-9); receiver
    and tracked draws against their unsharded builders (relative 1e-9, int8
    LLRs within one step). The row is rank 0's; a draw that raises is a
    failure, recorded."""
    import torch.distributed as dist

    from ..models import denoiser, receiver, tracking
    from ..models import estimator as est
    from ..parallel import mesh as pmesh
    from ..parallel import subcarrier as sc
    from ..utils import oracle, synthetic

    rng = np.random.default_rng(seed_base + draw_idx)
    draw = draw_sp_case(rng)
    kind, n_sp, kw = draw["kind"], draw["n_sp"], draw["kw"]
    if mesh is None:
        mesh = pmesh.make_mesh((dist.get_world_size() // n_sp, n_sp))
    if pmesh.axis_size(mesh, "sp") != n_sp:
        raise ValueError(f"draw {draw_idx} needs |sp| = {n_sp}, the mesh has "
                         f"{pmesh.axis_size(mesh, 'sp')}")
    dev = torch.device(device)
    dp = pmesh.axis_size(mesh, "dp")
    f64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64, device=dev)
    ri = lambda x: f64(est.split_ri(np.asarray(x, np.complex128)))
    lead = dist.get_rank() == 0
    errs: dict = {}
    ok = True
    try:
        if kind == "est":
            case = synthetic.make_case(seed=int(rng.integers(0, 2**31)), **kw)
            nL = case.pilots.shape[2]
            params = denoiser.load_shipped("1d", dev) if kw["smoothing"] == "learned" else None
            extra = () if params is None else (params,)
            rg, pil, beta = ri(case.received_rg), ri(case.pilots), f64(case.beta)
            if draw["batched"]:
                B = dp * 2
                rg, pil = rg.expand((B,) + rg.shape), pil.expand((B,) + pil.shape)
                beta = beta.expand(B)
                fn = sc.build_sp_batched(case.hop1, case.hop2, case.config, nL, mesh, device=dev)
                beta_l = pmesh.batch_slice(beta, mesh, "dp")
            else:
                fn = sc.build_sp(case.hop1, case.hop2, case.config, nL, mesh, device=dev)
                beta_l = beta
            args = (*fn.shard_inputs(rg, pil), beta_l) + extra
            out = fn.gather_outputs(fn(*args))
            pick = (lambda x: x[0]) if draw["batched"] else (lambda x: x)
            ch = est.merge_ri(pick(out.channel_est_rg).cpu().numpy())
            if lead and params is None:
                res_o = oracle.estimate(case.received_rg, case.pilots, case.beta, case.hop1,
                                        case.hop2, case.config)
                errs["nmse_vs_oracle"] = float(
                    np.sum(np.abs(ch - res_o.channel_est_rg) ** 2)
                    / (np.sum(np.abs(res_o.channel_est_rg) ** 2) + 1e-30))
                noise = float(pick(out.noise_est))
                errs["noise_rel"] = float(abs(noise - res_o.noise_est) / (abs(res_o.noise_est) + 1e-300))
                ok = errs["nmse_vs_oracle"] < GEOMETRY_NMSE_BOUND and errs["noise_rel"] < 1e-7
            elif lead:
                fn_1 = est.build_ri(case.hop1, case.hop2, case.config, nL)
                ch_1 = est.merge_ri(fn_1(ri(case.received_rg), ri(case.pilots), f64(case.beta),
                                         params).channel_est_rg.cpu().numpy())
                errs["rel_vs_unsharded"] = _max_rel(ch, ch_1)
                ok = errs["rel_vs_unsharded"] < 1e-6
            if draw.get("factored"):
                fnf = (sc.build_sp_batched if draw["batched"] else sc.build_sp)(
                    case.hop1, case.hop2, case.config, nL, mesh, out_layout="factored", device=dev)
                rf = fnf.gather_outputs(fnf(*args))
                if lead and ok:
                    grid = est.reconstruct_factored(
                        est.merge_ri(pick(rf.profiles).cpu().numpy()),
                        est.merge_ri(pick(rf.sym_rot).cpu().numpy()), case.hop1, case.hop2)
                    errs["factored_rel"] = _max_rel(grid, ch)
                    ok = errs["factored_rel"] < 1e-9
        elif kind == "receiver":
            kw = {k: v for k, v in kw.items() if k not in ("time_interp", "doppler_hz")}
            n_rx = max(draw["n_rx"], kw["n_layers"])
            case = synthetic.make_mimo_case(
                seed=int(rng.integers(0, 2**31)), n_rx=n_rx, scramble=False,
                modulation=draw["modulation"] or "qpsk", **kw)
            nL = case.pilots.shape[2]
            B = dp
            rg = ri(case.received_rg).expand((B, 2) + case.received_rg.shape)
            pil = ri(case.pilots).expand((B, 2) + case.pilots.shape)
            beta = f64(np.full(B, case.beta))
            fn = sc.build_sp_receiver(case.hop1, case.hop2, case.config, nL, mesh,
                                      modulation=draw["modulation"], device=dev)
            out = fn.gather_outputs(fn(*fn.shard_inputs(rg, pil), pmesh.batch_slice(beta, mesh, "dp")))
            if lead:
                fn_1 = receiver.build_receiver_ri(case.hop1, case.hop2, case.config, nL, n_rx,
                                                  batched=True, modulation=draw["modulation"],
                                                  device=dev)
                out_1 = fn_1(rg, pil, beta)
                if draw["modulation"]:
                    a = torch.cat(list(out.llr)).double().cpu().numpy()
                    b = torch.cat(list(out_1.llr)).double().cpu().numpy()
                    errs["llr_max_abs"] = float(np.abs(a - b).max())
                    ok = errs["llr_max_abs"] <= 1.0
                else:
                    errs["x_rel"] = _max_rel(out.x.cpu().numpy(), out_1.x.cpu().numpy())
                    ok = errs["x_rel"] < 1e-9
                na, nb = out.noise_est.cpu().numpy(), out_1.noise_est.cpu().numpy()
                errs["noise_rel"] = float(np.max(np.abs(na - nb) / (np.abs(nb) + 1e-300)))
                ok = ok and errs["noise_rel"] < 1e-9
        else:  # tracked
            kw = {k: v for k, v in kw.items() if k not in ("time_interp", "doppler_hz")}
            seed = int(rng.integers(0, 2**31))
            cases = [synthetic.make_case(seed=seed, noise_seed=900 + s, **kw) for s in range(2)]
            c0 = cases[0]
            nL = c0.pilots.shape[2]
            f_sp = sc.build_sp_tracked(c0.hop1, c0.hop2, c0.config, nL, mesh, device=dev)
            f_un = tracking.build_tracked_ri(c0.hop1, c0.hop2, c0.config, nL, device=dev)
            st_un = tracking.init_state(c0.hop1, c0.hop2, c0.config, nL, dtype=torch.float64,
                                        device=dev)
            h_sp = f_sp.shard_inputs(ri(c0.received_rg), ri(c0.pilots), st_un[0])[2]
            w_sp = st_un[1]
            worst = 0.0
            for c in cases:
                a = (ri(c.received_rg), ri(c.pilots), f64(c.beta))
                r_sp, h_sp, w_sp = f_sp(*f_sp.shard_inputs(a[0], a[1]), a[2], h_sp, w_sp)
                g_res = f_sp.gather_outputs((r_sp, h_sp, w_sp))[0]
                if lead:
                    r_un, *st_un = f_un(*a, st_un[0], st_un[1])
                    worst = max(worst,
                                _max_rel(g_res.channel_est_rg.cpu().numpy(),
                                         r_un.channel_est_rg.cpu().numpy()),
                                abs(float(w_sp) - float(st_un[1])) / (abs(float(st_un[1])) + 1e-300))
            if lead:
                errs["tracked_rel"] = worst
                ok = worst < 1e-9
    except Exception as e:  # a crash on a valid draw is a failure, recorded
        errs["exception"] = f"{type(e).__name__}: {e}"
        ok = False
    return {
        "draw": draw_idx,
        "kind": kind,
        "n_sp": n_sp,
        "config": {k: (list(v) if isinstance(v, tuple) else v) for k, v in kw.items()},
        "extras": {k: v for k, v in draw.items() if k not in ("kind", "n_sp", "kw")},
        "errs": errs,
        "ok": bool(ok),
    }


def run_sp_fuzz(n: int, seed_base: int = 0xCE_59, progress=None, device="cuda") -> dict:
    """n randomized geometries across the sharded builders: the draws grouped
    by shard count, each group in one spawned world of that many ranks on
    `device` (NCCL when the machine has a card for each rank, gloo
    otherwise)."""
    from ..parallel import launch
    from . import sharded

    t0 = time.time()
    dev = devices.resolve(device)
    groups: dict = {}
    for d in range(n):
        groups.setdefault(draw_sp_case(np.random.default_rng(seed_base + d))["n_sp"], []).append(d)
    rows = []
    for n_sp, draws in sorted(groups.items()):
        nccl = dev.type == "cuda" and torch.cuda.device_count() >= n_sp
        spec = dict(name="fuzz", kind="fuzz", mesh=(1, n_sp), draws=draws, seed_base=seed_base)
        res = launch.spawn_world(sharded.run_cases, n_sp, "nccl" if nccl else "gloo", dev.type,
                                 args=([spec], dev.type))
        rows += res[0]["fuzz"]
        if progress:
            progress(f"sp {len(rows)}/{n} (n_sp={n_sp}, {'nccl' if nccl else 'gloo'})")
    rows.sort(key=lambda r: r["draw"])
    kinds: dict = {}
    for r in rows:
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    return {
        "n_cases": n,
        "n_pass": int(sum(r["ok"] for r in rows)),
        "kinds": kinds,
        "worst": max((max(r["errs"].values()) for r in rows
                      if r["errs"] and all(isinstance(v, float) for v in r["errs"].values())),
                     default=0.0),
        "failures": [r for r in rows if not r["ok"]][:20],
        "elapsed_s": time.time() - t0,
    }


def run_all(
    n_geometry: int = 100,
    n_coded: int = 30,
    n_header: int = 120,
    n_sp: int = 30,
    progress=None,
    device="cuda",
) -> dict:
    """The deep-fuzz sweep on `device` (the card by default; raises when
    there is none); the CLI writes this dict as the JSON report."""
    dev = devices.resolve(device)
    report = {
        "device": str(dev),
        "device_name": devices.name(dev),
        "float64": True,  # the geometry sweep's dtype (the JAX report's x64)
        "geometry": run_geometry_fuzz(n_geometry, progress=progress, device=dev),
        "coded": run_coded_fuzz(n_coded, progress=progress, device=dev),
        "header": run_header_fuzz(n_header),
        "sp": run_sp_fuzz(n_sp, progress=progress, device=dev),
    }
    report["all_pass"] = all(
        report[k]["n_pass"] == report[k]["n_cases"] for k in ("geometry", "coded", "header", "sp")
    )
    return report
