"""CLI of the port: `validate`, `selftest`, `diagnose`, `train`, `quality`,
`bench` and `scaling`.

  python -m srsran_ce_tpu_torch.validation.cli selftest --device cuda
  python -m srsran_ce_tpu_torch.validation.cli selftest --deep --device cuda
  python -m srsran_ce_tpu_torch.validation.cli validate --data-dir testvector_outputs --device cpu
  python -m srsran_ce_tpu_torch.validation.cli validate --debug-case 4
  python -m srsran_ce_tpu_torch.validation.cli train --steps 500 --checkpoint den.npz
  python -m srsran_ce_tpu_torch.validation.cli quality --cases 2
  python -m srsran_ce_tpu_torch.validation.cli diagnose --device cuda
  python -m srsran_ce_tpu_torch.validation.cli diagnose --batched --kernels pallas_front
  python -m srsran_ce_tpu_torch.validation.cli bench --device cuda --out bench.json
  python -m srsran_ce_tpu_torch.validation.cli scaling --device cuda --out scaling.json

Counterpart of `srsran_ce_tpu/validation/cli.py`, every subcommand ported
(`selftest --deep` with the sharded sweep, `--sp-n`). The device is explicit
(`--device`, default `cuda`); a device that is not there is an error, never a
quiet move to the CPU. Checkpoints are the port's npz files
(`models/training.save_checkpoint`). `bench` and `scaling` run the port's
measuring programs (`srsran_ce_tpu_torch/bench/`), which write their reports
to `--out`, never to the JAX package's BENCH_DETAILS.json / BENCH_SCALING.json.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

#: the hermetic suite of `selftest`: the JAX CLI's twelve cases
SELFTEST_SPECS = [
    dict(n_prbs=52, n_layers=1, comb=2, scs_hz=15e3),
    dict(n_prbs=24, n_layers=2, comb=2, scs_hz=30e3),
    dict(n_prbs=12, n_layers=1, comb=2, scs_hz=30e3, two_hops=True),
    dict(n_prbs=24, n_layers=1, comb=4, scs_hz=30e3, smoothing="mean"),
    dict(n_prbs=16, n_layers=4, comb=2, scs_hz=30e3),
    dict(n_prbs=24, n_layers=1, comb=2, scs_hz=30e3, cfo_compensate=False, smoothing="none"),
    dict(n_prbs=24, n_layers=1, comb=2, scs_hz=30e3, n_rx_ports=2),
    dict(n_prbs=24, n_layers=2, comb=2, scs_hz=30e3, pilot_source="dmrs"),
    dict(n_prbs=24, n_layers=1, comb=2, scs_hz=30e3, prb_hole=(10, 14)),
    dict(n_prbs=16, n_layers=1, comb=2, scs_hz=30e3, pilot_source="srs", smoothing="wiener"),
    # DM-RS configuration type 2 (adjacent-pair clusters, 4 REs/PRB/CDM group)
    dict(n_prbs=24, n_layers=4, comb=2, scs_hz=30e3, pilot_source="dmrs", dmrs_type=2),
    # 5-PRB SRS: the closed-form M_ZC=30 short sequence (TS 38.211 §5.2.2.2)
    dict(n_prbs=5, n_layers=2, comb=2, scs_hz=30e3, pilot_source="srs"),
]


def _device(name: str):
    """The torch device named on the command line; raises when it is absent."""
    from ..devices import resolve

    return resolve(name, arg="--device ")


def _print_results(report: dict) -> None:
    for r in report["results"]:
        status = "PASS" if r["passed"] else "FAIL"
        print(
            f"case {r['idx']:3d} [{status}] max {r['max_err']:.3e} rms {r['rms_err']:.3e} "
            f"nmse {r['nmse']:.3e} ordering {r['ordering']}"
            + (f" ({r['message']})" if r.get("message") else "")
        )


def cmd_validate(args) -> int:
    from . import conformance

    data_dir = Path(args.data_dir)
    header = data_dir / "port_channel_estimator_test_data.h"
    if not header.exists():
        print(f"error: {header} not found (srsRAN vectors are not shipped; "
              f"run `selftest` for the hermetic synthetic suite)", file=sys.stderr)
        return 2
    dev = _device(args.device)
    if args.debug_case is not None:
        return _debug_case(args, header, data_dir, dev)
    report = conformance.run_suite(
        header, data_dir, nmse_bound_db=args.nmse_bound_db, case_filter=args.case or None,
        device=dev,
    )
    _print_results(report)
    print(f"\n{report['n_pass']}/{report['n_cases']} cases within {args.nmse_bound_db} dB NMSE; "
          f"worst case {report['worst_case']} rms {report['worst_rms']} (device {dev})")
    if args.report:
        Path(args.report).write_text(json.dumps(report, indent=2))
    return 0 if report["n_pass"] == report["n_cases"] else 1


def _debug_case(args, header, data_dir, dev) -> int:
    """Failure forensics for one case (conformance.debug_case)."""
    from ..utils import vectors
    from . import conformance

    cases = {c.idx: c for c in vectors.parse_test_header(header)}
    if args.debug_case not in cases:
        print(f"error: case {args.debug_case} not in header", file=sys.stderr)
        return 2
    rep = conformance.debug_case(cases[args.debug_case], data_dir, device=dev)
    print(f"case {rep['idx']}: {rep['n_layers']} layer(s), {rep['n_rx']} RX port(s), "
          f"{rep['n_re']} DMRS REs x {rep['n_dsym']} DMRS symbols, "
          f"{rep['n_ref_coords']} reference coordinates (device {dev})")
    for h, d in enumerate(rep["dmrs_coords"]):
        print(f"  hop {h}: dmrs symbols {d['dmrs_symbols']} "
              f"band start sc {d['sc_band_start']} ({d['n_dmrs_sc']} DMRS subcarriers)")
    for c in rep["candidates"][: args.debug_top]:
        dm = "-" if c["dmrs_rms"] is None else f"{c['dmrs_rms']:.3e}"
        print(f"  [{c['ordering']:>20s}] rms {c['rms']:.3e} nmse {c['nmse']:.3e} "
              f"dmrs-rms {dm} | best gain {c['gain_abs']:.4f} @ "
              f"{c['gain_deg']:+.1f} deg -> nmse {c['nmse_after_gain']:.3e}")
    if args.report:
        Path(args.report).write_text(json.dumps(rep, indent=2))
    return 0


def cmd_selftest(args) -> int:
    """Hermetic conformance: synthesize an srsRAN-format suite from the float64
    oracle, then replay it through the full vector pipeline on the device.
    With --deep, run the fuzzers (geometry vs the oracle in float64, the
    coded chain, the header parser, the sharded builders' seams) at depth on
    the device and write the JSON report (DEEPFUZZ_REPORT.json by default)."""
    import tempfile

    from . import conformance, synth_vectors

    dev = _device(args.device)
    if args.deep:
        return _selftest_deep(args, dev)
    with tempfile.TemporaryDirectory() as td:
        header = synth_vectors.generate_suite(td, SELFTEST_SPECS)
        report = conformance.run_suite(header, td, nmse_bound_db=args.nmse_bound_db, device=dev)
    _print_results(report)
    ok = report["n_pass"] == report["n_cases"]
    print(f"selftest: {report['n_pass']}/{report['n_cases']} within {args.nmse_bound_db} dB "
          f"(device {dev})")
    return 0 if ok else 1


def _selftest_deep(args, dev) -> int:
    """`selftest --deep`: the deep-fuzz sweep (validation/deepfuzz.py) on `dev`."""
    import time

    from . import deepfuzz

    t0 = time.time()
    progress = lambda msg: print(f"  [{time.time()-t0:6.1f}s] {msg}", flush=True)
    from .. import devices

    print(f"deep fuzz: geometry n={args.geometry_n}, coded n={args.coded_n}, "
          f"header n={args.header_n}, sp n={args.sp_n} (device {dev}: {devices.name(dev)}, float64 geometry)",
          flush=True)
    report = deepfuzz.run_all(
        n_geometry=args.geometry_n, n_coded=args.coded_n, n_header=args.header_n,
        n_sp=args.sp_n, progress=progress, device=dev,
    )
    for k in ("geometry", "coded", "header", "sp"):
        r = report[k]
        print(f"{k}: {r['n_pass']}/{r['n_cases']} pass ({r['elapsed_s']:.1f}s)")
    print(f"sp: kinds {report['sp']['kinds']}, worst error {report['sp']['worst']:.2e}")
    g = report["geometry"]
    print(f"geometry NMSE: max {g['nmse_max']:.2e}, median {g['nmse_median']:.2e}, "
          f"histogram(log10) {g['nmse_log10_histogram']}")
    out = Path(args.report or "DEEPFUZZ_REPORT.json")
    out.write_text(json.dumps(report, indent=2, default=str))
    print(f"report written to {out}")
    print("deep selftest:", "ALL PASS" if report["all_pass"] else "FAILURES (see report)")
    return 0 if report["all_pass"] else 1


def _diagnose_call(label, fn, args, dev) -> bool:
    """The proof for one builder call: on the card one CUDA graph captured and
    replayed, bit-identical to the eager call, with the device operations of
    one replay; on the CPU the aten ops of one call and what would stop its
    capture. Returns True when it holds."""
    import dataclasses

    import torch

    from .. import graphs
    from ..utils.profiling import op_stats

    print(f"== {label}")
    if dev.type == "cpu":
        fn(*args)  # the plan's tensors are built by the first call
        with graphs.CaptureCheck() as chk:
            fn(*args)
        print(f"op_count: {sum(chk.ops.values())} aten ops in one call (TorchDispatchMode)")
        for op, n in chk.ops.most_common(15):
            print(f"  {op:45s} {n}")
        print(f"capture hazards: {len(chk.hazards)} (host synchronisations, tensors made from host "
              "data)")
        for h in chk.hazards:
            print(f"  {h}")
        print("graph_count: not measured on the CPU: the CUDA graph capture is proven on the card "
              "(--device cuda)")
        return not chk.hazards
    graphs.clear()  # a graph of this key kept from an earlier call would hide the capture
    with graphs.eager():
        want = fn(*args)
        eager_ops = op_stats(lambda: fn(*args), dev)
    before = graphs.captures
    fn(*args)  # the key's first call: eager, the warm-up
    fn(*args)  # its second: the capture and a replay
    n_graphs = graphs.captures - before
    replays = graphs.replays
    got = fn(*args)  # a replay
    if graphs.replays != replays + 1:
        raise RuntimeError(f"{label}: the third call of the key did not replay its graph")
    replay_ops = op_stats(lambda: fn(*args), dev)
    fields = lambda r: [getattr(r, f.name) for f in dataclasses.fields(r)]
    same = all(torch.equal(a, b) for a, b in zip(fields(got), fields(want)))
    print(f"graph_count: {n_graphs} (the whole call captures into a single CUDA graph)")
    print("graph_break_count: 0 (static plan: no data-dependent Python control flow)")
    print(f"op_count: {sum(replay_ops.values())} device operations in one graphed call "
          "(the replay, its input copies and output clones; torch.profiler)")
    for op, n in replay_ops.most_common(15):
        print(f"  {op[:60]:60s} {n}")
    print(f"eager host launches: {sum(eager_ops.values())} device operations, each launched by "
          "the host")
    print(f"replay vs eager: {'bit-identical' if same else 'DIFFERENT'} (torch.equal on every "
          "output)")
    return n_graphs == 1 and same


#: the batched diagnose call's problems: the main path's serve batch
DIAGNOSE_BATCH = 128


def cmd_diagnose(args) -> int:
    """The port's counterpart of the JAX CLI's `diagnose` (one XLA program, no
    host fallbacks): on the card, one builder call captures into one CUDA
    graph whose replay is bit-identical to the eager call; on the CPU, the
    aten ops of one call and no host synchronisation in it."""
    import dataclasses

    import numpy as np
    import torch

    from ..models import estimator
    from ..utils import synthetic

    dev = _device(args.device)
    case = synthetic.make_case(seed=8, n_prbs=int(args.n_prbs), n_layers=int(args.n_layers))
    nL = case.pilots.shape[2]
    as_t = lambda a: torch.as_tensor(a, device=dev)
    fn = estimator.build_ri(case.hop1, case.hop2, case.config, nL, batched=False)
    args1 = (as_t(estimator.split_ri(case.received_rg.astype(np.complex64))),
             as_t(estimator.split_ri(case.pilots.astype(np.complex64))), as_t(np.float32(1.0)))
    ok = _diagnose_call(f"build_ri(batched=False) per problem, {args.n_prbs} PRB x {nL} layers "
                        f"(device {dev})", fn, args1, dev)
    if args.batched:
        cfg = dataclasses.replace(case.config, matmul_precision="high")
        fn = estimator.build_ri(case.hop1, case.hop2, cfg, nL, batched=True, kernels=args.kernels,
                                out_layout="serve")
        b = DIAGNOSE_BATCH
        argsb = tuple(a.expand((b,) + a.shape).contiguous() for a in args1)
        ok = _diagnose_call(f"build_ri(batched=True, kernels={args.kernels!r}, out_layout='serve')"
                            f", B={b} (device {dev})", fn, argsb, dev) and ok
    if ok and dev.type == "cpu":
        print("offload verdict: no host fallbacks in the call on the CPU; the single-graph "
              "proof is the card's (--device cuda)")
    elif ok:
        print("offload verdict: fully offloadable — single fused program, no host fallbacks")
    else:
        print("offload verdict: NOT offloadable as one program (see above)")
    return 0 if ok else 1


def cmd_train(args) -> int:
    """Train the pilot denoiser on streamed synthetic channels on the device
    and checkpoint it (an npz)."""
    from ..models import training

    dev = _device(args.device)
    is_2d = args.model == "2d"
    load = training.load_checkpoint_2d if is_2d else training.load_checkpoint
    train = training.train2d if is_2d else training.train
    state = None
    if args.resume:
        state = load(args.resume, device=dev)
        print(f"resumed from {args.resume} at step {state.step}")
    state, loss = train(n_steps=args.steps, batch=args.batch, n_re=args.n_re, lr=args.lr,
                        state=state, device=dev)
    print(f"final nmse {loss:.4e} after {state.step} total steps (device {dev})")
    if args.checkpoint:
        training.save_checkpoint(args.checkpoint, state)
        print(f"checkpoint saved to {args.checkpoint}")
    return 0


def cmd_quality(args) -> int:
    """Channel-NMSE-vs-ground-truth sweeps across SNR and smoothing strategies
    on the device: the learned smoother against the reference's RC-filter
    chain, then the geometry, Doppler, CFO, tracking, delay-prior, BER and
    coded-link tables. Loads --checkpoint, else the shipped
    `artifacts/denoiser.npz`, else trains the denoiser briefly."""
    from .. import devices
    from ..models import denoiser, training
    from . import quality

    dev = _device(args.device)
    ckpt = args.checkpoint
    if ckpt is None:
        shipped = denoiser.ARTIFACTS / denoiser.SHIPPED["1d"]
        if shipped.exists():
            ckpt = str(shipped)
    if ckpt:
        state = training.load_checkpoint(ckpt, device=dev)
        print(f"loaded denoiser checkpoint {ckpt} (step {state.step})")
    else:
        print(f"training denoiser for {args.steps} steps ...")
        state, loss = training.train(n_steps=args.steps, batch=128, n_re=args.n_re, lr=2e-3,
                                     device=dev)
        print(f"train nmse {loss:.4e}")

    snrs = tuple(float(s) for s in args.snr)
    table = quality.sweep(snrs_db=snrs, smoothings=("filter", "wiener", "learned", "mean", "none"),
                          params=state.params, n_cases=args.cases, n_prbs=args.n_prbs, n_layers=1, device=dev)
    hdr = "smoothing " + "".join(f"  {s:>6.1f}dB" for s in snrs)
    print(hdr + "\n" + "-" * len(hdr))
    for sm, row in table.items():
        tag = {"filter": " (reference chain)", "learned": " (trainable, ours)",
               "wiener": " (MMSE, ours)"}.get(sm, "")
        print(f"{sm:9s} " + "".join(f"  {row[s]:7.2f}" for s in snrs) + tag)
    gain = {s: table["filter"][s] - table["learned"][s] for s in snrs}
    print("learned-vs-filter gain (dB): "
          + ", ".join(f"{s:.0f}dB SNR: {g:+.2f}" for s, g in gain.items()))

    gtable = quality.geometry_sweep(state.params, snr_db=0.0, n_cases=min(4, args.cases), device=dev)
    print("\nGeometry generalization (one conv checkpoint, 0 dB SNR, NMSE dB):")
    print("n_prbs   n_re   learned   filter    gain")
    for p, row in gtable.items():
        print(f"{p:6d} {row['n_re']:6d} {row['learned_db']:9.2f} {row['filter_db']:8.2f} "
              f"{row['gain_db']:+7.2f}" + ("" if row["learned_wins"] else "  (filter wins)"))

    params2d = None
    shipped2d = denoiser.ARTIFACTS / denoiser.SHIPPED["2d"]
    if shipped2d.exists():
        state2d = training.load_checkpoint_2d(shipped2d, device=dev)
        params2d = state2d.params
        print(f"\nloaded 2-D denoiser checkpoint {shipped2d} (step {state2d.step})")
    dops = (0.0, 100.0, 300.0, 600.0)
    tags = {"none": " (reference broadcast)", "linear": " (time interp, ours)",
            "learned2d": " (2-D DL denoiser, ours)"}
    dtables = {}
    for dsnr in (30.0, 5.0):
        dtable = quality.doppler_sweep(dopplers_hz=dops, snr_db=dsnr, n_cases=args.cases,
                                       n_prbs=args.n_prbs, params2d=params2d, device=dev)
        dtables[dsnr] = dtable
        hdr = "time strategy         " + "".join(f"  {d:>5.0f}Hz" for d in dops)
        print(f"\nDoppler tracking (NMSE dB vs truth, {dsnr:.0f} dB SNR):\n"
              + hdr + "\n" + "-" * len(hdr))
        for ti, row in dtable.items():
            print(f"time_interp={ti:9s} " + "".join(f"  {row[d]:7.2f}" for d in dops)
                  + tags.get(ti, ""))
    dtable = {f"{snr:.0f}dB": t for snr, t in dtables.items()}
    ctable = quality.cfo_rmse_sweep(n_cases=max(8, args.cases), n_prbs=args.n_prbs, device=dev)
    csnrs = sorted(next(iter(ctable.values())).keys())
    hdr = "cfo estimator        " + "".join(f"  {s:>5.0f}dB" for s in csnrs)
    print("\nCFO RMS error (Hz, 4 DM-RS symbols):\n" + hdr + "\n" + "-" * len(hdr))
    for mode, row in ctable.items():
        tag = " (reference)" if mode == "first_pair" else " (WLS, ours)"
        print(f"cfo={mode:12s} " + "".join(f"  {row[s]:7.2f}" for s in csnrs) + tag)
    ttable = quality.tracking_sweep(n_slots=8, n_cases=min(6, args.cases), device=dev)
    print("\nMulti-slot tracking (static channel, 0 dB SNR, NMSE dB vs truth):")
    print(f"  single slot (reference): {ttable['single_slot_db']:7.2f}")
    print(f"  tracked, 8 slots (ours): {ttable['tracked_8slots_db']:7.2f}")
    atable = quality.delay_adapt_sweep(n_cases=min(6, args.cases), n_prbs=args.n_prbs, device=dev)
    print("\nAuto-matched MMSE prior (serving wiener_auto_delay, 10 dB SNR, NMSE dB):")
    print("channel class    fixed 250ns    auto-matched")
    for label, row in atable.items():
        print(f"{label:15s} {row['fixed_db']:11.2f} {row['auto_db']:15.2f}")
    bsnrs = (5.0, 10.0, 15.0, 20.0, 30.0)
    btable = quality.ber_sweep(snrs_db=bsnrs, modulation="16qam", n_rx=2, n_layers=2,
                               n_cases=min(4, args.cases), device=dev)
    print("\nLink-level uncoded BER (2x2 MIMO 16QAM, full chain: estimate ->")
    print("joint MMSE -> soft demap -> descramble; vs perfect-CSI MMSE bound):")
    print("      SNR " + "".join(f"  {s:>7.0f}dB" for s in bsnrs))
    print("estimated " + "".join(f"  {btable[s]['ber']:9.2e}" for s in bsnrs))
    print("perfectCSI" + "".join(f"  {btable[s]['ber_perfect_csi']:9.2e}" for s in bsnrs))
    ksnrs = (12.0, 14.0, 16.0, 20.0)
    ktable = quality.coded_ber_sweep(snrs_db=ksnrs, n_cases=min(2, args.cases), device=dev)
    print("\nCoded link (rate-0.63 QC-LDPC n=976, batched min-sum, interleaved")
    print("over the same 2x2 16QAM chain; payload BER / block error rate):")
    print("      SNR " + "".join(f"  {s:>7.0f}dB" for s in ksnrs))
    print("uncoded   " + "".join(f"  {ktable[s]['uncoded_ber']:9.2e}" for s in ksnrs))
    print("coded BER " + "".join(f"  {ktable[s]['coded_ber']:9.2e}" for s in ksnrs))
    print("BLER      " + "".join(f"  {ktable[s]['coded_bler']:9.2e}" for s in ksnrs))
    print(f"(device {dev}: {devices.name(dev)})")
    if args.report:
        Path(args.report).write_text(json.dumps(
            {"snr": table, "geometry": gtable, "doppler": dtable, "cfo": ctable,
             "tracking": ttable, "delay_adapt": atable, "link_ber": btable,
             "coded_link": ktable}, indent=2))
    return 0


def cmd_bench(args) -> int:
    """The throughput benchmark (the JAX CLI's `bench`, which runs bench.py):
    every row of bench.py on the device, the details to --out, the one-line
    JSON headline last; 1 when any row or gate failed."""
    from ..bench import throughput

    return throughput.main(_device(args.device), args.out)


def cmd_scaling(args) -> int:
    """The scaling benchmark (the JAX CLI's `scaling`, which runs
    bench_scaling.py): dp / sp / config[4] worlds of ranks, gloo worlds of CPU
    processes with --device cpu, NCCL worlds of up to the card count with
    --device cuda; the report to --out, the JSON summary last."""
    from ..bench import scaling

    return scaling.main(_device(args.device), args.out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="srsran-ce-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    v = sub.add_parser("validate", help="replay srsRAN conformance vectors")
    v.add_argument("--data-dir", default="testvector_outputs")
    v.add_argument("--nmse-bound-db", type=float, default=-40.0)
    v.add_argument("--case", type=int, action="append", help="restrict to case index (repeatable)")
    v.add_argument("--report", help="write JSON report to this path")
    v.add_argument("--debug-case", type=int, default=None,
                   help="failure forensics for ONE case: DMRS coordinates, per-"
                        "ordering DMRS-level error, best-fit complex-gain alignment")
    v.add_argument("--debug-top", type=int, default=6,
                   help="show this many best candidates in --debug-case output")
    v.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    v.set_defaults(fn=cmd_validate)

    s = sub.add_parser("selftest", help="hermetic synthetic-vector conformance")
    s.add_argument("--nmse-bound-db", type=float, default=-40.0)
    s.add_argument("--deep", action="store_true",
                   help="run the fuzzers at depth (geometry vs the oracle in float64, "
                        "coded chain, header parser, sharded seams) and write a JSON report")
    s.add_argument("--geometry-n", type=int, default=100)
    s.add_argument("--coded-n", type=int, default=30)
    s.add_argument("--header-n", type=int, default=120)
    s.add_argument("--sp-n", type=int, default=30,
                   help="sharded-seam geometries (each group of shard counts 2, 4, 8 runs "
                        "in one spawned world)")
    s.add_argument("--report", default=None,
                   help="deep-report path (default DEEPFUZZ_REPORT.json)")
    s.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    s.set_defaults(fn=cmd_selftest)

    d = sub.add_parser("diagnose", help="graph-capture / offload diagnostic")
    d.add_argument("--n-prbs", default=52)
    d.add_argument("--n-layers", default=2)
    d.add_argument("--batched", action="store_true",
                   help="also the batched serve call (the main path's builder)")
    d.add_argument("--kernels", choices=("xla", "pallas", "pallas_front"), default="pallas_front",
                   help="the batched call's tier")
    d.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    d.set_defaults(fn=cmd_diagnose)

    t = sub.add_parser("train", help="train the pilot denoiser (smoothing='learned'/'learned2d')")
    t.add_argument("--model", choices=("1d", "2d"), default="1d",
                   help="1d = frequency denoiser; 2d = time x frequency (Doppler)")
    t.add_argument("--steps", type=int, default=500)
    t.add_argument("--batch", type=int, default=256)
    t.add_argument("--n-re", type=int, default=128)
    t.add_argument("--lr", type=float, default=1e-3)
    t.add_argument("--checkpoint", help="npz checkpoint to write")
    t.add_argument("--resume", help="npz checkpoint to resume from")
    t.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    t.set_defaults(fn=cmd_train)

    q = sub.add_parser("quality", help="channel NMSE vs ground truth across SNR / smoothing")
    q.add_argument("--steps", type=int, default=300, help="denoiser training steps")
    q.add_argument("--checkpoint", default=None, help="load a denoiser npz instead of training")
    q.add_argument("--n-re", type=int, default=104)
    q.add_argument("--n-prbs", type=int, default=26)
    q.add_argument("--cases", type=int, default=12)
    q.add_argument("--snr", nargs="*", default=[0.0, 5.0, 10.0, 20.0])
    q.add_argument("--report", default=None, help="write JSON table here")
    q.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    q.set_defaults(fn=cmd_quality)

    b = sub.add_parser("bench", help="single-card throughput benchmark (bench.py's rows)")
    b.add_argument("--out", default="chiprun_out/torch_bench_details.json",
                   help="the per-row details (JSON)")
    b.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    b.set_defaults(fn=cmd_bench)

    sc = sub.add_parser("scaling", help="multi-rank scaling-efficiency benchmark")
    sc.add_argument("--out", default="chiprun_out/torch_bench_scaling.json",
                    help="the scaling report (JSON)")
    sc.add_argument("--device", default="cuda",
                    help="cuda (default: NCCL worlds, one card a rank) or cpu (gloo worlds of "
                         "processes)")
    sc.set_defaults(fn=cmd_scaling)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
