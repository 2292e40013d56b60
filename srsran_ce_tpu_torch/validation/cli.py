"""CLI of the port's validation: `validate` and `selftest`.

  python -m srsran_ce_tpu_torch.validation.cli selftest --device cuda
  python -m srsran_ce_tpu_torch.validation.cli validate --data-dir testvector_outputs --device cpu

Counterpart of `srsran_ce_tpu/validation/cli.py`. The device is explicit
(`--device`, default `cuda`); a device that is not there is an error, never a
quiet move to the CPU. `selftest --deep`, `quality`, `bench`, `diagnose`,
`validate --debug-case` and `train` are not ported yet (ROADMAP.md queue 1,
items 8 and 11).
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
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device here (pass --device cpu to run on the CPU)")
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"--device {name}: the port runs on 'cpu' or 'cuda'")
    return dev


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


def cmd_selftest(args) -> int:
    """Hermetic conformance: synthesize an srsRAN-format suite from the float64
    oracle, then replay it through the full vector pipeline on the device."""
    import tempfile

    from . import conformance, synth_vectors

    dev = _device(args.device)
    with tempfile.TemporaryDirectory() as td:
        header = synth_vectors.generate_suite(td, SELFTEST_SPECS)
        report = conformance.run_suite(header, td, nmse_bound_db=args.nmse_bound_db, device=dev)
    _print_results(report)
    ok = report["n_pass"] == report["n_cases"]
    print(f"selftest: {report['n_pass']}/{report['n_cases']} within {args.nmse_bound_db} dB "
          f"(device {dev})")
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="srsran-ce-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    v = sub.add_parser("validate", help="replay srsRAN conformance vectors")
    v.add_argument("--data-dir", default="testvector_outputs")
    v.add_argument("--nmse-bound-db", type=float, default=-40.0)
    v.add_argument("--case", type=int, action="append", help="restrict to case index (repeatable)")
    v.add_argument("--report", help="write JSON report to this path")
    v.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    v.set_defaults(fn=cmd_validate)

    s = sub.add_parser("selftest", help="hermetic synthetic-vector conformance")
    s.add_argument("--nmse-bound-db", type=float, default=-40.0)
    s.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    s.set_defaults(fn=cmd_selftest)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
