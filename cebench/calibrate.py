"""The readings a cell's limits are set from: the program's numbers over many
seeds and the control's over a few. Not part of a benchmark run: it is run on
the card when a limit is set, and its readings are kept in PERF.md.

    python -m cebench.calibrate --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 2 [--out calibrate.jsonl]

For each of `--seeds`: one run of the cell as the benchmark makes it (its own
pool, every call shape warmed, a window of `--seconds` at the cell's load),
its judged numbers and `correct`. For each of `--control-seeds`: the control,
the reference in the program's place at the precision below the
configuration's (float32 with TF32 off -> TF32: the float64 estimator on
TF32-rounded inputs), judged in the same way over every slot of a pool made
from that seed. One JSON line each, then the largest program reading and the
smallest control reading of every number.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from cebench import run, spec


def control_numbers(cell: spec.Cell, seed: int) -> dict:
    """The control's judged numbers over every slot of the seed's pool."""
    chain = spec.load_module("chains", cell.config["chain"])
    traffic = spec.load_module("traffic", cell.traffic["kind"])
    pool = [chain.make_slot(cell.config, seed, i) for i in range(traffic.pool_slots(cell.traffic))]
    ids = list(range(len(pool)))
    numbers, failed, judged = run.judge(cell, chain, pool,
                                        [(ids, [chain.reference.control(s) for s in pool])])
    return {"numbers": numbers, "failed": failed, "judged": judged}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    run.pin_caches(os.getcwd())
    rows = []
    for s in (int(x) for x in args.seeds.split(",") if x):
        o = run.run_cell(cell, s, args.seconds, False, device=args.device,
                         t_start=run.clock())
        rows.append({"side": "program", "seed": s, "correct": o["correct"],
                     "failed": o["failed"], "attempted": o["attempted"],
                     "numbers": {k: v["value"] for k, v in o["checks"].items()},
                     "metrics": {k: v["value"] for k, v in o["metrics"].items()}})
        print(json.dumps(rows[-1]), flush=True)
    for s in (int(x) for x in args.control_seeds.split(",") if x):
        rows.append(dict(side="control", seed=s, **control_numbers(cell, s)))
        print(json.dumps(rows[-1]), flush=True)
    summary = {}
    for side, pick in (("program", max), ("control", min)):
        vals = [r["numbers"] for r in rows if r["side"] == side]
        if vals:
            summary[side] = {k: pick(float(v[k]) for v in vals) for k in vals[0]}
    print(json.dumps({"summary": summary, "limits": cell.config["limits"]}), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in rows + [{"summary": summary, "workload": cell.name}]:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
