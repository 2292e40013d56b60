"""Find the knee of an open-loop cell: the highest periodic rate whose backlog
stays bounded over a window. Not part of a benchmark run: it is run once, on
the card, to fix the rate that the cell's traffic file states.

    python -m cebench.sweep --workload <open cell> --seed <n> --seconds <s> \
        --rates 200,400,800 [--out sweep.jsonl]

Set-up once (the pool, every call shape warmed), then one window a rate, in
the order given. Each prints one JSON line: the rate, the slots due and
served, calls and the mean slots a call, the latency's median, 95th
percentile and maximum (ms), and the backlog when the last slot came due
(slots due and not yet served). A rate is bounded when that backlog is at
most one call's worth (`max_batch`) and the latency of the window's last
tenth of slots is within twice that of its first tenth plus one call.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from cebench import run, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = spec.load_workload(args.workload)
    run.pin_caches(os.getcwd())
    import torch

    if not torch.cuda.is_available():
        print("cebench.sweep: no CUDA card", file=sys.stderr)
        return 2
    cfg, mix = cell.config, cell.traffic
    chain = spec.load_module("chains", cfg["chain"])
    traffic = spec.load_module("traffic", mix["kind"])
    n_pool = traffic.pool_slots(mix)
    pool = [chain.make_slot(cfg, args.seed, i) for i in range(n_pool)]
    serve = chain.server(cfg, pool, "cuda")
    for b in traffic.warm_batches(mix):
        for _ in range(run.WARM_CALLS):
            serve([j % n_pool for j in range(b)])
    torch.cuda.synchronize()
    out = open(args.out, "a") if args.out else None
    for rate in (float(r) for r in args.rates.split(",")):
        params = dict(mix, rate_slots_per_s=rate)
        win = traffic.run(serve, params, args.seconds, n_pool)
        lat = traffic.latencies_s(win) * 1e3
        tenth = max(1, lat.size // 10)
        t_last_due = win.t0 + (lat.size - 1) / rate
        backlog = sum(len(c.slots) for c in win.calls if c.start > t_last_due)
        head, tail = float(np.median(lat[:tenth])), float(np.median(lat[-tenth:]))
        call_ms = float(np.median([(c.end - c.start) * 1e3 for c in win.calls]))
        row = {
            "rate_slots_per_s": rate, "slots": int(lat.size), "calls": len(win.calls),
            "mean_slots_a_call": lat.size / max(1, len(win.calls)),
            "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
            "max_ms": float(lat.max()), "head_p50_ms": head, "tail_p50_ms": tail,
            "backlog_at_last_due": int(backlog),
            "bounded": bool(backlog <= int(mix["max_batch"]) and tail <= 2 * head + call_ms),
            "device": torch.cuda.get_device_name(0), "power_limit_w": run.power_limit_w(),
        }
        print(json.dumps(row), flush=True)
        if out:
            out.write(json.dumps(row) + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
