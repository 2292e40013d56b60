"""A cell's calls timed by the program's own spans, on the card: a `--trace 1`
run of `cebench.run` with a window of the spans between its two. Not part of
a benchmark run.

    python3 -m cebench.spans_window --workload pusch100_closed8 --seed <n> --seconds 10 \
        [--out spans_window.json]

`run.run_cell` runs as in a `--trace 1` run: set-up, the untraced window of
`--seconds`, the profiled window of `run.TRACE_SECONDS`, the kept calls of
every window judged. For the run its profiler hook (`cebench.trace.profile`)
is replaced by `with_program_window`, which first runs
  - the program-traced window of `run.TRACE_SECONDS`: the spans on
    (`spans.enabled()`) and no profiler; the readers of the spans
    (`program_spans.SPAN_METRICS`, `COUNTER_METRICS`) read its deltas of
    `spans.snapshot()`;
and then the profiled window with the spans on, so that its timeline
carries them: the same readers over it, the clock check
(`program_spans.clock_check`) and the device's idle time by the innermost
span covering it (`program_spans.idle_by_span`).
One JSON line: the run's `correct`, `attempted` (the three windows) and
per-layer readings; for the two windows of spans their calls, cell-slots,
rate, mean call, the host's CPU a cell-slot, the readers, the six span
metrics' sum against the mean call a cell-slot and the replays' event time
against the profiled window's kernel time; the clock check; the idle table;
the host's cost of one `span()` call off and on and of one `device_span()`
on. Exit 1 when a judged number is over its limit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import dataclass

from cebench import program_spans, run, spec
from cebench import trace as tr
from cebench.window import clock

METRICS = tuple(program_spans.SPAN_METRICS) + tuple(program_spans.COUNTER_METRICS)


@dataclass
class SpanContext(run.TraceContext):
    """A metric's context with a window of the program's own spans."""

    program: dict = None  # the deltas of spans.snapshot() over program_window
    program_window: object = None


def with_program_window(profile, spans, got: list):
    """A profiler hook for `run.run_cell`: `hook(fn)` runs `fn` (one window)
    with the spans on and no profiler, then `profile(fn)` with the spans on,
    and returns the latter. Appends (name, window, the snapshot's deltas,
    timeline or None, CPU s) of each to `got`."""
    def hook(fn):
        before, cpu = spans.snapshot(), time.process_time()
        with spans.enabled():
            win = fn()
        cpu = time.process_time() - cpu
        got.append(("program", win, spans.delta(spans.snapshot(), before), None, cpu))
        before, cpu = spans.snapshot(), time.process_time()
        with spans.enabled():
            win, timeline = profile(fn)
        cpu = time.process_time() - cpu
        got.append(("profiled", win, spans.delta(spans.snapshot(), before), timeline, cpu))
        return win, timeline
    return hook


def host_us(fn, n: int) -> float:
    """The host's us a call of `fn` over `n` calls."""
    t = time.perf_counter_ns()
    for _ in range(n):
        fn()
    return (time.perf_counter_ns() - t) * 1e-3 / n


def span_costs(spans) -> dict:
    """The host's us of one span (entered and left) off and on, and of one
    device_span on with its pair resolved (two CUDA events recorded, then
    queried and read at the next `poll`, as a replay's are)."""
    def one():
        with spans.span("cost.probe"):
            pass

    def dev():
        with spans.device_span("cost.probe_ms"):
            pass
        spans.poll()

    off = host_us(one, 200_000)
    with spans.enabled():
        on = host_us(one, 100_000)
        dev_on = host_us(dev, 20_000)
        spans.snapshot()
    return {"span_off_us": off, "span_on_us": on, "device_span_on_us": dev_on}


def window_row(win, cpu_s) -> dict:
    calls = win.calls
    return {"calls": len(calls), "slots": win.slots, "wall_s": win.wall,
            "slots_per_s": win.slots / win.wall if win.wall > 0 else None,
            "mean_call_ms": 1e3 * sum(c.end - c.start for c in calls) / max(len(calls), 1),
            "call_ms_per_slot": 1e3 * sum(c.end - c.start for c in calls) / max(win.slots, 1),
            "cpu_ms_per_slot": 1e3 * cpu_s / max(win.slots, 1)}


def kernel_ms_per_slot(timeline, slots: int) -> float:
    """The union of the timeline's kernels inside its window, a cell-slot (ms)."""
    t = timeline
    iv = sorted((max(a, t.t0) * 1e3, min(b, t.t1) * 1e3) for _, a, b in t.kernels()
                if b > t.t0 and a < t.t1)
    return tr._union_us(iv) * 1e-3 / max(slots, 1)


def measure(cell: spec.Cell, seed: int, seconds: float, device: str = "cuda") -> dict:
    """The result object of one run (the module's doc) on `device`."""
    t_start = clock()
    from srsran_ce_tpu_torch.utils import spans

    got, log = [], []
    profile = tr.profile
    tr.profile = with_program_window(profile, spans, got)
    try:
        res = run.run_cell(cell, seed, seconds, True, device=device, t_start=t_start,
                           log=lambda *a, **k: log.append(" ".join(map(str, a))))
    finally:
        tr.profile = profile
    out = {"workload": cell.name, "seed": seed, "correct": res["correct"],
           "attempted": res["attempted"] + got[0][1].slots, "failed": res["failed"],
           "device": res["device"], "per_layer": res["metrics"], "checks": res["checks"],
           "log": log}
    timeline = got[1][3]
    kern = kernel_ms_per_slot(timeline, got[1][1].slots)
    for name, win, program, _, cpu_s in got:
        ctx = SpanContext(cell=cell, window=win, device_name=res["device"]["kind"],
                          program=program, program_window=win)
        vals = {m: spec.load_module("metrics", m).read(ctx) for m in METRICS}
        six = [vals[m] for m in program_spans.SPAN_METRICS]
        row = window_row(win, cpu_s)
        events = vals["replay_ms_per_slot.events"]
        out[name] = dict(
            row, metrics=vals,
            six_sum_ms_per_slot=sum(six) if None not in six else None,
            six_over_calls=sum(six) / row["call_ms_per_slot"] if None not in six else None,
            events_over_profiled_kernels=events / kern if events and kern else None,
            spans_a_call=(sum(s["count"] for s in program["spans"].values())
                          / max(len(win.calls), 1)),
            totals=program)
    idle = program_spans.idle_by_span(timeline)
    out["profiled"].update(
        kernel_ms_per_slot=kern, clock_check=program_spans.clock_check(timeline),
        window_ms=timeline.window_us * 1e-3, busy_ms=timeline.busy_us() * 1e-3,
        idle_ms_per_slot_by_span={k: v * 1e-3 / max(got[1][1].slots, 1)
                                  for k, v in sorted(idle.items(), key=lambda kv: -kv[1])})
    out["costs"] = span_costs(spans) if device == "cuda" else None
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    run.pin_caches(os.getcwd())
    import torch

    if not torch.cuda.is_available():
        print("cebench.spans_window: no CUDA card", file=sys.stderr)
        return 2
    out = measure(cell, args.seed, args.seconds)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if out["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
