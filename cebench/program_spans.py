"""The program's own spans and counters (`srsran_ce_tpu_torch/utils/spans.py`),
read for the per-layer metrics `host_ms_per_slot.*`, `replay_ms_per_slot.events`
and `h2d_mb_per_slot`, and the profiled window's idle time put down to them.

A reading is the spans' totals over one window of calls: `ctx.program`, the
deltas of `spans.snapshot()` over a window run with the spans on, whose
calls are `ctx.program_window` (`cebench/spans_window.py`). None where the
context has none (a `--trace 1` run of `cebench.run`, which turns the spans
on nowhere), the window has no call, or the root `serving.process` spans are
not the window's calls one for one.

The six span metrics are self times, so they partition the root spans: their
sum is the time inside `serving.process`, a cell-slot's share of the calls'
wall time less the harness's own between them.
"""
from __future__ import annotations

import bisect

ROOT = "serving.process"
#: per-layer metric -> the span whose self time it reads
SPAN_METRICS = {
    "host_ms_per_slot.pack": "serving.pack",
    "host_ms_per_slot.h2d": "serving.h2d",
    "host_ms_per_slot.replay": "graphs.replay",
    "host_ms_per_slot.fetch_wait": "serving.fetch_wait",
    "host_ms_per_slot.unpack": "serving.unpack",
    "host_ms_per_slot.process_self": ROOT,
}
#: per-layer metric -> (the counter it reads, the factor to its unit)
COUNTER_METRICS = {
    "replay_ms_per_slot.events": ("graphs.replay_ms", 1.0),
    "h2d_mb_per_slot": ("serving.h2d_bytes", 1e-6),
}
OUTSIDE = f"outside {ROOT}"


def reading(ctx):
    """(the spans' totals over a window, its cell-slots), or None (above)."""
    program = getattr(ctx, "program", None)
    window = getattr(ctx, "program_window", None)
    if program is None or window is None or not window.calls:
        return None
    if program["spans"].get(ROOT, {}).get("roots") != len(window.calls):
        return None
    return program, window.slots


def span_ms_per_slot(ctx, name: str):
    """The self time of the span `name` a cell-slot (ms), None where unread."""
    r = reading(ctx)
    if r is None:
        return None
    program, slots = r
    s = program["spans"].get(name)
    if not s or s["count"] <= 0:
        return None
    return s["self_ns"] * 1e-6 / slots


def counter_per_slot(ctx, name: str, factor: float):
    """The counter `name` a cell-slot times `factor`, None where unread."""
    r = reading(ctx)
    if r is None:
        return None
    program, slots = r
    v = program["counters"].get(name)
    return None if not v else v * factor / slots


def _spans_of(timeline):
    """The program's spans in the timeline, (name, start, end) by start."""
    names = set(SPAN_METRICS.values())
    return sorted(((n, a, b) for n, a, b in timeline.host if n in names), key=lambda s: s[1])


def idle_by_span(timeline) -> dict:
    """{the innermost program span covering it, or OUTSIDE: the idle time of the
    device inside the window (us)}. The spans of one thread nest, so a sweep
    over their ends keeps the innermost open one on top of a stack."""
    points = []
    for n, a, b in _spans_of(timeline):
        points += [(a, 2, n), (b, 0, n)]
    for a, b in timeline.gaps():
        points += [(a, 1, True), (b, 1, False)]
    points.sort(key=lambda p: (p[0], p[1]))
    out: dict = {}
    stack, idle, t = [], False, timeline.t0
    for at, kind, what in points:
        at = min(max(at, timeline.t0), timeline.t1)
        if idle and at > t:
            key = stack[-1] if stack else OUTSIDE
            out[key] = out.get(key, 0.0) + (at - t)
        t = max(t, at)
        if kind == 2:
            stack.append(what)
        elif kind == 0:
            i = len(stack) - 1 - stack[::-1].index(what)
            del stack[i]
        else:
            idle = what
    return out


def _first(starts, a: float, b: float):
    """The first of the sorted `starts` in [a, b), or None."""
    i = bisect.bisect_left(starts, a)
    return starts[i] if i < len(starts) and starts[i] < b else None


def clock_check(timeline) -> dict:
    """The spans against the device's records, on the profiler's clock: the
    share of the device's busy time inside `serving.process` spans, and the
    calls whose first kernel starts before their first `graphs.replay` span.
    The same test against the profiler's own host records, which the program
    does not make: calls whose first kernel starts before their first
    `cudaGraphLaunch`, or whose first device operation (the H2D copy) before
    their first `serving.h2d` span; where those count calls too, the device's
    records and the host's disagree by the profiler's clock alignment."""
    spans = _spans_of(timeline)
    roots = []
    for n, a, b in spans:  # the outermost process spans, in order, disjoint
        if n == ROOT and not (roots and a < roots[-1][1]):
            roots.append((a, b))
    busy = timeline.busy_intervals()
    total = sum(b - a for a, b in busy)
    inside, k = 0.0, 0
    for a, b in busy:
        while k < len(roots) and roots[k][1] <= a:
            k += 1
        m = k
        while m < len(roots) and roots[m][0] < b:
            inside += min(b, roots[m][1]) - max(a, roots[m][0])
            m += 1
    starts = {n: sorted(a for m, a, _ in spans if m == n) for n in ("graphs.replay", "serving.h2d")}
    launches = sorted(a for n, a, _ in timeline.host if n == "cudaGraphLaunch")
    kernels = sorted(a for _, a, _ in timeline.kernels())
    ops = sorted(a for _, _, a, _ in timeline.device)
    out = {"busy_inside_process_pct": 100.0 * inside / total if total > 0 else None,
           "calls": len(roots), "calls_checked": 0, "first_kernel_before_replay": 0,
           "first_kernel_before_graph_launch": 0, "first_op_before_h2d": 0,
           "least_kernel_after_replay_us": None}
    lead = []
    for ra, rb in roots:
        r, kern = _first(starts["graphs.replay"], ra, rb), _first(kernels, ra, rb)
        if r is None or kern is None:
            continue
        out["calls_checked"] += 1
        lead.append(kern - r)
        out["first_kernel_before_replay"] += kern < r
        g = _first(launches, ra, rb)
        out["first_kernel_before_graph_launch"] += g is not None and kern < g
        h, op = _first(starts["serving.h2d"], ra, rb), _first(ops, ra, rb)
        out["first_op_before_h2d"] += h is not None and op is not None and op < h
    if lead:
        out["least_kernel_after_replay_us"] = min(lead)
    return out
