"""estimator_roofline_pct: the estimation's least time over the card's kernel
time in the traced window (%). Each call of the CE cell estimates its
cell-slots' problems (n_rx a cell-slot) in one replay of the estimator's
graph; a call's least time is the larger of its byte and operation bounds
(cebench/roofline.py) for the work of that many problems
(cebench/roofline_estimator.py). The kernel time is the union of the
window's kernels, all of them the estimator graph's in this cell. Read only
where the chain is `ce_factored`, the program replayed one graph a call, and
no LDPC kernel was launched."""
from cebench import roofline, roofline_estimator, spans_window


def read(ctx):
    cfg = ctx.cell.config
    if cfg.get("chain") != "ce_factored":
        return None
    calls = ctx.window.calls
    counters = ctx.counters or {}
    if (not calls or counters.get("graphs.replays") != len(calls)
            or any(v for k, v in counters.items() if k.startswith("launches.ldpc"))):
        return None
    work = roofline_estimator.problem(cfg)
    least = 0.0
    for c in calls:
        n = len(c.slots) * int(cfg["n_rx"])
        t = roofline.least_time_s(n * work.bytes, n * work.ops, ctx.device_name)
        if t is None:
            return None
        least += t
    spent = spans_window.kernel_ms_per_slot(ctx.timeline, 1) * 1e-3
    return None if spent <= 0 else 100.0 * least / spent
