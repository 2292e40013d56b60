"""k1_roofline_pct: the front's least time over K1's device time in the
traced window (%). Each call of the CE cell runs the front of its cell-slots'
problems (n_rx a cell-slot) in one K1 launch; a call's least time is the
larger of its byte and operation bounds (cebench/roofline.py) for the front's
work of that many problems (cebench/roofline_front.py). K1's time is the
union of the window's `front_kernel` intervals (the dense and the banded
route's kernels alike), clipped to the window. Read only where the chain is
`ce_factored` and the program launched K1 once a call, one graph replay a
call; a program whose front is not K1 reads nothing."""
from cebench import roofline, roofline_front
from cebench import trace as tr


def read(ctx):
    cfg = ctx.cell.config
    if cfg.get("chain") != "ce_factored" or ctx.timeline is None:
        return None
    calls = ctx.window.calls
    counters = ctx.counters or {}
    if (not calls or counters.get("launches.front") != len(calls)
            or counters.get("graphs.replays") != len(calls)):
        return None
    t = ctx.timeline
    iv = sorted((max(a, t.t0) * 1e3, min(b, t.t1) * 1e3) for _, a, b in t.kernels("front_kernel")
                if b > t.t0 and a < t.t1)
    spent = tr._union_us(iv) * 1e-6
    if spent <= 0:
        return None
    work = roofline_front.problem(cfg)
    least = 0.0
    for c in calls:
        n = len(c.slots) * int(cfg["n_rx"])
        lt = roofline.least_time_s(n * work.bytes, n * work.ops, ctx.device_name)
        if lt is None:
            return None
        least += lt
    return 100.0 * least / spent
