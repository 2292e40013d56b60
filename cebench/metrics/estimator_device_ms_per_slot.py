"""estimator_device_ms_per_slot: the kernel time on the card in the traced
window (copies and fills left out) over the cell-slots completed in it. In
the estimation cells every kernel belongs to the estimator's graph."""


def read(ctx):
    slots = ctx.window.slots
    if slots <= 0:
        return None
    t = ctx.timeline
    busy = sum(min(b, t.t1) - max(a, t.t0) for _, a, b in t.kernels() if b > t.t0 and a < t.t1)
    return None if busy <= 0 else busy * 1e-3 / slots
