"""kernel_ms_per_slot: the time the card had a kernel running, over all of the
timed window, per cell-slot completed in it (ms). The union of the kernels'
intervals in the profiler's device records of the whole window (copies and
fills left out), over every cell-slot the window served: what a cell-slot
costs the card's compute, whatever pace the host sets."""


def read(ctx):
    d = ctx.device_time
    slots = ctx.window.slots
    if d is None or slots <= 0 or d.kernel_us <= 0:
        return None
    return d.kernel_us * 1e-3 / slots
