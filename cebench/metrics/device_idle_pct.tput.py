"""device_idle_pct.tput: the share of the traced window in which no kernel,
copy or fill ran on the card (the union of the device's operation intervals,
over the window's wall), in the closed-loop cells, where the host sets the
pace."""


def read(ctx):
    w = ctx.timeline.window_us
    return None if w <= 0 else 100.0 * (1.0 - ctx.timeline.busy_us() / w)
