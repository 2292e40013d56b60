"""slots_per_s.host_paced: in a closed-loop cell, the cell-slots completed over
the wall time of the `--trace 1` run's untraced window, which lasts
`--seconds` (each call made when the last returned). The card idles most of
that time, so the host sets the pace; on a shared host the pace swings too
far from run to run for a bound."""


def read(ctx):
    w = ctx.host_window
    if w is None or not w.calls or w.wall <= 0:
        return None
    return w.slots / w.wall
