"""h2d_mb_per_slot: the bytes the program stages to the card a cell-slot (MB,
1e6 B), its counter `serving.h2d_bytes` (grids, pilots and betas as float32).
See cebench/program_spans.py for the window it reads."""
from cebench import program_spans


def read(ctx):
    return program_spans.counter_per_slot(ctx, "serving.h2d_bytes", 1e-6)
