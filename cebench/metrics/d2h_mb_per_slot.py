"""d2h_mb_per_slot: the bytes the program fetches back from the card a
cell-slot (MB, 1e6 B), its counter `serving.d2h_bytes` (every result tensor
copied to the host). See cebench/program_spans.py for the window it reads."""
from cebench import program_spans


def read(ctx):
    return program_spans.counter_per_slot(ctx, "serving.d2h_bytes", 1e-6)
