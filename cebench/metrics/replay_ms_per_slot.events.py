"""replay_ms_per_slot.events: the card's time inside the program's CUDA graph
replays a cell-slot (ms), by the timing CUDA events the program records around
each `graph.replay()` on its stream (the counter `graphs.replay_ms`): the
graphs' kernels and the bubbles between them. See cebench/program_spans.py
for the window it reads."""
from cebench import program_spans


def read(ctx):
    return program_spans.counter_per_slot(ctx, "graphs.replay_ms", 1.0)
