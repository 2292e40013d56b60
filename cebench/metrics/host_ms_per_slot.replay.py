"""host_ms_per_slot.replay: the self time of the program's `graphs.replay` span a
cell-slot (ms): the host side of each CUDA graph replay (its static input
copies, the replay's launch and the output clones). See
cebench/program_spans.py for the window it reads."""
from cebench import program_spans


def read(ctx):
    return program_spans.span_ms_per_slot(ctx, "graphs.replay")
