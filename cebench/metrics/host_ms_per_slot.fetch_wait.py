"""host_ms_per_slot.fetch_wait: the time of the program's `serving.fetch_wait`
span a cell-slot (ms): the host blocked on the card, waiting for a chunk's
results to reach its pinned buffers. See cebench/program_spans.py for the
window it reads."""
from cebench import program_spans


def read(ctx):
    return program_spans.span_ms_per_slot(ctx, "serving.fetch_wait")
