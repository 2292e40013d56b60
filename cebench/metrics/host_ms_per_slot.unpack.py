"""host_ms_per_slot.unpack: the time of the program's `serving.unpack` span a
cell-slot (ms): the fetched results turned into per-problem results (on the
decoded path the payload bits unpacked, the CRC checked and the result
objects made). See cebench/program_spans.py for the window it reads."""
from cebench import program_spans


def read(ctx):
    return program_spans.span_ms_per_slot(ctx, "serving.unpack")
