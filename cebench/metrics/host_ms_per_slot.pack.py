"""host_ms_per_slot.pack: the self time of the program's `serving.pack` span a
cell-slot (ms): each chunk's problems packed by the native packer into pinned
host buffers, before their copies to the card. See cebench/program_spans.py
for the window it reads."""
from cebench import program_spans


def read(ctx):
    return program_spans.span_ms_per_slot(ctx, "serving.pack")
