"""host_ms_per_slot.h2d: the self time of the program's `serving.h2d` span a
cell-slot (ms): the host issuing each chunk's non-blocking host-to-device
copies (the `aten::to` calls). See cebench/program_spans.py for the window it
reads."""
from cebench import program_spans


def read(ctx):
    return program_spans.span_ms_per_slot(ctx, "serving.h2d")
