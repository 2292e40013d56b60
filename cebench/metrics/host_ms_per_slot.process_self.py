"""host_ms_per_slot.process_self: the self time of the program's
`serving.process` span a cell-slot (ms): what a call spends outside its
packing, copies, replays, waits and unpacking (bucketing, builder lookups, the
device-to-host copies issued, Python). See cebench/program_spans.py for the
window it reads."""
from cebench import program_spans


def read(ctx):
    return program_spans.span_ms_per_slot(ctx, "serving.process")
