"""kernel_ms_per_slot.outside_k3: the card's kernel time a cell-slot in the
traced window that is not K3's (ms). The union of the window's kernel
intervals less the union of K3's (`layered_kernel`), each clipped to the
window, over the window's cell-slots: the receiver, the LLR extraction and
rate recovery, the parity check and the bit packing of a PUSCH cell. Read
only where the rule of `k3_roofline_pct` holds: the chain is
`pusch_decoded`, the program launched K3 once a call and counted no other
LDPC kernel (K3 and K4 share the kernel name)."""
from cebench import trace as tr


def _union_ms(timeline, contains: str = "") -> float:
    t = timeline
    iv = sorted((max(a, t.t0) * 1e3, min(b, t.t1) * 1e3) for _, a, b in t.kernels(contains)
                if b > t.t0 and a < t.t1)
    return tr._union_us(iv) * 1e-3


def read(ctx):
    if ctx.cell.config.get("chain") != "pusch_decoded" or ctx.timeline is None:
        return None
    calls = ctx.window.calls
    counters = ctx.counters or {}
    if (not calls or counters.get("launches.ldpc_stream", 0) != len(calls)
            or counters.get("launches.ldpc", 0) != 0):
        return None
    k3 = _union_ms(ctx.timeline, "layered_kernel")
    if k3 <= 0:
        return None
    return (_union_ms(ctx.timeline) - k3) / max(ctx.window.slots, 1)
