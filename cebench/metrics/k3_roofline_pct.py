"""k3_roofline_pct: K3's (`ldpc_stream_posterior`) least time over its device
time in the traced window. Each call of the PUSCH cell decodes its slots' code
blocks in one K3 launch; a launch's least time is the larger of its byte and
operation bounds (cebench/roofline.py) for the words it decoded. Read only
where the trace holds one K3 launch a call and the program counted no other
LDPC kernel (K3 and K4 share the kernel name `layered_kernel`)."""
from cebench import roofline
from cebench.gen import ldpc_code, slots


def read(ctx):
    cfg = ctx.cell.config
    if cfg.get("chain") != "pusch_decoded":
        return None
    launches = ctx.timeline.kernels("layered_kernel")
    calls = ctx.window.calls
    if (not launches or len(launches) != len(calls)
            or ctx.counters.get("launches.ldpc_stream", 0) != len(calls)
            or ctx.counters.get("launches.ldpc", 0) != 0):
        return None
    code = slots.pusch_code(cfg)
    plan = ldpc_code.make_ldpc_plan(code)
    c_words = slots.pusch_layout(cfg).c_words
    sweeps = int(cfg["decoder"]["n_iters"])
    least = 0.0
    for c in calls:
        words = len(c.slots) * c_words
        t = roofline.least_time_s(roofline.k3_bytes(code.n, words),
                                  roofline.k3_ops(len(plan.edges), code.z, words, sweeps),
                                  ctx.device_name)
        if t is None:
            return None
        least += t
    spent = sum(b - a for _, a, b in launches) * 1e-6
    return None if spent <= 0 else 100.0 * least / spent
