"""Tracing, operation counts and throughput measurement: the counterpart of
`srsran_ce_tpu/utils/profiling.py`.

  trace()              a torch.profiler context (CPU and CUDA activities) that
                       writes a Chrome / Perfetto trace into a directory
  op_stats()           {operation: count} of one call (the counterpart of
                       `hlo_op_stats`): device operations on the card, aten
                       ops on the CPU
  Chain                a strictly serial chain of calls: on the card a CUDA
                       graph of a few calls replayed back to back, on the CPU
                       an eager loop (the counterpart of `jax.jit(lax.scan)`)
  chained_throughput / chained_slope_stats
                       seconds per call as the slope of chain time over chain
                       length, with the JAX package's escalations
  robust_slope_stats   THE min-of-K aggregation policy (bench/throughput.py
                       takes it from here)
  StructuredReport     JSON-able run reports

The slope cancels what every chain pays once (the first launch, the final
synchronisation), so it is the time a call takes when calls follow each
other on the device with nothing between them.
"""
from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import tempfile
import time
from dataclasses import asdict, dataclass, field
from typing import Callable, List

import numpy as np
import torch

from .. import graphs
from . import spans


def robust_slope_stats(slopes, floor: float = 1e-9):
    """THE min-of-K aggregation policy (bench/throughput.py imports this). A
    clamped/negative fit (<=10 ns) is always discarded. An estimate below 0.7x
    the median survives ONLY if corroborated by a second independent estimate
    within 10%. Pollution only ever ADDS time, so an uncorroborated too-fast
    fit is a broken fit, not a fast device.

    Returns (s_min, spread, n_discarded, good)."""
    sl = [s for s in slopes if s > 1e-8]
    med = float(np.median(sl)) if sl else floor
    good = [
        s
        for i, s in enumerate(sl)
        if s >= 0.7 * med
        or any(j != i and abs(o - s) <= 0.10 * s for j, o in enumerate(sl))
    ] or sl or [floor]
    s_min = min(good)
    spread = (max(good) - s_min) / max(s_min, 1e-12)
    return s_min, spread, len(slopes) - len(good), good


@contextlib.contextmanager
def trace(log_dir: str = None):
    """Profile the block with torch.profiler (CPU activities, and CUDA ones
    when a card is present) and write its Chrome / Perfetto trace
    (`*.pt.trace.json`, TensorBoard's layout) into `log_dir` (default
    `srsce_trace` in the temporary directory); yields `log_dir`. The
    program's spans (`utils/spans.py`) are on inside the block, so the trace
    carries them beside the device's records."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "srsce_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(log_dir)), \
            spans.enabled():
        yield log_dir


#: idle host time at each end of an `op_stats` session, s
OP_STATS_MARGIN_S = 0.05


def op_stats(call: Callable, device="cuda", sessions: int = 3) -> "collections.Counter":
    """{operation: count} of one `call()`: the counterpart of the JAX
    package's `hlo_op_stats` (StableHLO ops of a lowered program).

    On the card (`device` a CUDA device): the device operations of the call
    (kernels, copies and fills) by torch.profiler. A session now and then
    misses records, late in a long process more of them (a call of three
    kernels alone in its session once lost all three, three sessions in a
    row), so the call runs `OP_STATS_MARGIN_S` inside each end of its
    session, `sessions` sessions are taken, and each operation's count is
    the most that any of them saw; none recording anything raises. On the
    CPU: the aten ops the call dispatches."""
    if torch.device(device).type != "cuda":
        with graphs.CaptureCheck() as chk:
            call()
        return chk.ops
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ops = collections.Counter()
    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(OP_STATS_MARGIN_S)
            call()
            torch.cuda.synchronize()
            time.sleep(OP_STATS_MARGIN_S)
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
                ops[e.key] = max(ops[e.key], e.count)
    if not ops:
        raise RuntimeError(f"the profiler recorded no device operation in {sessions} sessions")
    return ops


def _leaves(x) -> list:
    """The tensors of a carry (a tensor or a nested tuple of them), in order."""
    if isinstance(x, tuple):
        return [t for v in x for t in _leaves(v)]
    return [x]


def _world():
    """(world size, the device of its collectives) when this process is a
    rank of a torch.distributed world of more than one rank, else None."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() < 2:
        return None
    dev = (torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl"
           else torch.device("cpu"))
    return dist.get_world_size(), dev


def world_seconds(seconds: float) -> float:
    """The longest of the ranks' `seconds` in a world of more than one rank
    (every rank must call it), else `seconds`: a step of an SPMD program ends
    when the last rank's step ends."""
    w = _world()
    if w is None:
        return seconds
    import torch.distributed as dist

    t = torch.tensor([seconds], dtype=torch.float64, device=w[1])
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def world_barrier() -> None:
    """A barrier over the ranks of a world of more than one rank (every rank
    must call it); nothing otherwise."""
    w = _world()
    if w is not None:
        import torch.distributed as dist

        dist.barrier(device_ids=[w[1].index] if w[1].type == "cuda" else None)


def chain_unit(*reps: int, most: int = 8) -> int:
    """The calls a captured unit holds: the largest divisor of every rep
    count in `reps` that is at most `most`."""
    g = 0
    for r in reps:
        g = math.gcd(g, int(r))
    return max(d for d in range(1, most + 1) if g % d == 0)


class Chain:
    """`body(carry) -> carry` applied `reps` times in strict series, each call
    reading the carry the previous one returned: the counterpart of the JAX
    package's jitted `lax.scan` chain.

    `carry` is a tensor or a tuple of tensors, all on one device. On the card
    the chain is a CUDA graph of `unit` calls of `body`, captured once on the
    first run (after one eager call, inside `graphs.eager()`, builds the
    plans, kernels and library handles) and replayed reps / unit times back
    to back; its last operation copies the carry back into the graph's input
    buffers, so each replay goes on from where the last one stopped. Every
    builder that `body` calls runs its plain forward into this graph (a
    builder's own graph is never captured inside another). A call's outputs
    are dropped once they are fed back, so the capture's memory pool reuses
    them. The kernels' launch counters count each replay's launches, as
    `graphs.Graphed` does. On the CPU the chain is an eager loop.

    Each run starts from `carry`. In a torch.distributed world of more than
    one rank every rank runs the same chains, and `time` waits for every
    rank (a barrier first, the longest rank's time after)."""

    def __init__(self, body: Callable, carry, unit: int = 8):
        self.body = body
        self.carry = carry
        self.unit = int(unit)
        self.device = _leaves(carry)[0].device
        self._graph = None
        self._buf = None
        self._launches = ()

    def _capture(self) -> None:
        dev = self.device
        with graphs.eager():
            self.body(self.carry)
        torch.cuda.synchronize(dev)
        self._buf = tuple(t.clone() for t in _leaves(self.carry))
        mods = graphs.kernel_modules()
        before = tuple(m.launches for m in mods)
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        try:
            with torch.cuda.stream(side):
                graph.capture_begin()
                try:
                    c = self._rebuild(self._buf)
                    for _ in range(self.unit):
                        c = self.body(c)
                    out = _leaves(c)
                    if [(t.shape, t.dtype) for t in out] != [(t.shape, t.dtype) for t in self._buf]:
                        raise ValueError("the chain's body must return a carry shaped as its input")
                    for b, t in zip(self._buf, out):
                        b.copy_(t)
                    del c, out
                finally:
                    graph.capture_end()
        finally:
            self._launches = tuple(m.launches - b for m, b in zip(mods, before))
            for m, b in zip(mods, before):
                m.launches = b
        torch.cuda.current_stream(dev).wait_stream(side)
        self._graph = graph

    def _rebuild(self, leaves):
        """`leaves` in the carry's structure."""
        it = iter(leaves)

        def build(x):
            return tuple(build(v) for v in x) if isinstance(x, tuple) else next(it)

        return build(self.carry)

    def _start(self, reps: int) -> None:
        if reps % self.unit:
            raise ValueError(f"reps={reps} is not a multiple of the chain's unit {self.unit}")
        if self.device.type == "cuda":
            if self._graph is None:
                self._capture()
            for b, t in zip(self._buf, _leaves(self.carry)):
                b.copy_(t)

    def _replay(self, reps: int):
        if self.device.type != "cuda":
            c = self.carry
            for _ in range(reps):
                c = self.body(c)
            return c
        for _ in range(reps // self.unit):
            self._graph.replay()
        for m, n in zip(graphs.kernel_modules(), self._launches):
            m.launches += n * (reps // self.unit)
        return self._rebuild(self._buf)

    def run(self, reps: int):
        """The carry after `reps` calls (on the card: the graph's buffers,
        overwritten by the next run)."""
        self._start(reps)
        return self._replay(reps)

    def time(self, reps: int) -> float:
        """Wall seconds of `reps` calls, ended by a synchronisation (in a
        world: the longest rank's)."""
        self._start(reps)
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        world_barrier()
        t0 = time.perf_counter()
        self._replay(reps)
        if cuda:
            torch.cuda.synchronize(self.device)
        return world_seconds(time.perf_counter() - t0)

    def release(self) -> None:
        """Drop the captured graph and its memory pool."""
        self._graph = self._buf = None


def chained_throughput(
    step_fn: Callable,
    feedback_fn: Callable,
    args: tuple,
    carry_index: int = 0,
    reps_lo: int = 8,
    reps_hi: int = 72,
    trials: int = 3,
) -> float:
    """Seconds per step_fn call, measured as the REPS-scaling slope of a
    strictly serial chain (the next input depends on the previous output via
    feedback_fn).

    step_fn(*args) -> output; feedback_fn(carry, output) -> new carry for
    args[carry_index], which must read the output (that keeps the chain
    serial)."""
    return chained_slope_stats(
        step_fn, feedback_fn, args, carry_index, reps_lo, reps_hi, trials, k=1
    )["s_per_step"]


def chained_slope_stats(
    step_fn: Callable,
    feedback_fn: Callable,
    args: tuple,
    carry_index: int = 0,
    reps_lo: int = 8,
    reps_hi: int = 72,
    trials: int = 3,
    k: int = 3,
) -> dict:
    """`chained_throughput` with K INDEPENDENT slope estimates (fresh passes
    over the same chain, separated in wall-clock time). Pollution only ever
    ADDS time, so the minimum of K estimates is the best available
    device-time estimator; the spread quantifies how (un)stable the
    measurement period was.

    Returns {"s_per_step": min, "slopes": [k floats], "archived_slopes",
    "escalations", "n_discarded", "spread": (max-min)/min}."""

    def body(carry):
        cur = list(args)
        cur[carry_index] = carry
        return feedback_fn(carry, step_fn(*cur))

    chain = Chain(body, args[carry_index], chain_unit(reps_lo, reps_hi))

    def measure(lo, hi):
        times = {}
        for reps in (lo, hi):
            times[reps] = min(chain.time(reps) for _ in range(trials))
        return max((times[hi] - times[lo]) / (hi - lo), 1e-12), times

    build_s = [0.0]

    def build(lo, hi):
        # the capture (first run) and a warm run at each length: the
        # counterpart of compiling and warming the JAX chain executables
        t0 = time.time()
        for reps in (lo, hi):
            chain.run(reps)
        if chain.device.type == "cuda":
            torch.cuda.synchronize(chain.device)
        build_s[0] = time.time() - t0

    def aggregate(slopes):
        s_min, spread, n_disc, _good = robust_slope_stats(slopes, floor=1e-12)
        return s_min, spread, n_disc

    lo, hi = reps_lo, reps_hi
    try:
        build(lo, hi)
        # Chain-length escalation: when the slope contributes <30% of the
        # longest chain's wall time, the fit is mostly launch and
        # synchronisation jitter; lengthen the chain up to 16x.
        s, times = measure(lo, hi)
        for _ in range(2):
            if s > 0.3 * times[hi] / hi:
                break
            hi *= 4
            build(lo, hi)
            s, times = measure(lo, hi)
        slopes = [s]
        for _ in range(max(1, k) - 1):
            s, _ = measure(lo, hi)
            slopes.append(s)
        s_min, spread, n_disc = aggregate(slopes)
        # Post-hoc spread escalation: archive the noisy pool, lengthen the
        # chain, take k fresh estimates (at most twice, and not for chains
        # whose build took over 120 s).
        archived = []
        escalations = 0
        while spread > 0.10 and escalations < 2 and build_s[0] < 120.0:
            hi *= 4
            build(lo, hi)
            archived += slopes
            slopes = []
            for _ in range(max(1, k)):
                s, _ = measure(lo, hi)
                slopes.append(s)
            escalations += 1
            s_min, spread, n_disc = aggregate(slopes)
    finally:
        chain.release()
    return {
        "s_per_step": s_min,
        "slopes": slopes,
        "archived_slopes": archived,
        "escalations": escalations,
        "n_discarded": n_disc,
        "spread": spread,
    }


@dataclass
class StructuredReport:
    """JSON-able run report (the JAX class's fields and JSON)."""

    kind: str  # "bench" | "conformance" | "scaling"
    device: str
    entries: List[dict] = field(default_factory=list)
    meta: dict = field(default_factory=dict)

    def add(self, **kv) -> None:
        self.entries.append(kv)

    def write(self, path) -> None:
        with open(path, "w") as f:
            json.dump(asdict(self), f, indent=2)
