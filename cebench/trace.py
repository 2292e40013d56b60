"""The device timeline of a traced window, from torch.profiler.

`profile(fn)` runs `fn()` inside a `torch.profiler` session (CPU and CUDA
activities) under the span `cebench.window`, exports the Chrome trace to a
temporary file, reads it back and deletes it. The device's operations
(kernels, copies, fills) and the host's events (aten ops, runtime calls and
the harness's own spans) become a `Timeline` in the profiler's microseconds.

What is read from it:
  busy_us    the union of the device's operation intervals inside the window
  idle_gaps  the stretches of the window with no device operation, each named
             by the host event that covers most of it (the shortest of those
             covering at least half of it)
  top_ops    the device operations that took the most time, summed by name

`device_time(fn)` runs `fn()` under the profiler with the CUDA activity
alone and reduces the device's records, read straight from the profiler
(no Chrome export), to a `DeviceTime`: what the card did over all of a
window, where a `Timeline` of every host event would be too large to read.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

WINDOW_SPAN = "cebench.window"
_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
_HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function"}


@dataclass
class Timeline:
    t0: float  # the window's start (us)
    t1: float  # its end (us)
    device: List[Tuple[str, str, float, float]] = field(default_factory=list)  # cat, name, ts, end
    host: List[Tuple[str, float, float]] = field(default_factory=list)  # name, ts, end

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    def kernels(self, contains: str = "") -> List[Tuple[str, float, float]]:
        """(name, ts, end) of the kernels whose name holds `contains`."""
        return [(n, a, b) for c, n, a, b in self.device if c == "kernel" and contains in n]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's operations, clipped to the window."""
        iv = sorted((max(a, self.t0), min(b, self.t1)) for _, _, a, b in self.device
                    if b > self.t0 and a < self.t1)
        out: List[List[float]] = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_us(self) -> float:
        return float(sum(b - a for a, b in self.busy_intervals()))

    def gaps(self) -> List[Tuple[float, float]]:
        """The idle stretches of the window, longest first."""
        out, t = [], self.t0
        for a, b in self.busy_intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            out.append((t, self.t1))
        return sorted(out, key=lambda g: g[0] - g[1])

    def name_gap(self, a: float, b: float) -> str:
        """The host activity inside the gap [a, b]."""
        best: Optional[Tuple[float, float, str]] = None  # (-covered, duration, name)
        covering: Optional[Tuple[float, str]] = None
        for name, s, e in self.host:
            if name == WINDOW_SPAN or e <= a or s >= b:
                continue
            cov = min(e, b) - max(s, a)
            if cov >= 0.5 * (b - a) and (covering is None or e - s < covering[0]):
                covering = (e - s, name)
            key = (-cov, e - s, name)
            if best is None or key < best:
                best = key
        if covering is not None:
            return covering[1]
        return best[2] if best is not None else "no host event"

    def idle_gaps(self, n: int = 10) -> List[list]:
        return [[self.name_gap(a, b), (b - a) * 1e-6] for a, b in self.gaps()[:n]]

    def top_ops(self, n: int = 10) -> List[list]:
        tot: dict = {}
        for _, name, a, b in self.device:
            a, b = max(a, self.t0), min(b, self.t1)
            if b > a:
                tot[name] = tot.get(name, 0.0) + (b - a)
        return [[k, v * 1e-6] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def read_chrome_trace(path: str) -> Timeline:
    with open(path) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    win = None
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        name, ts = str(e.get("name", "")), float(e["ts"])
        end = ts + float(e["dur"])
        if cat in _DEVICE_CATS:
            device.append((cat, name, ts, end))
        elif cat in _HOST_CATS:
            host.append((name, ts, end))
            if name == WINDOW_SPAN and cat == "user_annotation":
                win = (ts, end)
    if win is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    return Timeline(t0=win[0], t1=win[1], device=device, host=host)


def profile(fn):
    """(fn(), Timeline of its run on the card)."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            out = fn()
            torch.cuda.synchronize()
    tmp = tempfile.mkdtemp(prefix="cebench_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return out, read_chrome_trace(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@dataclass
class DeviceTime:
    """What the card did over a window, from the profiler's device records."""

    kernel_us: float  # the union of the kernels' intervals
    busy_us: float  # the union of every device operation (kernels, copies, fills)
    copy_us: float  # the copies' and fills' durations, summed
    ops: int  # device operations recorded
    kernels: int  # of them kernels
    span_us: float  # from the first operation's start to the last one's end


def _union_us(iv) -> float:
    """The length (us) of the union of sorted (start_ns, end_ns) intervals."""
    total, a0, b0 = 0, None, None
    for a, b in iv:
        if b0 is not None and a <= b0:
            b0 = max(b0, b)
        else:
            if b0 is not None:
                total += b0 - a0
            a0, b0 = a, b
    if b0 is not None:
        total += b0 - a0
    return total * 1e-3


def device_time(fn):
    """(fn(), DeviceTime of the card's operations while it ran). Raises where
    the records do not reach across the window (the profiler dropped some)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    ops, kern, copy_ns = [], [], 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        a, b = e.start_ns(), e.end_ns()
        ops.append((a, b))
        if e.name().startswith(("Memcpy", "Memset")):
            copy_ns += b - a
        else:
            kern.append((a, b))
    if not kern:
        raise RuntimeError("the profiler recorded no kernel on the card in the window")
    ops.sort()
    kern.sort()
    span_us = (max(b for _, b in ops) - ops[0][0]) * 1e-3
    if span_us < 0.95 * wall_us - 0.5e6:
        raise RuntimeError(f"the card's records span {span_us * 1e-6:.3f} s of a "
                           f"{wall_us * 1e-6:.3f} s window: the profiler dropped some")
    return out, DeviceTime(kernel_us=_union_us(kern), busy_us=_union_us(ops),
                           copy_us=copy_ns * 1e-3, ops=len(ops), kernels=len(kern),
                           span_us=span_us)
