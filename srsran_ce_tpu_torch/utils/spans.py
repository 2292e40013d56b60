"""Spans and counters of the serving host and the graph layer, timed on the
host's clock, and the device time of the graph replays, timed by CUDA events.

A leaf module: it imports torch and nothing of the package, so `graphs.py`
and `serving.py` both use it.

Off by default. Then `span(name)` and `device_span(name)` return one shared
no-op context after a flag check: no clock, no `record_function`, no CUDA
event, nothing recorded; `add` records nothing either. The spans are on
inside `enabled()` alone (`utils/profiling.trace()` enters it for its
block); a profiler started elsewhere does not turn them on. When on:

  span(name)         counts the block under `name`: calls, total ns and self
                     ns (its time less the time of the spans opened inside
                     it, on its thread); `roots` counts the calls opened
                     outside any other span. While a profiler records it is
                     also a `record_function(name)` range, on the profiler's
                     clock beside the device's records.
  add(name, n)       adds `n` to the counter `name`
  device_span(name)  two timing CUDA events around the block, on the current
                     stream; the pair's ms is added to the counter `name`
                     once its end event has completed (`poll`), with no wait
                     of its own
  snapshot()         the totals and the counters, the pending pairs waited for
  delta(after, before)  what one snapshot gained over an earlier one
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
from collections import deque

import torch
from torch.autograd import profiler as _profiler

#: CUDA event pairs left unresolved at most; past it the oldest is waited for
MAX_PENDING = 1024

_on = 0  # depth of `enabled()` blocks
_local = threading.local()  # .stack: the open spans of this thread
_totals: dict = {}  # name -> [count, total ns, self ns, roots]
_counters: dict = {}  # name -> a sum
_pending: deque = deque()  # (counter name, start event, end event) not yet resolved
_free: list = []  # timing events to record again
_streams: dict = {}  # (stream id, device index, device type) -> its torch.cuda.Stream


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


@contextlib.contextmanager
def enabled():
    """The spans on inside the block (nested blocks keep them on)."""
    global _on
    _on += 1
    try:
        yield
    finally:
        _on -= 1


def on() -> bool:
    """Whether the spans are on: a caller checks it before it computes what
    it would `add`."""
    return _on > 0


class _Span:
    __slots__ = ("name", "t0", "child_ns", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self.child_ns = 0
        self.annotation = None
        if _profiler._is_profiler_enabled:
            self.annotation = _profiler.record_function(self.name)
            self.annotation.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.t0
        if self.annotation is not None:
            self.annotation.__exit__(None, None, None)
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].child_ns += dur
        tot = _totals.get(self.name)
        if tot is None:
            tot = _totals[self.name] = [0, 0, 0, 0]
        tot[0] += 1
        tot[1] += dur
        tot[2] += dur - self.child_ns
        if not stack:
            tot[3] += 1
        return False


def span(name: str):
    """A context that times its block under `name` while the spans are on."""
    if not _on:
        return _NOOP
    return _Span(name)


def traced(name: str):
    """`fn` inside `span(name)`, a decorator."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def add(name: str, n) -> None:
    """Adds `n` to the counter `name` while the spans are on."""
    if _on:
        _counters[name] = _counters.get(name, 0) + n


def _event() -> "torch.cuda.Event":
    return _free.pop() if _free else torch.cuda.Event(enable_timing=True)


def _current_stream() -> "torch.cuda.Stream":
    """`torch.cuda.current_stream()`, kept a stream: that call builds a new
    Stream each time (~7 us on an H100's host, its raw lookup ~0.6)."""
    key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.Stream(stream_id=key[0], device_index=key[1],
                                                   device_type=key[2])
    return stream


class _DeviceSpan:
    __slots__ = ("name", "stream", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.stream = _current_stream()
        self.start = _event()
        self.start.record(self.stream)
        return self

    def __exit__(self, *exc):
        end = _event()
        end.record(self.stream)
        _pending.append((self.name, self.start, end))
        if len(_pending) > MAX_PENDING:
            _pending[0][2].synchronize()
            poll()
        return False


def device_span(name: str):
    """A context that times its block's work on the card's current stream
    under the counter `name` (ms) while the spans are on."""
    if not _on:
        return _NOOP
    return _DeviceSpan(name)


def poll() -> None:
    """Adds the ms of every pending event pair whose end has completed, in
    the order they were recorded; waits for nothing."""
    while _pending and _pending[0][2].query():
        name, start, end = _pending.popleft()
        _counters[name] = _counters.get(name, 0.0) + start.elapsed_time(end)
        _free.extend((start, end))


def snapshot() -> dict:
    """{"spans": {name: {"count", "total_ns", "self_ns", "roots"}},
    "counters": {name: sum}}: the totals since the process started. Pending
    event pairs are waited for first (their end events alone, no device-wide
    synchronisation): call it when a window's work is done."""
    for _, _, end in _pending:
        if not end.query():
            end.synchronize()
    poll()
    return {
        "spans": {n: dict(zip(("count", "total_ns", "self_ns", "roots"), t))
                  for n, t in _totals.items()},
        "counters": dict(_counters),
    }


def delta(after: dict, before: dict) -> dict:
    """What the snapshot `after` gained over the earlier `before`."""
    out = {"spans": {}, "counters": {}}
    for n, t in after["spans"].items():
        b = before["spans"].get(n, {})
        out["spans"][n] = {k: v - b.get(k, 0) for k, v in t.items()}
    for n, v in after["counters"].items():
        out["counters"][n] = v - before["counters"].get(n, 0)
    return out
