"""Open loop: cell-slots come due at a fixed rate, whether or not the program
keeps up (cells that transmit on the air's clock). Each call takes every slot
that is due and not yet served, at most `max_batch` of them; a slot that
waits longer is served by a later call. The generator never waits for the
program except by being inside a call.

Parameters: `rate_slots_per_s` (cell-slots a second), `max_batch` (the most
slots a call carries, and the largest call shape warmed in set-up).

Slot k of the window comes due at t0 + k / rate, for every k with a due time
inside the window; the window ends when the last of them has been served.
Its latency is the time from its due time to the return of the call that
carried it. End to end: `slot_p95_ms` and `slot_p50_ms`, the 95th
percentile and the median of that latency over every slot due in the window
(numpy's linear interpolation between order statistics).
"""
from __future__ import annotations

import math
import time

import numpy as np

from cebench.window import Call, Window, clock

_SPIN_S = 2e-4  # the last part of a wait is spun, not slept: sleep overshoots


def pool_slots(params: dict) -> int:
    return 2 * int(params["max_batch"])


def warm_batches(params: dict) -> list:
    return list(range(1, int(params["max_batch"]) + 1))


def run(serve, params: dict, seconds: float, n_pool: int) -> Window:
    rate = float(params["rate_slots_per_s"])
    max_batch = int(params["max_batch"])
    period = 1.0 / rate
    n_slots = max(1, math.ceil(seconds * rate))
    win = Window(t0=clock())
    k = 0  # the first slot not yet served
    while k < n_slots:
        now = clock()
        due_end = min(n_slots, int((now - win.t0) / period) + 1)  # slots due by now
        if due_end <= k:
            wait = win.t0 + k * period - now
            if wait > _SPIN_S:
                time.sleep(wait - _SPIN_S)
            continue
        take = list(range(k, min(due_end, k + max_batch)))
        start = clock()
        slots = [j % n_pool for j in take]
        serve(slots)
        win.calls.append(Call(start=start, end=clock(), slots=slots,
                              due=[win.t0 + j * period for j in take]))
        k = take[-1] + 1
    return win


def latencies_s(win: Window) -> np.ndarray:
    """Every slot's time from its due time to its call's return (s)."""
    return np.asarray([c.end - d for c in win.calls for d in c.due], np.float64)


def end_to_end(win: Window) -> dict:
    lat = latencies_s(win)
    if lat.size == 0:
        raise RuntimeError("the window held no slot")
    return {"slot_p95_ms": float(np.percentile(lat, 95)) * 1e3,
            "slot_p50_ms": float(np.percentile(lat, 50)) * 1e3}


def lateness_ms(win: Window) -> float:
    """How late the generator made its calls: the largest time from a call's
    first due slot to its start (ms)."""
    return max((c.start - c.due[0] for c in win.calls), default=0.0) * 1e3
