"""Closed loop: each call carries one slot from each of `cells` cells, and the
next call is made when the previous one has returned (a PHY that hands the
program one tick of slots at a time and waits for the answers).

Parameters: `cells` (cell-slots a call). The pool holds two calls' worth of
distinct slots, used in turn, so consecutive calls never carry the same
inputs.

Its rate, `slots_per_s`: the cell-slots completed over the window's wall
time (its start to the return of its last call). Calls are made while the
window is open; the last one runs to its end.
"""
from __future__ import annotations

from cebench.window import Call, Window, clock


def pool_slots(params: dict) -> int:
    return 2 * int(params["cells"])


def warm_batches(params: dict) -> list:
    return [int(params["cells"])]


def run(serve, params: dict, seconds: float, n_pool: int) -> Window:
    cells = int(params["cells"])
    win = Window(t0=clock())
    end = win.t0 + seconds
    i = 0
    while True:
        t = clock()
        if t >= end:
            break
        slots = [(i * cells + k) % n_pool for k in range(cells)]
        serve(slots)
        win.calls.append(Call(start=t, end=clock(), slots=slots))
        i += 1
    return win


def end_to_end(win: Window) -> dict:
    if not win.calls:
        raise RuntimeError("the window held no call")
    return {"slots_per_s": win.slots / win.wall}
