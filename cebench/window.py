"""What a traffic generator records of its measured window.

A traffic kind (`cebench/traffic/<kind>.py`) drives `serve(slot_ids)`, which
hands the slots to the program in one call and returns when the program has
returned all their results, and records each call here: when it started,
when it returned, which slots of the pool it carried and, in an open loop,
when each slot came due. The end-to-end metrics are taken from these records
alone, over every call and every slot of the window.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

clock = time.perf_counter


@dataclass
class Call:
    start: float  # the host clock when the call was made (s)
    end: float  # when it returned with every result (s)
    slots: List[int]  # the pool's slots it carried, one per cell-slot
    due: Optional[List[float]] = None  # when each slot came due (open loop)


@dataclass
class Window:
    t0: float  # the window's start on the host clock (s)
    calls: List[Call] = field(default_factory=list)

    @property
    def t_close(self) -> float:
        """The return of the window's last call (its start if none ran)."""
        return self.calls[-1].end if self.calls else self.t0

    @property
    def slots(self) -> int:
        return sum(len(c.slots) for c in self.calls)

    @property
    def wall(self) -> float:
        return self.t_close - self.t0
