"""The measured window: a closed loop of steps timed by the host's clock,
and the end-to-end statistics taken over all of it.

A step is one unit of work that the caller waits for (a build, or a batch
of queries with its results on the host).  The window starts before the
first step and ends with the step that crosses ``seconds``, so every step
in it is whole, and a rate is the work of all its steps over all its time.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field


@dataclass
class Window:
    """The steps of one window: each step's record (a dict with at least
    ``latency_s``), and the window's start and end on the host's clock."""

    records: list = field(default_factory=list)
    start_s: float = 0.0
    end_s: float = 0.0

    @property
    def seconds(self) -> float:
        return self.end_s - self.start_s

    def total(self, key: str) -> float:
        return float(sum(r[key] for r in self.records))

    def latencies(self) -> list:
        return [r["latency_s"] for r in self.records]


def run_window(step, seconds: float, clock=time.perf_counter) -> Window:
    """Call ``step()`` back to back until ``seconds`` have passed since the
    window opened; ``step`` returns the step's record without its latency,
    which is added here from the host's clock around the call."""
    win = Window()
    win.start_s = clock()
    now = win.start_s
    while True:
        t0 = now
        rec = step()
        now = clock()
        rec["latency_s"] = now - t0
        win.records.append(rec)
        if now - win.start_s >= seconds:
            break
    win.end_s = now
    return win


def rate(amount: float, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError("a window lasts longer than 0 s")
    return amount / seconds


def percentile(values, pct: float) -> float:
    """The nearest-rank percentile: the smallest value with at least
    ``pct`` percent of all values at or below it."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    rank = max(1, math.ceil(pct / 100.0 * len(s)))
    return float(s[rank - 1])
