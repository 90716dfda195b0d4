"""Process-global debug tracing and per-phase build timings.

Same user-facing contract as the reference binding's debug facility
(reference src/helpers.rs:8-21): ``set_debug(bool)`` toggles
``[pyarrowspace] ...`` lines on stderr.  ``phase`` times a named pipeline
stage; on a CUDA device it ends with ``torch.cuda.synchronize()`` so each
timing covers the work its stage enqueued (kernel launches return before
the device finishes), and it labels the stage in ``torch.profiler`` traces.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time

import torch

_DEBUG = threading.Event()

# Most recent phase timings, keyed by phase name (seconds).  Readable via
# `get_phase_timings()`; reset per top-level build call.
_PHASE_TIMINGS: dict[str, float] = {}


def set_debug(enabled: bool) -> None:
    """Enable/disable `[pyarrowspace] ...` debug lines on stderr
    (parity with reference src/helpers.rs:12-15)."""
    if enabled:
        _DEBUG.set()
    else:
        _DEBUG.clear()


def debug_enabled() -> bool:
    return _DEBUG.is_set()


def dbg_println(msg: str) -> None:
    """Print a debug line when debug is enabled
    (parity with reference src/helpers.rs:17-21)."""
    if _DEBUG.is_set():
        print(f"[pyarrowspace] {msg}", file=sys.stderr, flush=True)


@contextlib.contextmanager
def phase(name: str, device: torch.device | str | None = None):
    """Time a named pipeline phase into the phase-timing table.  Pass the
    device the phase computes on: a CUDA device is synchronised before the
    clock stops."""
    t0 = time.perf_counter()
    dbg_println(f"phase:{name} start")
    try:
        with torch.profiler.record_function(f"arrowspace:{name}"):
            yield
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        dt = time.perf_counter() - t0
        _PHASE_TIMINGS[name] = dt
        dbg_println(f"phase:{name} done in {dt:.3f}s")


def reset_phase_timings() -> None:
    _PHASE_TIMINGS.clear()


def get_phase_timings() -> dict[str, float]:
    """Most recent per-phase wall-clock timings (seconds)."""
    return dict(_PHASE_TIMINGS)
