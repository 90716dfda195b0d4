"""Process-global debug tracing and per-phase build timings.

Same user-facing contract as the reference binding's debug facility
(reference src/helpers.rs:8-21): ``set_debug(bool)`` toggles
``[pyarrowspace] ...`` lines on stderr.  ``span`` labels a region
``arrowspace:<name>`` in a ``torch.profiler`` trace while one records, and
costs a flag read otherwise.  ``phase`` times a named pipeline stage inside
such a span; on a CUDA device it ends with ``torch.cuda.synchronize()`` so
each timing covers the work its stage enqueued (kernel launches return
before the device finishes).  ``profile_trace`` records such a trace.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time

import torch
from torch._C._autograd import _profiler_enabled

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


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context labelling its region ``arrowspace:<name>`` in a
    ``torch.profiler`` trace (a ``record_function`` range) while a profiler
    records, and doing nothing otherwise.  It never synchronises, reads no
    tensor and allocates nothing on the device, so it may sit on the
    serving path; the profiler holds the range beside the operations the
    region launches.  Names separate levels with ``.``
    (``search.to_host``)."""
    if not _profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(f"arrowspace:{name}")


@contextlib.contextmanager
def phase(name: str, device: torch.device | str | None = None):
    """Time a named pipeline phase into the phase-timing table.  Pass the
    device the phase computes on: a CUDA device is synchronised before the
    clock stops."""
    t0 = time.perf_counter()
    dbg_println(f"phase:{name} start")
    try:
        with span(name):
            yield
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        dt = time.perf_counter() - t0
        _PHASE_TIMINGS[name] = dt
        dbg_println(f"phase:{name} done in {dt:.3f}s")


@contextlib.contextmanager
def profile_trace(log_dir: str, cuda: bool = False):
    """Record a ``torch.profiler`` trace of the region (CPU activity, and
    CUDA activity with ``cuda``) and write it into ``log_dir`` as a Chrome
    trace, ``arrowspace-<pid>-<ns>.trace.json``, also when the region
    raises.  Also reachable via ARROWSPACE_PROFILE=<dir> on
    ArrowSpaceBuilder.build."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities, acc_events=True)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"arrowspace-{os.getpid()}-{time.time_ns()}.trace.json"))


def reset_phase_timings() -> None:
    _PHASE_TIMINGS.clear()


def get_phase_timings() -> dict[str, float]:
    """Most recent per-phase wall-clock timings (seconds)."""
    return dict(_PHASE_TIMINGS)
