"""The device trace of a traced run: ``torch.profiler`` over the measured
window, written as a Chrome trace and read back into device operations,
host operations and annotations.

Every device operation (kernel, copy, fill) keeps the host time of the
runtime call that launched it (matched by the trace's correlation ids), so
a metric can take the operations launched inside an annotation, such as the
program's ``arrowspace:knn`` phase, even when they run after the
annotation's host range has ended.  Times are seconds on the trace's clock.
"""

from __future__ import annotations

import heapq
import json
from dataclasses import dataclass

WINDOW = "perfbench:window"
STEP = "perfbench:step"

_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset"}
_RUNTIME_CATS = {"cuda_runtime", "cuda_driver", "runtime"}
_ANNOTATION_CATS = {"user_annotation"}
_HOST_CATS = {"cpu_op", "operator"} | _RUNTIME_CATS | _ANNOTATION_CATS
_NAME_CHARS = 160


@dataclass(frozen=True)
class Span:
    name: str
    start: float
    end: float

    @property
    def dur(self) -> float:
        return self.end - self.start


@dataclass(frozen=True)
class DeviceOp(Span):
    launch: float = 0.0


def record(name: str):
    """A named host range that shows in the trace (``torch.profiler``'s
    ``record_function``; a no-op cost when nothing traces)."""
    import torch
    return torch.profiler.record_function(name)


def profile_to(fn, path: str, cuda: bool):
    """Run ``fn()`` under ``torch.profiler`` (host activity, and device
    activity with ``cuda``), write the Chrome trace to ``path`` and return
    (fn's result, the parsed Trace)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, acc_events=True) as prof:
        out = fn()
    prof.export_chrome_trace(path)
    return out, Trace.load(path)


class Trace:
    """Device operations, host operations and annotations of one trace."""

    def __init__(self, events: list):
        launch_at = {}
        dev, host, ann = [], [], []
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            cat = str(ev.get("cat", "")).lower()
            start = float(ev["ts"]) * 1e-6
            span = (str(ev.get("name", "")), start,
                    start + float(ev["dur"]) * 1e-6)
            corr = (ev.get("args") or {}).get("correlation")
            if cat in _DEVICE_CATS:
                dev.append((span, corr))
            elif cat in _HOST_CATS:
                host.append(Span(*span))
                if cat in _ANNOTATION_CATS:
                    ann.append(Span(*span))
                elif cat in _RUNTIME_CATS and corr is not None:
                    launch_at[corr] = span[1]
        self.device_ops = sorted(
            (DeviceOp(*span, launch=launch_at.get(corr, span[1]))
             for span, corr in dev), key=lambda d: d.start)
        self.host_ops = sorted(host, key=lambda s: s.start)
        self.annotations = sorted(ann, key=lambda s: s.start)
        wins = [a for a in self.annotations if a.name == WINDOW]
        if wins:
            self.window = Span(WINDOW, wins[0].start, wins[-1].end)
        elif self.host_ops:
            self.window = Span(WINDOW, self.host_ops[0].start,
                               max(s.end for s in self.host_ops))
        else:
            self.window = Span(WINDOW, 0.0, 0.0)

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as fh:
            data = json.load(fh)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return cls(events)

    # -- selections -------------------------------------------------------
    def in_window(self, ops):
        w = self.window
        return [o for o in ops if o.end > w.start and o.start < w.end]

    def annotated(self, name: str) -> list:
        """The window's annotations called ``name``."""
        return [a for a in self.in_window(self.annotations) if a.name == name]

    def launched_within(self, name: str) -> list:
        """The device operations launched inside an annotation ``name``."""
        spans = self.annotated(name)
        out = []
        for op in self.in_window(self.device_ops):
            for a in spans:
                if a.start <= op.launch <= a.end:
                    out.append(op)
                    break
        return out

    def named(self, patterns) -> list:
        """The window's device operations whose name holds one of
        ``patterns``."""
        return [op for op in self.in_window(self.device_ops)
                if any(p in op.name for p in patterns)]

    # -- busy and idle ------------------------------------------------------
    def _busy_intervals(self) -> list:
        w = self.window
        merged = []
        for op in self.device_ops:
            a, b = max(op.start, w.start), min(op.end, w.end)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        return sum(b - a for a, b in self._busy_intervals())

    def window_s(self) -> float:
        return self.window.dur

    def idle_gaps(self) -> list:
        """The window's intervals with no device operation, in order."""
        gaps, t = [], self.window.start
        for a, b in self._busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.window.end > t:
            gaps.append((t, self.window.end))
        return gaps

    # -- breakdown ----------------------------------------------------------
    def top_device_ops(self, n: int = 10) -> list:
        """[name, seconds] of the device operations that took most time in
        the window, summed by name."""
        tot = {}
        for op in self.in_window(self.device_ops):
            key = op.name[:_NAME_CHARS]
            tot[key] = tot.get(key, 0.0) + op.dur
        return [[k, v] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def top_idle_gaps(self, n: int = 10) -> list:
        """[what the host was doing, seconds] of the idle gaps, summed by
        the innermost annotation and the innermost host operation open at
        each gap's middle, longest first."""
        gaps = self.idle_gaps()
        mids = sorted(((a + b) / 2, b - a) for a, b in gaps)
        inner_ann = _innermost(self.annotations, [m for m, _ in mids])
        inner_op = _innermost(self.host_ops, [m for m, _ in mids])
        tot = {}
        for (m, dur), a, o in zip(mids, inner_ann, inner_op):
            if o is None:
                key = f"{a.name}/(no host op)" if a else "(no host op)"
            elif a is None or a.name == o.name:
                key = o.name
            else:
                key = f"{a.name}/{o.name}"
            key = key[:_NAME_CHARS]
            tot[key] = tot.get(key, 0.0) + dur
        return [[k, v] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def breakdown(self) -> dict:
        return {"device_ops": self.top_device_ops(),
                "idle_gaps": self.top_idle_gaps()}


def _innermost(spans: list, points: list) -> list:
    """For each of the ascending ``points``, the open span of ``spans``
    (sorted by start) that started last, or None."""
    out, heap, i = [], [], 0
    for p in points:
        while i < len(spans) and spans[i].start <= p:
            heapq.heappush(heap, (-spans[i].start, i))
            i += 1
        while heap and spans[heap[0][1]].end < p:
            heapq.heappop(heap)
        out.append(spans[heap[0][1]] if heap else None)
    return out
