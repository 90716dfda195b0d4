"""The device operations that the program launched inside its spans: each
operation matched to the host time of its launch by the trace's
correlation ids (harness/trace.py's ``DeviceOp.launch``), so an operation
counts for the span whose host range held its launch, even when it ran
after the range had ended."""

from __future__ import annotations

import bisect


def launched(ops, spans) -> list:
    """The operations of ``ops`` launched inside some span of ``spans``
    (ordered by start; may nest or overlap)."""
    union = []
    for s in spans:
        if union and s.start <= union[-1][1]:
            union[-1][1] = max(union[-1][1], s.end)
        else:
            union.append([s.start, s.end])
    starts = [a for a, _ in union]
    out = []
    for op in ops:
        i = bisect.bisect_right(starts, op.launch) - 1
        if i >= 0 and op.launch <= union[i][1]:
            out.append(op)
    return out


def launched_s(ops, spans) -> float:
    """Device seconds of the operations ``launched`` inside ``spans``."""
    return sum(op.dur for op in launched(ops, spans))
