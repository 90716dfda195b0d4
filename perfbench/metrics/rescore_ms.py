"""rescore_ms: the device time, in milliseconds a call, of the operations
launched inside the program's ``arrowspace:search.rescore`` ranges (the
float32 rescore of a candidate pool: subtile serving's phase c in
ops/subtile_scan.py, int8's ops/search.py::rescore_candidates), each
operation matched to its launch by the trace's correlation ids, over the
number of ranges.  None where the trace holds no such range or no device
operation launched inside one."""

import bisect

SPAN = "arrowspace:search.rescore"


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    spans = tr.annotated(SPAN)
    busy = launched_s(tr.in_window(tr.device_ops), spans)
    if busy <= 0:
        return None
    return 1e3 * busy / len(spans)


def launched_s(ops, spans) -> float:
    """Device seconds of the operations of ``ops`` launched inside some
    span of ``spans`` (ordered by start; may nest)."""
    union = []
    for s in spans:
        if union and s.start <= union[-1][1]:
            union[-1][1] = max(union[-1][1], s.end)
        else:
            union.append([s.start, s.end])
    starts = [a for a, _ in union]
    total = 0.0
    for op in ops:
        i = bisect.bisect_right(starts, op.launch) - 1
        if i >= 0 and op.launch <= union[i][1]:
            total += op.dur
    return total
