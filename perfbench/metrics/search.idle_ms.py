"""search.idle_ms: milliseconds a call in which the device ran nothing
while ``search_batch`` was on the host's stack: the window's idle intervals
(no kernel, copy or fill running: ``Trace.idle_gaps``) clipped exactly to
the program's ``arrowspace:search`` ranges (core/space.py), summed, over
the number of ranges.  The rest of the window's idle time lies between
calls, in the loop.  None where the trace holds no device operation or no
such range."""

SPAN = "arrowspace:search"


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.in_window(tr.device_ops):
        return None
    spans = tr.annotated(SPAN)
    if not spans:
        return None
    return 1e3 * covered_s(tr.idle_gaps(), spans) / len(spans)


def covered_s(gaps, spans) -> float:
    """Seconds of ``gaps`` (ordered, disjoint (start, end) pairs) that lie
    inside some span of ``spans`` (ordered by start; may nest)."""
    total, i = 0.0, 0
    for a, b in _union(spans):
        while i < len(gaps) and gaps[i][1] <= a:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < b:
            total += min(b, gaps[j][1]) - max(a, gaps[j][0])
            j += 1
    return total


def _union(spans) -> list:
    out = []
    for s in spans:
        if out and s.start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s.end)
        else:
            out.append([s.start, s.end])
    return out
