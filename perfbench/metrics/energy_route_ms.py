"""energy_route_ms: the device time, in milliseconds a call, of the
operations launched inside the program's ``arrowspace:search.route`` ranges
(core/space.py's energy searches: the node distances, the selection of
each query's candidate_m nodes, its centroid bitmap and pool count, and the
batch's fall-back to all-ones bitmaps), over the number of ranges.  None
where the trace holds no such range or no device operation launched inside
one."""

from harness.launched import launched_s

SPAN = "arrowspace:search.route"


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    spans = tr.annotated(SPAN)
    busy = launched_s(tr.in_window(tr.device_ops), spans)
    if busy <= 0:
        return None
    return 1e3 * busy / len(spans)
