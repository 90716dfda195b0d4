"""search.to_host_ms: the mean host duration, in milliseconds, of the
program's ``arrowspace:search.to_host`` ranges (core/space.py::_to_host:
the ids' and scores' ``.cpu().numpy()``).  The first copy waits for the
work the call queued on the device, so a range holds that wait and the
copies.  None where the trace holds no such range."""

SPAN = "arrowspace:search.to_host"


def read(ctx):
    if ctx.trace is None:
        return None
    spans = ctx.trace.annotated(SPAN)
    if not spans:
        return None
    return 1e3 * sum(s.dur for s in spans) / len(spans)
