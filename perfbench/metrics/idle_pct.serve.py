"""idle_pct: the share of the traced window in which no device operation
(kernel, copy or fill) ran, in percent.  None where the trace holds no
device operation."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.in_window(ctx.trace.device_ops):
        return None
    w = ctx.trace.window_s()
    return 100.0 * (w - ctx.trace.busy_s()) / w if w > 0 else None
