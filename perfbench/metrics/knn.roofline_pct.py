"""knn.roofline_pct: K1's least time over the device time of the kernels
launched inside the build's ``arrowspace:knn`` phase, in percent.

The least time counts each distinct pair's F-long float32 product once
(the self-join's d(i, j) equals d(j, i)) at the H100's 67 TFLOP/s, or the
corpus read and the lists written at 3.35 TB/s, whichever is longer
(harness/roofline.py).  None where the trace holds no such kernel."""

from harness import roofline


def read(ctx):
    if ctx.trace is None:
        return None
    ops = ctx.trace.launched_within("arrowspace:knn")
    busy = sum(op.dur for op in ops)
    phases = len(ctx.trace.annotated("arrowspace:knn"))
    if busy <= 0 or phases == 0:
        return None
    s = ctx.shapes
    ops, nbytes = roofline.k1_counts(s["n"], s["f"], s["k"])
    return 100.0 * roofline.least_s(ops, "fp32", nbytes) * phases / busy
