"""k3.roofline_pct: K3's least time over its device time in the window, in
percent.  K3 is the subtile maxima of subtile serving (ops/subtile_scan.py
-> ops/cuda/subtile_max.py -> csrc/subtile_max.cu: ``subtile_max_tc_kernel``
on the tensor cores, ``subtile_max_kernel`` on the SIMT route).  The least
time is the bf16 products of every query with the rows of every subtile
that holds a real row at 989 TFLOP/s, or the padded corpus, lambdas and
queries read and the maxima written at 3.35 TB/s, whichever is longer, for
each batch of the window (harness/roofline.py).  None where the trace holds
no K3 kernel."""

from harness import roofline
from harness.trace import STEP

KERNELS = ("subtile_max",)


def read(ctx):
    if ctx.trace is None:
        return None
    busy = sum(op.dur for op in ctx.trace.named(KERNELS))
    batches = len(ctx.trace.annotated(STEP))
    if busy <= 0 or batches == 0:
        return None
    s = ctx.shapes
    ops, nbytes = roofline.k3_counts(s["q"], s["real_rows"], s["n_pad"],
                                     s["f"], s["subtile"])
    return 100.0 * roofline.least_s(ops, "bf16", nbytes) * batches / busy
