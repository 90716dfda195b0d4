"""k2.roofline_pct: K2's least time over its device time in the window, in
percent.  K2 is the exact blended top-k scan (ops/search.py ->
ops/cuda/scan_topk.py -> csrc/scan_topk.cu): its scan kernels (on any
route: the fp32 SIMT ``scan_kernel``, the wide lists' and the tensor-core
block's of the same name) and the merge of its corpus splits
(``tile::merge_splits``).  The least time is every query-row float32
product at 67 TFLOP/s, or the corpus, lambdas and queries read and the
lists written at 3.35 TB/s, whichever is longer, for each batch of the
window (harness/roofline.py).  None where the trace holds no K2 kernel."""

from harness import roofline
from harness.trace import STEP

KERNELS = ("scan_kernel", "merge_splits")


def read(ctx):
    if ctx.trace is None:
        return None
    busy = sum(op.dur for op in ctx.trace.named(KERNELS))
    batches = len(ctx.trace.annotated(STEP))
    if busy <= 0 or batches == 0:
        return None
    s = ctx.shapes
    ops, nbytes = roofline.k2_counts(s["q"], s["n"], s["f"], s["topk"])
    return 100.0 * roofline.least_s(ops, "fp32", nbytes) * batches / busy
