"""k8.roofline_pct: K8's least time over its device time in the window, in
percent.  K8 is the routed energy scan (core/space.py's energy searches ->
ops/cuda/scan_energy.py -> csrc/scan_energy.cu): the operations launched
inside the program's ``arrowspace:search.scan`` ranges whose names are its
scan kernels (``scan_kernel`` over ``EnergyEpi``: csrc/scan_narrow.cuh's,
or past 128 a list, ``knn_wide``'s) or the merges of its corpus splits
(``tile::merge_splits``, ``knn_wide``'s ``merge_kernel``).  The least
time of a batch is the float32 product of each query with each item of its
routed pool at 67 TFLOP/s (2 F routed_items operations: the routed work,
not N, so a walk that skips the items no pool admits still reads at most
100%), or the corpus, its lambdas, energies and route keys, the queries'
rows, terms and bitmaps read and the lists written at 3.35 TB/s, whichever
is longer (harness/roofline.py::least_s), summed over the window's
batches.  None where the trace holds no K8 kernel or the steps carry no
routed_items."""

from harness import roofline
from harness.launched import launched

SPAN = "arrowspace:search.scan"
KERNELS = ("EnergyEpi", "merge_splits", "merge_kernel")


def k8_counts(routed_items: float, q: int, n: int, f: int, k: int,
              bitmap_bytes: int) -> tuple[float, float]:
    """(operations, bytes) of one batch of q queries over an [n, f] float32
    corpus whose routed pools hold routed_items items in all."""
    return (2.0 * f * routed_items,
            n * f * 4.0 + n * 12.0 + q * f * 4.0 + q * 8.0
            + q * bitmap_bytes + q * k * 8.0)


def read(ctx):
    if ctx.trace is None:
        return None
    routed = [r.get("routed_items") for r in ctx.records]
    if not routed or any(v is None for v in routed):
        return None
    tr = ctx.trace
    ops = launched([op for op in tr.in_window(tr.device_ops)
                    if any(p in op.name for p in KERNELS)],
                   tr.annotated(SPAN))
    busy = sum(op.dur for op in ops)
    if busy <= 0:
        return None
    s = ctx.shapes
    least = 0.0
    for v in routed:
        ops, nbytes = k8_counts(v, s["q"], s["n"], s["f"], s["topk"],
                                s["bitmap_bytes"])
        least += roofline.least_s(ops, "fp32", nbytes)
    return 100.0 * least / busy
