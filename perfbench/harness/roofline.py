"""The least time the card could take for a kernel: the yardstick of every
``<kernel>.roofline_pct`` metric.

A frozen copy of chip_smoke.py's bound arithmetic (``_bound``, ``_k1_pairs``
and the H100 SXM's published dense peaks at 700 W), kept here so that no
change to the program moves the yardstick.  Operations and bytes are
counted from shapes alone: each input byte read once, each output byte
written once, whatever a kernel reads again.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit:
# float32 outside the tensor cores, bf16 and int8 tensor cores, and HBM3.
PEAK_OPS = {"fp32": 67e12, "bf16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


def least_s(ops: float, kind: str, nbytes: float) -> float:
    """Seconds: the larger of ``ops`` over the peak rate of their type and
    ``nbytes`` over HBM's rate."""
    return max(ops / PEAK_OPS[kind], nbytes / HBM_BYTES_PER_S)


def k1_pairs(rows: int, n: int) -> float:
    """Distinct pairs of ``rows`` corpus rows with all ``n`` rows: d(i, j)
    equals d(j, i), so a pair whose two rows are both scanned needs its
    product once."""
    return rows * n - rows * (rows - 1) / 2


def k1_counts(n: int, f: int, k: int) -> tuple[float, float]:
    """(operations, bytes) of the exact k-NN self-join of an [n, f] float32
    corpus with lists of k (distance, id) pairs: each distinct pair's
    f-long product once, the corpus read once, the lists written once."""
    return 2.0 * k1_pairs(n, n) * f, n * f * 4.0 + n * k * 8.0


def k2_counts(q: int, n: int, f: int, k: int) -> tuple[float, float]:
    """(operations, bytes) of the blended top-k scan of q float32 queries
    over an [n, f] float32 corpus: every query-row product, the corpus,
    its lambdas and the queries read once, the lists written once."""
    return (2.0 * q * n * f,
            n * f * 4.0 + n * 4.0 + q * f * 4.0 + q * 4.0 + q * k * 8.0)


def k3_counts(q: int, real_rows: int, n_pad: int, f: int,
              subtile: int) -> tuple[float, float]:
    """(operations, bytes) of the subtile maxima of q bf16 queries over a
    padded [n_pad, f] bf16 corpus: the products of the rows of subtiles
    that hold a real row, the corpus, its lambdas and the queries read
    once, one float32 maximum a query and subtile written."""
    n_sub = n_pad // subtile
    return (2.0 * q * real_rows * f,
            n_pad * f * 2.0 + n_pad * 4.0 + q * f * 2.0 + q * 4.0
            + q * n_sub * 4.0)
