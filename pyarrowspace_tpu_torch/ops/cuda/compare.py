"""Agreement of a kernel's top-k lists with its plain version's.

A kernel and its plain version sum the same products in different orders,
so values differ in the last bits and two candidates whose values differ
by less than that may trade places.  Two lists agree when every position's
values are within ``tol``, every id both hold has values within ``tol``,
and an id only one holds sits within ``tol`` of the other's last value.
"""

from __future__ import annotations

import numpy as np


def topk_disagreements(vals_a, ids_a, vals_b, ids_b, tol: float) -> list[int]:
    """Row numbers whose lists disagree beyond near-ties (empty = agree)."""
    va, ia = np.asarray(vals_a, np.float64), np.asarray(ids_a)
    vb, ib = np.asarray(vals_b, np.float64), np.asarray(ids_b)
    if va.shape != vb.shape or ia.shape != ib.shape or va.shape != ia.shape:
        raise ValueError(f"shapes differ: {va.shape} {ia.shape} "
                         f"{vb.shape} {ib.shape}")
    close = np.abs(va - vb) <= tol
    suspect = ~(close.all(axis=1) & (ia == ib).all(axis=1))
    bad = []
    for r in np.nonzero(suspect)[0]:
        if not close[r].all():
            bad.append(int(r))
            continue
        in_a = dict(zip(ia[r].tolist(), va[r].tolist()))
        in_b = dict(zip(ib[r].tolist(), vb[r].tolist()))
        ok = all(abs(in_b[i] - v) <= tol if i in in_b
                 else abs(v - vb[r, -1]) <= tol for i, v in in_a.items())
        ok = ok and all(abs(v - va[r, -1]) <= tol
                        for i, v in in_b.items() if i not in in_a)
        if not ok:
            bad.append(int(r))
    return bad


def max_abs_err(vals_a, vals_b) -> float:
    """Largest absolute difference between two value arrays."""
    diff = np.abs(np.asarray(vals_a, np.float64)
                  - np.asarray(vals_b, np.float64))
    return float(diff.max()) if diff.size else 0.0
