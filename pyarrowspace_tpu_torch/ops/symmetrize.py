"""Symmetrization of the directed k-NN candidate graph into padded ELL
(port of the one-pass op of pyarrowspace_tpu/ops/symmetrize.py).

The union graph E = {(i, j) : j in knn(i) or i in knn(j)} is stored as
fixed-width rows of neighbour indices and weights, -1 / 0 padded.  Rows
are filled highest weight first, ties by ascending column; an edge
survives only if it fits within the width in BOTH of its endpoint rows,
so the stored graph stays exactly symmetric.  A mutual edge keeps both
forward copies: row i holds the weight of d(i, j), row j the weight of
d(j, i).
"""

from __future__ import annotations

import torch


def _rank_sorted(r2: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """For entries sorted by row, the rank of each flagged entry within its
    row counting flagged entries only (garbage at unflagged entries)."""
    m = r2.shape[0]
    idx = torch.arange(m, device=r2.device)
    is_start = torch.ones(m, dtype=torch.bool, device=r2.device)
    is_start[1:] = r2[1:] != r2[:-1]
    row_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    c = torch.cumsum(flags.to(torch.int64), dim=0)      # inclusive prefix
    c_before = torch.where(row_start > 0,
                           c[torch.clamp_min(row_start - 1, 0)], 0)
    return c - c_before - 1


def _lexsort_row_negw_col(rows, negw, cols):
    """Permutation sorting entries by (row, -w, col): stable sorts from the
    least significant key to the most significant."""
    perm = torch.sort(cols, stable=True).indices
    perm = perm[torch.sort(negw[perm], stable=True).indices]
    return perm[torch.sort(rows[perm], stable=True).indices]


def symmetrize_to_ell(idx: torch.Tensor, w: torch.Tensor, ell_width: int):
    """Build the symmetrized union graph in padded-ELL form.

    Args:
      idx: [N, k] int32 neighbour indices from the directed k-NN (-1 = missing).
      w:   [N, k] edge weights.
      ell_width: output row width (typically 2k).

    Returns:
      nbr_idx [N, ell_width] int32 (-1 pad), nbr_w [N, ell_width],
      degrees [N], n_dropped (int: ordered entries dropped by the cap).
    """
    n, k = idx.shape
    m = ell_width
    dev = idx.device
    idx32 = idx.to(torch.int32)
    idx = idx.to(torch.int64)
    node_ids = torch.arange(n, device=dev)
    valid_f = idx >= 0
    safe_idx = torch.where(valid_f, idx, 0)

    # (i, s) with j = idx[i, s] is mutual iff i is in idx[j]; eq[i, s, t]
    # says where, for the partner's fit flag below.
    eq = idx32[safe_idx] == node_ids.to(torch.int32)[:, None, None]
    mutual = eq.any(dim=2) & valid_f
    partner_slot = torch.argmax(eq.to(torch.uint8), dim=2)  # first True

    # All forward copies + the reverse copies of NON-mutual edges (a mutual
    # edge's reverse copy duplicates its partner's forward copy).
    rows_f = node_ids[:, None].expand(n, k).reshape(-1)
    cols_f = idx.reshape(-1)
    w_f = w.reshape(-1)
    rev_valid = (valid_f & ~mutual).reshape(-1)
    valid = torch.cat([valid_f.reshape(-1), rev_valid])
    rows = torch.where(valid, torch.cat([rows_f, cols_f]), n)  # sentinel
    cols = torch.cat([cols_f, rows_f])
    ww = torch.cat([w_f, w_f])

    eid2 = _lexsort_row_negw_col(rows, -ww, cols)
    r2, c2, w2 = rows[eid2], cols[eid2], ww[eid2]
    in_row = r2 < n
    fits_sorted = in_row & (_rank_sorted(r2, in_row) < m)

    # Fit flags back to entry order; an undirected edge survives iff both
    # of its ordered entries fit.
    fits = torch.empty_like(fits_sorted)
    fits[eid2] = fits_sorted
    fits_fwd = fits[: n * k].reshape(n, k)
    fits_rev = fits[n * k:].reshape(n, k)
    partner_fit_mutual = fits_fwd[safe_idx, partner_slot]
    partner_fit = torch.where(mutual, partner_fit_mutual, fits_rev)
    surv_fwd = fits_fwd & partner_fit & valid_f
    surv_rev = fits_rev & fits_fwd & rev_valid.reshape(n, k)
    survives = torch.cat([surv_fwd.reshape(-1), surv_rev.reshape(-1)])
    n_dropped = int((valid & ~survives).sum())

    # Place the survivors by their rank among survivors in sorted order.
    surv_sorted = survives[eid2]
    pos2 = _rank_sorted(r2, surv_sorted)
    flat = (r2 * m + pos2)[surv_sorted]
    nbr_idx = torch.full((n * m,), -1, dtype=torch.int32, device=dev)
    nbr_w = torch.zeros((n * m,), dtype=w.dtype, device=dev)
    nbr_idx[flat] = c2[surv_sorted].to(torch.int32)
    nbr_w[flat] = w2[surv_sorted]
    nbr_idx = nbr_idx.reshape(n, m)
    nbr_w = nbr_w.reshape(n, m)
    return nbr_idx, nbr_w, nbr_w.sum(dim=1), n_dropped


def union_width_bound(idx: torch.Tensor) -> int:
    """Upper bound on the union graph's max row degree:
    |knn_out(i)| + |knn_in(i)| (mutual edges count twice).  Used by the
    build's auto-widen to pre-size the ELL width."""
    n, k = idx.shape
    valid = idx >= 0
    fwd = valid.sum(dim=1)
    in_cnt = torch.bincount(idx[valid].to(torch.int64), minlength=n)
    return int((fwd + in_cnt).max())
