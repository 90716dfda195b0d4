"""Symmetrization of the directed k-NN candidate graph into padded ELL
(port of pyarrowspace_tpu/ops/symmetrize.py: the one-pass op and the
memory-bounded chunked op, bit for bit the same result).

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


def _mutual_chunked(idx: torch.Tensor, safe_idx: torch.Tensor,
                    valid_f: torch.Tensor, n_chunks: int):
    """The one-pass op's mutual-edge detection ([N, k, k] gather-compare)
    in row blocks: peak [R, k, k] with R = ceil(N / n_chunks)."""
    n, k = idx.shape
    r = -(-n // n_chunks)
    idx32 = idx.to(torch.int32)
    mutual = torch.empty((n, k), dtype=torch.bool, device=idx.device)
    slot = torch.empty((n, k), dtype=torch.int64, device=idx.device)
    for r0 in range(0, n, r):
        ids = torch.arange(r0, min(n, r0 + r), dtype=torch.int32,
                           device=idx.device)
        eq = idx32[safe_idx[r0:r0 + r]] == ids[:, None, None]
        mutual[r0:r0 + r] = eq.any(dim=2)
        slot[r0:r0 + r] = torch.argmax(eq.to(torch.uint8), dim=2)
    return mutual & valid_f, slot


def symmetrize_to_ell_chunked(idx: torch.Tensor, w: torch.Tensor,
                              ell_width: int, n_chunks: int = 16,
                              cap_factor: int = 3):
    """Memory-bounded symmetrize: bit for bit ``symmetrize_to_ell``, with
    a lower peak: its sorts and rank temporaries hold one window of
    entries at a time, but the 2Nk bucketed entries and the ELL output stay
    whole (at 1,000,000 rows, k 25, width 268 on an H100 80GB HBM3 at 700
    W: 5.21 against 7.25 GiB, 1.63x the time; chip_smoke.py phase 16).

    One light sort (key: destination row) buckets the 2Nk ordered entries
    by row range; each of the n_chunks ranges then holds all the entries of
    its rows, so a local (row, -w, col) sort of a window of at most
    cap_factor * R * k entries ranks each row as the one-pass op's global
    sort does.  Two passes over the chunks: the fit flags (rank < width),
    then the placement of the edges that fit in both endpoint rows.

    Returns (nbr_idx, nbr_w, degrees, n_dropped, n_overflow).
    n_overflow > 0 means a row range held more entries than its window
    (a hub-heavy chunk); the other results are then invalid and the caller
    retries with a larger cap_factor."""
    n, k = idx.shape
    m = ell_width
    dev = idx.device
    r_rows = -(-n // n_chunks)
    total = 2 * n * k
    cap = min(cap_factor * r_rows * k, total)
    idx = idx.to(torch.int64)
    node_ids = torch.arange(n, device=dev)
    valid_f = idx >= 0
    safe_idx = torch.where(valid_f, idx, 0)
    mutual, partner_slot = _mutual_chunked(idx, safe_idx, valid_f, n_chunks)

    rows_f = node_ids[:, None].expand(n, k).reshape(-1)
    cols_f = idx.reshape(-1)
    w_f = w.reshape(-1)
    rev_valid = (valid_f & ~mutual).reshape(-1)
    entry_row = torch.cat([rows_f, cols_f])
    entry_col = torch.cat([cols_f, rows_f])
    entry_w = torch.cat([w_f, w_f])
    entry_valid = torch.cat([valid_f.reshape(-1), rev_valid])

    # Bucket by destination row (n for an invalid entry).  The row-range
    # boundaries are clamped at n: with n % n_chunks != 0 the last range
    # would otherwise end past n and count the invalid entries as its own.
    dest = torch.where(entry_valid, entry_row, n)
    eid_sorted = torch.sort(dest, stable=True).indices
    edges = torch.clamp_max(
        torch.arange(n_chunks + 1, device=dev) * r_rows, n)
    bounds = torch.searchsorted(dest[eid_sorted], edges).tolist()
    counts = [b - a for a, b in zip(bounds[:-1], bounds[1:])]
    n_overflow = sum(max(c - cap, 0) for c in counts)
    pos = torch.arange(cap, device=dev)

    def chunk_entries(c):
        """Chunk c's window of cap entries (its start clamped to total -
        cap, the shift tracked) and their rows, n outside the chunk."""
        start = min(bounds[c], total - cap)
        off = bounds[c] - start
        e = eid_sorted[start:start + cap]
        ok = (pos >= off) & (pos < off + counts[c]) & entry_valid[e]
        rr = torch.where(ok, entry_row[e], n)
        order = _lexsort_row_negw_col(rr, -entry_w[e], entry_col[e])
        return rr[order], e[order]

    # The window overlaps its neighbours' entries (row n here); their
    # writes go to the sentinel slot past the end, so only each entry's
    # own chunk sets its flag.
    fits = torch.zeros(total + 1, dtype=torch.bool, device=dev)
    for c in range(n_chunks):
        r2, e2 = chunk_entries(c)
        in_row = r2 < n
        fits[torch.where(in_row, e2, total)] = \
            in_row & (_rank_sorted(r2, in_row) < m)

    fits_fwd = fits[: n * k].reshape(n, k)
    fits_rev = fits[n * k: total].reshape(n, k)
    partner_fit_mutual = fits_fwd[safe_idx, partner_slot]
    partner_fit = torch.where(mutual, partner_fit_mutual, fits_rev)
    surv_fwd = fits_fwd & partner_fit & valid_f
    surv_rev = fits_rev & fits_fwd & rev_valid.reshape(n, k)
    survives = torch.cat([surv_fwd.reshape(-1), surv_rev.reshape(-1)])
    n_dropped = int((entry_valid & ~survives).sum())

    nbr_idx = torch.full((n * m + 1,), -1, dtype=torch.int32, device=dev)
    nbr_w = torch.zeros((n * m + 1,), dtype=w.dtype, device=dev)
    for c in range(n_chunks):
        r2, e2 = chunk_entries(c)
        surv = survives[e2] & (r2 < n)
        flat = torch.where(surv, r2 * m + _rank_sorted(r2, surv), n * m)
        nbr_idx[flat] = torch.where(surv, entry_col[e2], -1).to(torch.int32)
        nbr_w[flat] = torch.where(surv, entry_w[e2], 0.0)
    nbr_idx = nbr_idx[: n * m].reshape(n, m)
    nbr_w = nbr_w[: n * m].reshape(n, m)
    return nbr_idx, nbr_w, nbr_w.sum(dim=1), n_dropped, n_overflow


def union_width_bound(idx: torch.Tensor) -> int:
    """Upper bound on the union graph's max row degree:
    |knn_out(i)| + |knn_in(i)| (mutual edges count twice).  Used by the
    build's auto-widen to pre-size the ELL width."""
    n, k = idx.shape
    valid = idx >= 0
    fwd = valid.sum(dim=1)
    in_cnt = torch.bincount(idx[valid].to(torch.int64), minlength=n)
    return int((fwd + in_cnt).max())
