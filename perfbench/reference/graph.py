"""Plain reference of the item graph: the exact eps/k-NN lists of chosen
rows and the rows of the symmetrized padded-ELL Laplacian.

Distances are the rectified cosine d(i, j) = 1 - max(0, cos(x_i, x_j)),
an edge kept iff d <= eps and it is among the k nearest, self excluded,
ties to the smaller id, a missing entry (2.0, -1).  Edge weights are
w = 1 / (1 + (d / sigma)^p).  The ELL row of i holds the union of i's
list and the rows whose lists hold i, each edge with the weight of d(i, j),
filled highest weight first (ties by column) and kept only where the edge
fits within the width in both of its rows.  Imports torch only.
"""

from __future__ import annotations

import torch

INF_DIST = 2.0


def unit_rows(x: torch.Tensor, dtype) -> torch.Tensor:
    x = x.to(dtype)
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=1,
                                                        keepdim=True), 1e-30)


def distance_rows(xu: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """[len(rows), n] rectified cosine distances of the given rows of the
    unit corpus ``xu`` to all its rows, in xu's dtype."""
    d = xu[rows] @ xu.T
    return d.clamp_(min=0.0).neg_().add_(1.0)


def _block(n: int) -> int:
    """Rows a block of ``knn_rows``: about 2**28 distances at a time."""
    return max(64, (1 << 28) // max(n, 1))


def knn_rows(xu: torch.Tensor, rows: torch.Tensor, k: int, eps: float,
             at: torch.Tensor | None = None):
    """(dist [R, k] ascending, idx [R, k] int64) of the given rows: the
    exact eps-filtered k nearest, self excluded, ties to the smaller id,
    missing entries (2.0, -1).  With ``at`` (ids [R, m], each in range),
    also the distance of each row to each of its ids, read off the same
    distances: (dist, idx, dist_at)."""
    n = xu.shape[0]
    k_eff = max(1, min(k, n - 1))
    block = _block(n)
    out_d, out_i, out_at = [], [], []
    for s in range(0, rows.shape[0], block):
        r = rows[s:s + block]
        d = distance_rows(xu, r)
        if at is not None:
            out_at.append(torch.gather(d, 1, at[s:s + block]))
        d[torch.arange(r.shape[0], device=d.device), r] = torch.inf
        d.masked_fill_(d > eps, torch.inf)
        # The k_eff + 1 smallest, then ordered by (distance, id): a tie at
        # the k_eff-th place resolves to the smaller id.
        vals, ids = torch.topk(d, min(k_eff + 1, n), dim=1, largest=False)
        del d
        by_id = torch.argsort(ids, dim=1)
        vals, ids = torch.gather(vals, 1, by_id), torch.gather(ids, 1, by_id)
        by_val = torch.sort(vals, dim=1, stable=True).indices[:, :k_eff]
        vals, ids = torch.gather(vals, 1, by_val), torch.gather(ids, 1, by_val)
        miss = ~torch.isfinite(vals)
        out_d.append(vals.masked_fill(miss, INF_DIST))
        out_i.append(ids.masked_fill(miss, -1))
    d, i = torch.cat(out_d), torch.cat(out_i)
    if k > k_eff:
        pad = k - k_eff
        d = torch.nn.functional.pad(d, (0, pad), value=INF_DIST)
        i = torch.nn.functional.pad(i, (0, pad), value=-1)
    if at is None:
        return d, i
    return d, i, torch.cat(out_at)


def weight(d: torch.Tensor, sigma: float, p: float) -> torch.Tensor:
    return 1.0 / (1.0 + torch.pow(torch.clamp_min(d, 0.0)
                                  / max(sigma, 1e-12), p))


def pair_distances(xu: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """d(a[t], b[t]) for each t, in xu's dtype: the rows of ``a`` against
    the whole corpus in blocks, as ``distance_rows`` (so that a product in
    TF32 rounds these distances as it rounds the lists'), then picked."""
    out = torch.empty(a.shape[0], dtype=xu.dtype, device=xu.device)
    rows, where = torch.unique(a, return_inverse=True)
    block = _block(xu.shape[0])
    for s in range(0, rows.shape[0], block):
        sel = (where >= s) & (where < s + block)
        d = distance_rows(xu, rows[s:s + block])
        out[sel] = d[where[sel] - s, b[sel]]
    return out


def _union_rows(lists: torch.Tensor, nodes: torch.Tensor):
    """For each of ``nodes``: its union neighbours (own list, then the rows
    whose lists hold it), as (node position, column) pairs, int64."""
    n, k = lists.shape
    pos = torch.full((n,), -1, dtype=torch.int64, device=lists.device)
    pos[nodes] = torch.arange(nodes.shape[0], device=lists.device)
    own = lists[nodes].to(torch.int64)
    p_own = torch.arange(nodes.shape[0], device=lists.device)[:, None] \
        .expand_as(own)
    keep = own >= 0
    pairs_p, pairs_c = [p_own[keep]], [own[keep]]
    flat = lists.reshape(-1).to(torch.int64)
    hit = (flat >= 0) & (pos[torch.clamp_min(flat, 0)] >= 0)
    src = torch.nonzero(hit).reshape(-1)
    pairs_p.append(pos[flat[src]])
    pairs_c.append(src // k)
    p, c = torch.cat(pairs_p), torch.cat(pairs_c)
    # A mutual edge appears twice: keep one copy.
    key = torch.unique(p * n + c)
    return key // n, key % n


def ell_rows(lists: torch.Tensor, rows: torch.Tensor, width: int,
             xu: torch.Tensor, sigma: float, p: float):
    """The expected ELL rows of ``rows`` from the directed lists [n, k]:
    a list per row of (column, weight) pairs sorted by column, weights in
    xu's dtype.  ``width`` is the ELL's row width."""
    rp, rc = _union_rows(lists, rows)
    # Rows whose union passes the width need ranks: the sampled rows and
    # every neighbour of theirs.
    nodes = torch.unique(torch.cat([rows.to(torch.int64), rc]))
    size = torch.bincount(_union_rows(lists, nodes)[0],
                          minlength=nodes.shape[0])
    full = nodes[size > width]
    rank_of = {}
    if full.numel():
        fp, fc = _union_rows(lists, full)
        w = weight(pair_distances(xu, full[fp], fc), sigma, p)
        for t in range(full.shape[0]):
            sel = fp == t
            cols, ws = fc[sel], w[sel]
            by_col = torch.argsort(cols)
            cols, ws = cols[by_col], ws[by_col]
            order = torch.sort(-ws, stable=True).indices
            rank_of[int(full[t])] = {int(c): i for i, c in
                                     enumerate(cols[order].tolist())}
    w_r = weight(pair_distances(xu, rows.to(torch.int64)[rp], rc), sigma, p)
    out = []
    rows_l = rows.tolist()
    for t, r in enumerate(rows_l):
        sel = rp == t
        cols, ws = rc[sel], w_r[sel]
        keep = []
        for c in cols.tolist():
            ok = rank_of.get(r, {}).get(c, 0) < width \
                and rank_of.get(c, {}).get(r, 0) < width
            keep.append(ok)
        keep_t = torch.as_tensor(keep, dtype=torch.bool, device=cols.device)
        cols, ws = cols[keep_t], ws[keep_t]
        order = torch.argsort(cols)
        out.append((cols[order], ws[order]))
    return out
