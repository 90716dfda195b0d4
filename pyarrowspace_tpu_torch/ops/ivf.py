"""IVF postings and gather-routed search (port of
pyarrowspace_tpu/ops/ivf.py).

Items are bucketed into padded inverted lists by cluster assignment:
buckets of a capacity that is a multiple of the mean cluster size, and
the overflow in a shared tail bucket, so no item is unreachable.
``ivf_lambda_search`` (mode="ivf") scores each query against the members
of its n_probe nearest clusters and the tail; approximate by
construction.  Blocked-IVF serving (ops/ivf_scan.py) uses the clustering
directly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .search import GATHER_BYTES


class IVFIndex(NamedTuple):
    centroids: torch.Tensor     # [K, F]
    buckets: torch.Tensor       # [K, C] int32 item ids, -1 pad
    tail: torch.Tensor          # [T] int32 spill item ids (-1 pad)


def build_ivf(centroids: torch.Tensor, assignments, n_items: int,
              capacity_factor: float = 3.0) -> IVFIndex:
    """Bucket items by cluster assignment (on the host, vectorized)."""
    assign = torch.as_tensor(assignments).cpu().numpy()
    k = centroids.shape[0]
    cap = max(8, int(np.ceil(capacity_factor * n_items / k)))
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    # Rank of each item within its cluster.
    starts = np.searchsorted(sorted_assign, np.arange(k))
    rank = np.arange(n_items) - starts[sorted_assign]
    in_bucket = rank < cap
    buckets = np.full((k, cap), -1, dtype=np.int32)
    buckets[sorted_assign[in_bucket], rank[in_bucket]] = order[
        in_bucket].astype(np.int32)
    tail = order[~in_bucket].astype(np.int32)
    tail = tail if tail.size else np.full((1,), -1, dtype=np.int32)
    # Pad the tail to a multiple of 128, as the reference does.
    tail = np.pad(tail, (0, (-len(tail)) % 128), constant_values=-1)
    dev = centroids.device
    return IVFIndex(centroids, torch.from_numpy(buckets).to(dev),
                    torch.from_numpy(tail).to(dev))


def ivf_lambda_search(xu: torch.Tensor, lambdas: torch.Tensor,
                      ivf: IVFIndex, qn: torch.Tensor, lam_q: torch.Tensor,
                      tau, *, n_probe: int, topk: int):
    """Cluster-routed lambda-aware top-k: qn [Q, F] unit queries, lam_q
    [Q] -> (idx [Q, k], scores [Q, k]) with k = min(topk, candidates).
    The n_probe clusters of the largest cosine to the unit centroids are
    probed (ties to the lower cluster), their members and the tail are
    scored with the blend (padding ids -inf), and the top-k comes from a
    stable sort over candidate positions.  Queries go in chunks whose
    gather stays near GATHER_BYTES; the results do not depend on it."""
    cent = ivf.centroids
    cent_u = cent / torch.clamp_min(
        torch.linalg.norm(cent, dim=1, keepdim=True), 1e-30)
    sims_c = qn @ cent_u.to(qn.dtype).T
    n_p = min(n_probe, cent.shape[0])
    probe = torch.sort(sims_c, dim=1, descending=True,
                       stable=True).indices[:, :n_p]
    q = qn.shape[0]
    m = n_p * ivf.buckets.shape[1] + ivf.tail.shape[0]
    k = min(topk, m)
    step = max(1, GATHER_BYTES // max(1, m * xu.shape[1]
                                      * qn.element_size()))
    tail = ivf.tail.to(torch.int64)
    out_i, out_s = [], []
    for s in range(0, q, step):
        pr = probe[s:s + step]
        nq = pr.shape[0]
        cand = torch.cat([ivf.buckets[pr].reshape(nq, -1).to(torch.int64),
                          tail[None, :].expand(nq, -1)], dim=1)   # [q, M]
        valid = cand >= 0
        safe = torch.clamp_min(cand, 0)
        x_c = xu[safe].to(qn.dtype)                               # [q, M, F]
        cos = torch.bmm(x_c, qn[s:s + step, :, None])[:, :, 0]
        prox = 1.0 / (1.0 + torch.abs(lambdas[safe]
                                      - lam_q[s:s + step, None]))
        score = tau * cos + (1.0 - tau) * prox
        score = torch.where(valid, score, -torch.inf)
        vals, pos = torch.sort(score, dim=1, descending=True, stable=True)
        out_i.append(torch.gather(cand, 1, pos[:, :k]).to(torch.int32))
        out_s.append(vals[:, :k])
    return torch.cat(out_i), torch.cat(out_s)
