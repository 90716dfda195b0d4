"""IVF postings — the index ``enable_ivf`` builds (port of the build part of
pyarrowspace_tpu/ops/ivf.py).

Items are bucketed into padded inverted lists by cluster assignment:
buckets of a capacity that is a multiple of the mean cluster size, and
the overflow in a shared tail bucket, so no item is unreachable.  The
gather-routed search over them (``ivf_lambda_search``, mode="ivf") is
not ported yet (ROADMAP.md Slice C item 13); blocked-IVF serving
(ops/ivf_scan.py) uses the clustering directly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


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
