"""Unit normalisation, the edge-weight kernel and the exact eps/k-NN graph
candidates (port of pyarrowspace_tpu/ops/distance.py and of the variant
dispatch of pyarrowspace_tpu/ops/pallas/knn.py).

Rectified-cosine distance d(i, j) = 1 - max(0, cos(x_i, x_j)); an edge is
kept iff d <= eps, capped at the k nearest per node (reference
GRAPH_VARIABLES.md).  The scan itself is kernel K1 (ops/cuda/knn.py), or
K1t (ops/cuda/knn_t.py) under ``variant="transposed"``: the hand-written
CUDA kernels on a CUDA tensor, their plain PyTorch version on a CPU
tensor.  Every variant returns the default scan's result bit for bit.
"""

from __future__ import annotations

import os

import torch

from .cuda import knn as knn_kernel
from .cuda import knn_t

INF_DIST = knn_kernel.INF_DIST

# ARROWSPACE_KNN_VARIANT: the k-NN scan of a build.  "rowmajor" is K1;
# "transposed" K1t; "diagstart" K1 with each row block's column walk
# starting at its own tile; "reorder" K1 with that walk over a corpus
# sorted by a 1-D projection.  "subtile" is "rowmajor": K1 already merges
# each 64-column slice on its own, gated by a ballot against the kth
# entry, which is what the TPU kernel's `sub` slices bought.  Its width
# ARROWSPACE_KNN_SUB is accepted for compatibility with the JAX package
# (a positive integer, else ValueError) and changes nothing.
VARIANTS = ("rowmajor", "transposed", "subtile", "diagstart", "reorder")


def unit_normalize(x: torch.Tensor, dim: int = -1,
                   eps: float = 1e-30) -> torch.Tensor:
    """Row-normalize to unit L2 norm; all-zero rows stay zero (cosine 0
    against everything, so distance 1)."""
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp_min(n, eps)


def knn_variant(variant: str | None = None) -> str:
    """The k-NN variant: ``variant``, else ARROWSPACE_KNN_VARIANT, else
    "rowmajor".  An unknown name, or under "subtile" an
    ARROWSPACE_KNN_SUB that is not a positive integer, raises."""
    if variant is None:
        variant = os.environ.get("ARROWSPACE_KNN_VARIANT", "rowmajor")
    if variant not in VARIANTS:
        raise ValueError(f"unknown k-NN variant {variant!r}; accepted: "
                         f"{', '.join(VARIANTS)}")
    if variant == "subtile":
        raw = os.environ.get("ARROWSPACE_KNN_SUB", "256")
        if not (raw.isdecimal() and int(raw) > 0):
            raise ValueError(f"ARROWSPACE_KNN_SUB must be a positive "
                             f"integer, got {raw!r}")
    return variant


def projection_order(xu: torch.Tensor) -> torch.Tensor:
    """Rows sorted by a 1-D spectral projection (int64 [N]): 2 normalised
    power steps on XᵀX from XᵀX·1, then the keys X·v (the reference's
    knn.py:428-438).  The port scans the corpus unpadded, so there are no
    pad keys to push to +inf."""
    xtx = xu.T @ xu
    v = xtx.sum(dim=1)
    for _ in range(2):
        v = xtx @ v
        v = v / torch.clamp_min(torch.linalg.vector_norm(v), 1e-30)
    return torch.argsort(xu @ v, stable=True)


def _k_eff(n: int, k: int) -> int:
    return max(1, min(k, n - 1)) if n > 1 else 1


def _pad_width(d: torch.Tensor, i: torch.Tensor, k: int):
    if d.shape[1] < k:
        d = torch.nn.functional.pad(d, (0, k - d.shape[1]), value=INF_DIST)
        i = torch.nn.functional.pad(i, (0, k - i.shape[1]), value=-1)
    return d, i


def knn_graph_candidates(xu: torch.Tensor, k: int, eps: float,
                         variant: str | None = None):
    """Exact eps-filtered k-NN over unit-normalized rows, with the contract
    of the reference's ``knn_graph_candidates_chunked``: (dist [N, k],
    idx [N, k] int32) ascending per row, missing entries (2.0, -1),
    k_eff = min(k, N - 1) neighbours padded back to width k.  ``variant``
    (default ARROWSPACE_KNN_VARIANT) picks the scan (VARIANTS)."""
    variant = knn_variant(variant)
    k_eff = _k_eff(xu.shape[0], k)
    if variant == "transposed":
        d, i = knn_t.knn_scan_t(xu, k_eff, eps)
    elif variant == "reorder":
        perm = projection_order(xu)
        d, i = knn_kernel.knn_scan(xu[perm].contiguous(), k_eff, eps,
                                   diag_start=True, perm=perm)
    else:
        d, i = knn_kernel.knn_scan(xu, k_eff, eps,     # rowmajor, subtile
                                   diag_start=variant == "diagstart")
    d, i = _pad_width(d, i, k)
    return d.to(xu.dtype), i


def extend_knn_candidates(xu_all: torch.Tensor, d_old: torch.Tensor,
                          i_old: torch.Tensor, n_old: int, k: int,
                          eps: float):
    """Incremental exact k-NN (port of the reference's
    ``extend_knn_candidates``): append xu_all[n_old:] to a corpus whose
    lists over xu_all[:n_old] are (d_old, i_old).  Equals
    ``knn_graph_candidates(xu_all, k, eps)`` bit for bit without the old x
    old scan: the old rows run K1 over the new columns only, seeded with
    their stored lists (narrower ones padded with (2.0, -1)); the new rows
    run K1 over every column."""
    n = xu_all.shape[0]
    m = n - n_old
    if m <= 0:
        return d_old, i_old
    k_eff = _k_eff(n, k)
    seed_d, seed_i = _pad_width(d_old[:, :k_eff], i_old[:, :k_eff], k_eff)
    d_o, i_o = knn_kernel.knn_scan(xu_all, k_eff, eps, 0, n_old,
                                   col_start=n_old,
                                   seed=(seed_d.contiguous(),
                                         seed_i.contiguous()))
    d_n, i_n = knn_kernel.knn_scan(xu_all, k_eff, eps, n_old, m)
    d, i = _pad_width(torch.cat([d_o, d_n]), torch.cat([i_o, i_n]), k)
    return d.to(xu_all.dtype), i


def kernel_weights(dist: torch.Tensor, sigma: float, p: float) -> torch.Tensor:
    """Edge-weight kernel w = 1 / (1 + (d / sigma)^p)
    (reference GRAPH_VARIABLES.md:7-10)."""
    sigma_t = torch.clamp_min(
        torch.as_tensor(sigma, dtype=dist.dtype, device=dist.device), 1e-12)
    return 1.0 / (1.0 + torch.pow(torch.clamp_min(dist, 0.0) / sigma_t, p))
