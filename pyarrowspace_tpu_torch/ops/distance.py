"""Unit normalisation, the edge-weight kernel and the exact eps/k-NN graph
candidates (port of pyarrowspace_tpu/ops/distance.py).

Rectified-cosine distance d(i, j) = 1 - max(0, cos(x_i, x_j)); an edge is
kept iff d <= eps, capped at the k nearest per node (reference
GRAPH_VARIABLES.md).  The scan itself is kernel K1 (ops/cuda/knn.py): the
hand-written CUDA kernel on a CUDA tensor, its plain PyTorch version on a
CPU tensor.
"""

from __future__ import annotations

import torch

from .cuda import knn as knn_kernel

INF_DIST = knn_kernel.INF_DIST


def unit_normalize(x: torch.Tensor, dim: int = -1,
                   eps: float = 1e-30) -> torch.Tensor:
    """Row-normalize to unit L2 norm; all-zero rows stay zero (cosine 0
    against everything, so distance 1)."""
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp_min(n, eps)


def knn_graph_candidates(xu: torch.Tensor, k: int, eps: float):
    """Exact eps-filtered k-NN over unit-normalized rows, with the contract
    of the reference's ``knn_graph_candidates_chunked``: (dist [N, k],
    idx [N, k] int32) ascending per row, missing entries (2.0, -1),
    k_eff = min(k, N - 1) neighbours padded back to width k."""
    n = xu.shape[0]
    k_eff = max(1, min(k, n - 1)) if n > 1 else 1
    d, i = knn_kernel.knn_scan(xu, k_eff, eps)
    if k_eff < k:
        d = torch.nn.functional.pad(d, (0, k - k_eff), value=INF_DIST)
        i = torch.nn.functional.pad(i, (0, k - k_eff), value=-1)
    return d.to(xu.dtype), i


def kernel_weights(dist: torch.Tensor, sigma: float, p: float) -> torch.Tensor:
    """Edge-weight kernel w = 1 / (1 + (d / sigma)^p)
    (reference GRAPH_VARIABLES.md:7-10)."""
    sigma_t = torch.clamp_min(
        torch.as_tensor(sigma, dtype=dist.dtype, device=dist.device), 1e-12)
    return 1.0 / (1.0 + torch.pow(torch.clamp_min(dist, 0.0) / sigma_t, p))
