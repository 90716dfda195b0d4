"""Feature-space spectral Laplacian (F x F), dense (port of
pyarrowspace_tpu/graph/feature.py).

The calibrated construction (reference-behaviour, see the reference
module): Euclidean distance between RAW feature columns of the signals
matrix, symmetrized k-NN adjacency with k_F = graph_params.topk, binary
weights on the raw-signal path, L = D - W.
"""

from __future__ import annotations

import torch

from ..utils.stats import median


def laplacian_from_sq_dists(d2: torch.Tensor, *, k_f: int,
                            sigma_scale=None):
    """Symmetrized k-NN Laplacian from a dense [F, F] squared-distance
    matrix.

    sigma_scale None -> BINARY adjacency (the test_0-calibrated path used
    when the signals are the raw stored items).  A scalar (~ eps / 10, the
    reduction path) -> (a) k-NN edges farther than sigma_scale x the
    median kept distance are pruned (each column keeps its nearest
    neighbour), and (b) Gaussian weights with per-column local widths
    sigma_ij = sigma_scale * sqrt(m_i * m_j), m_i the median kept distance
    of column i.  Returns (w_f, lap_f, degrees)."""
    f = d2.shape[0]
    dev = d2.device
    eye = torch.eye(f, dtype=torch.bool, device=dev)
    d2 = d2.masked_fill(eye, float("inf"))            # exclude self-loops
    kk = max(1, min(k_f, f - 1))
    # Nearest columns, ties to the lowest index (lax.top_k's rule).
    nbr = torch.sort(d2, dim=1, stable=True).indices[:, :kk]
    mask = torch.zeros((f, f), dtype=torch.bool, device=dev)
    rows = torch.arange(f, device=dev)[:, None].expand(f, kk)
    mask[rows.reshape(-1), nbr.reshape(-1)] = True
    mask = mask | mask.T                              # symmetrize (union)

    if sigma_scale is None:
        w_f = mask.to(d2.dtype)
    else:
        d = torch.sqrt(torch.where(eye, 0.0, torch.clamp_min(d2, 0.0)))
        kept = torch.where(mask, d, float("nan"))
        med = median(kept, ignore_nan=True)
        med = torch.where(torch.isfinite(med) & (med > 0), med, 1.0)
        # (a) eps topology: prune kept edges beyond the eps-scaled
        # threshold; every column keeps its single nearest column.
        nn_mask = torch.zeros((f, f), dtype=torch.bool, device=dev)
        nn_mask[torch.arange(f, device=dev), nbr[:, 0]] = True
        nn_mask = nn_mask | nn_mask.T
        keep = (mask & (d <= sigma_scale * med)) | nn_mask
        keep = keep | keep.T
        # (b) per-column local widths from the surviving edges.
        kept_d = torch.where(keep, d, float("nan"))
        m_i = median(kept_d, dim=1, ignore_nan=True)
        m_i = torch.where(torch.isfinite(m_i) & (m_i > 0), m_i, med)
        sig2 = (sigma_scale * sigma_scale) * m_i[:, None] * m_i[None, :]
        w_f = torch.where(keep, torch.exp(-(d * d) / (2.0 * sig2)), 0.0)
    degrees = torch.sum(w_f, dim=1)
    lap_f = torch.diag(degrees) - w_f
    return w_f, lap_f, degrees


def build_feature_laplacian(signals: torch.Tensor, *, k_f: int,
                            sigma_scale=None):
    """Dense F x F feature-graph adjacency and Laplacian over the columns
    of the signals matrix [M, F] (stored items or reduction centroids, in
    stored scale).  Returns (w_f, lap_f = diag(deg) - w_f, degrees)."""
    cols = signals.T                                  # [F, M]
    sq = torch.sum(cols * cols, dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (cols @ cols.T)
    d2 = torch.clamp_min(d2, 0.0)
    return laplacian_from_sq_dists(d2, k_f=k_f, sigma_scale=sigma_scale)
