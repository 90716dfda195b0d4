"""Query-time lambda-aware ranking (port of the exact-search part of
pyarrowspace_tpu/ops/search.py).

  score(q, i) = tau * cos(q, x_i) + (1 - tau) / (1 + |lambda_i - lambda_q|)

with tau the blend control (tau = 1.0 -> pure cosine ranking), results
descending, ties to the smallest id (a stable sort; ``torch.topk``
promises no order among ties).
"""

from __future__ import annotations

import torch

from .cuda import scan_topk
from .distance import unit_normalize
from .rayleigh import dispersion_batch, rayleigh_batch
from ..spectral.taumode import synthesize


def lambda_aware_topk(xu: torch.Tensor, lambdas: torch.Tensor,
                      q: torch.Tensor, lam_q: torch.Tensor, tau,
                      topk: int):
    """Top-k by tau-blended cosine + lambda-proximity (single query);
    returns (idx [topk], vals [topk])."""
    qn = unit_normalize(q)
    cos = xu @ qn
    prox = 1.0 / (1.0 + torch.abs(lambdas - lam_q))
    score = tau * cos + (1.0 - tau) * prox
    vals, idx = torch.sort(score, descending=True, stable=True)
    return idx[:topk], vals[:topk]


def lambda_aware_topk_batch(xu: torch.Tensor, lambdas: torch.Tensor,
                            q_batch: torch.Tensor, lam_q: torch.Tensor, tau,
                            topk: int):
    """Batched variant: q_batch [Q, F], lam_q [Q] -> (idx [Q, topk] int32,
    vals [Q, topk]).  This is the plain version of kernel K2 on
    unit-normalized queries."""
    return scan_topk.scan_plain(xu, lambdas, unit_normalize(q_batch), lam_q,
                                tau, topk)


def query_lambdas(q_batch: torch.Tensor, lap_f: torch.Tensor,
                  w_f: torch.Tensor, tau_star: torch.Tensor, *,
                  rayleigh_normalized: bool, tau_mix: float) -> torch.Tensor:
    """Synthetic lambdas of a query batch against the stored feature
    Laplacian (the same synthesis as the items')."""
    e_un = rayleigh_batch(q_batch, lap_f, normalized=False)
    e_raw = (rayleigh_batch(q_batch, lap_f, normalized=True)
             if rayleigh_normalized else e_un)
    g = dispersion_batch(q_batch, w_f, e_un)
    return synthesize(e_raw, g, tau_star, tau_mix)


def fused_query_pipeline(xu: torch.Tensor, lambdas: torch.Tensor,
                         lap_f: torch.Tensor, w_f: torch.Tensor,
                         tau_star: torch.Tensor, q_batch: torch.Tensor, tau,
                         *, topk: int, rayleigh_normalized: bool,
                         tau_mix: float):
    """The serving step: query lambda synthesis, then the blended scan with
    a running top-k — kernel K2 on CUDA, its plain version on CPU.
    Returns (idx [Q, k] int32, vals [Q, k]) with k = min(topk, N)."""
    lam_q = query_lambdas(q_batch, lap_f, w_f, tau_star,
                          rayleigh_normalized=rayleigh_normalized,
                          tau_mix=tau_mix)
    return scan_topk.lambda_search(xu, lambdas, unit_normalize(q_batch),
                                   lam_q, tau, topk)
