"""Query-time lambda-aware ranking (port of the exact and subtile serving
parts of pyarrowspace_tpu/ops/search.py).

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
from .subtile_scan import subtile_search
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


def fused_query_pipeline_subtile(xu_scan: torch.Tensor, xu_f32: torch.Tensor,
                                 lambdas_pad: torch.Tensor, n_real: int,
                                 lap_f: torch.Tensor, w_f: torch.Tensor,
                                 tau_star: torch.Tensor,
                                 q_batch: torch.Tensor, tau, *, topk: int,
                                 rayleigh_normalized: bool, tau_mix: float):
    """The subtile serving step: query lambda synthesis, then the
    subtile-max routed scan (ops/subtile_scan.py: kernels K3, K4b, K5 and
    K4a on CUDA).  The state comes from build_subtile_state; selection is
    exact in the scan dtype by the block-max bound, and a pool of 2 x topk
    is rescored in float32, so the rescore can promote items past
    scan-dtype near-ties.  Returns (idx [Q, topk] int32, vals [Q, topk])."""
    lam_q = query_lambdas(q_batch, lap_f, w_f, tau_star,
                          rayleigh_normalized=rayleigh_normalized,
                          tau_mix=tau_mix)
    qn = unit_normalize(q_batch.to(torch.float32))
    return subtile_search(xu_scan, xu_f32, lambdas_pad, qn,
                          lam_q.to(torch.float32), tau, n_real, topk=topk,
                          pool_m=2 * topk)
