"""Batched Rayleigh/Dirichlet energy and Gini dispersion against the dense
F x F feature Laplacian (port of pyarrowspace_tpu/ops/rayleigh.py).

  e_raw(x)  = x^T L x          (Dirichlet energy; optionally / x^T x)
  g_raw(x)  = sum_e s_e^2 with s_e = w_e (x_a - x_b)^2 / sum_e' w_e'(...)^2
              over undirected feature-graph edges e = (a, b), w = -L_ab >= 0
  g_clamped = clip(g_raw, 0, 1)

With W2 = W o W and sums over ordered pairs,
  sum_ab W2_ab (x_a - x_b)^4
    = 2 sum_a x_a^4 r_a + 6 sum_a x_a^2 (W2 x^2)_a - 8 sum_a x_a^3 (W2 x)_a,
r = W2 1, so g_raw = 2 sum_ord m^2 / (sum_ord m)^2 with sum_ord m = 2 x^T L x:
every term is a batched [N, F] x [F, F] matmul.
"""

from __future__ import annotations

import torch


def rayleigh_batch(x: torch.Tensor, lap_f: torch.Tensor,
                   normalized: bool = False) -> torch.Tensor:
    """e_raw for a batch of items: diag(X L X^T) via sum((X @ L) * X, -1).
    normalized=True divides by x^T x; the default keeps the raw,
    magnitude-sensitive Dirichlet energy the reference's outputs need."""
    e = torch.sum((x @ lap_f) * x, dim=-1)
    if normalized:
        denom = torch.sum(x * x, dim=-1)
        e = torch.where(denom > 0, e / torch.clamp_min(denom, 1e-30), 0.0)
    return torch.clamp_min(e, 0.0)   # PSD Laplacian: clamp numeric negatives


def dispersion_batch(x: torch.Tensor, w_f: torch.Tensor,
                     e_unnorm: torch.Tensor) -> torch.Tensor:
    """g_clamped for a batch of items.  e_unnorm is x^T L x per item, so
    the sum over ordered pairs of w_ab (x_a - x_b)^2 is 2 * e_unnorm."""
    w2 = w_f * w_f
    r = torch.sum(w2, dim=1)                       # [F]
    x2 = x * x
    x3 = x2 * x
    x4 = x2 * x2
    t1 = (x4 @ r[:, None])[..., 0]                 # sum x^4 r
    t2 = torch.sum((x2 @ w2) * x2, dim=-1)         # x2 W2 x2
    t3 = torch.sum((x @ w2) * x3, dim=-1)          # x3 W2 x
    sum_ord_m2 = 2.0 * t1 + 6.0 * t2 - 8.0 * t3
    sum_ord_m = 2.0 * e_unnorm
    denom = sum_ord_m * sum_ord_m
    g_raw = torch.where(denom > 0,
                        2.0 * sum_ord_m2 / torch.clamp_min(denom, 1e-30), 0.0)
    return torch.clamp(g_raw, 0.0, 1.0)
