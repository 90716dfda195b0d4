"""Dims-reduction / sampling / clustering stage — the main-path part of
pyarrowspace_tpu/reduction/pipeline.py.

  1. random sampling with ~60% keep rate (seeded; reference seed 42),
  2. Two-NN intrinsic-dimension estimate,
  3. K from the rate estimate, searched over [K, K+1] by a BIC objective,
  4. Lloyd's K-means -> centroid "signals" matrix, assignments for all items.

Every random draw is a numpy ``default_rng`` draw in the same calls and
the same order as the reference, so on CPU the port picks the same sample
and initial centroids.  On CUDA the centroid sums use ``index_add_``,
whose float atomics sum in an order that changes from run to run: the
centroids there are close to the reference's, not bitwise equal.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..utils.debug import dbg_println
from ..utils.logging import get_logger

log_sampling = get_logger("sampling")
log_clustering = get_logger("clustering")

SAMPLING_KEEP_RATE = 0.6  # observed in reference build logs (suggested_eps.md:6)

# Row blocks keep the [rows, K] assignment distances near this many elements.
_ASSIGN_BLOCK_ELEMS = 2 ** 27


@dataclasses.dataclass
class ReductionResult:
    centroids: torch.Tensor      # [K, F]
    assignments: torch.Tensor    # [N] int32 cluster id per (full-corpus) item
    intrinsic_dim: int
    n_sampled: int
    k_clusters: int


def _index(x: torch.Tensor, sel: np.ndarray) -> torch.Tensor:
    return x[torch.as_tensor(sel, dtype=torch.int64, device=x.device)]


def _twonn_ratio(x: torch.Tensor) -> float:
    """Mean log-ratio of 2nd to 1st nearest-neighbour Euclidean distances."""
    sq = torch.sum(x * x, dim=1)
    d2 = torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T), 0.0)
    n = x.shape[0]
    d2 = d2.masked_fill(torch.eye(n, dtype=torch.bool, device=x.device),
                        float("inf"))
    two = torch.topk(d2, 2, dim=1, largest=False).values  # values only
    r1 = torch.sqrt(torch.clamp_min(two[:, 0], 1e-30))
    r2 = torch.sqrt(torch.clamp_min(two[:, 1], 1e-30))
    mu = torch.clamp_min(r2 / torch.clamp_min(r1, 1e-30), 1.0 + 1e-9)
    return float(torch.mean(torch.log(mu)))


def twonn_intrinsic_dim(x: torch.Tensor, seed: int = 42,
                        max_points: int = 2048) -> tuple[int, float]:
    """Two-NN intrinsic-dimension estimate (Facco et al.): ID ~ 1 / E[log mu]
    over a subsample of max_points.  Returns (ID >= 1, mean log ratio)."""
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    if n > max_points:
        x = _index(x, rng.choice(n, size=max_points, replace=False))
    mean_log_mu = _twonn_ratio(x)
    if mean_log_mu <= 1e-9:
        return 1, mean_log_mu
    return max(1, int(round(1.0 / mean_log_mu))), mean_log_mu


def _assign_argmin_dist(x: torch.Tensor, c: torch.Tensor):
    """Nearest centroid per row (first index on ties) and the squared
    distance to it, in row blocks of a bounded [rows, K] size."""
    n, k = x.shape[0], c.shape[0]
    c_sq = torch.sum(c * c, dim=1)[None, :]
    block = n if n * k <= _ASSIGN_BLOCK_ELEMS else max(
        8, (_ASSIGN_BLOCK_ELEMS // k) // 8 * 8)
    out_a, out_d = [], []
    for s in range(0, n, block):
        xb = x[s:s + block]
        d2 = torch.sum(xb * xb, dim=1)[:, None] + c_sq - 2.0 * (xb @ c.T)
        d2min, a = torch.min(d2, dim=1)
        out_a.append(a.to(torch.int32))
        out_d.append(d2min)
    return torch.cat(out_a), torch.cat(out_d)


def _assign_argmin(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return _assign_argmin_dist(x, c)[0]


def _lloyd(x: torch.Tensor, centroids: torch.Tensor, n_iters: int):
    """Fixed-iteration Lloyd's K-means; empty clusters keep their centroid."""
    k = centroids.shape[0]
    c = centroids
    ones = torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)
    for _ in range(n_iters):
        a = _assign_argmin(x, c).to(torch.int64)
        sums = torch.zeros((k, x.shape[1]), dtype=x.dtype,
                           device=x.device).index_add_(0, a, x)
        cnts = torch.zeros((k,), dtype=x.dtype,
                           device=x.device).index_add_(0, a, ones)
        c = torch.where(cnts[:, None] > 0,
                        sums / torch.clamp_min(cnts[:, None], 1.0), c)
    return c, _assign_argmin(x, c)


def select_k(n_sampled: int, intrinsic_dim: int,
             eps_hint: float | None = None) -> int:
    """Auto K heuristic calibrated to the reference's observed K ~ 178 for
    the 313k corpus: K = clamp(round(sqrt(n)/2.5 * (1 + 0.08 ln eps)),
    16, 512)."""
    del intrinsic_dim  # reserved for future refinement
    factor = 1.0
    if eps_hint is not None and eps_hint > 0:
        factor = max(0.25, 1.0 + 0.08 * math.log(eps_hint))
    return int(np.clip(round(math.sqrt(n_sampled) / 2.5 * factor), 16, 512))


def k_search_range(n_sampled: int, intrinsic_dim: int,
                   eps_hint: float | None = None) -> tuple[int, int]:
    """Candidate-K range [base, base + 1] (the reference logs exactly this
    two-candidate window)."""
    base = select_k(n_sampled, intrinsic_dim, eps_hint)
    return base, base + 1


def _kmeans_bic(xs: torch.Tensor, k: int, seed: int,
                n_iters: int = 4) -> float:
    """BIC-style objective for one candidate K on a subsample: spherical
    log-likelihood of a short Lloyd partition plus a parameter penalty.
    Lower is better."""
    rng = np.random.default_rng(seed)
    init = rng.choice(xs.shape[0], size=min(k, xs.shape[0]), replace=False)
    c, _ = _lloyd(xs, _index(xs, init), n_iters)
    _, d2 = _assign_argmin_dist(xs, c)
    ns = xs.shape[0]
    w = float(torch.mean(d2))
    return ns * math.log(max(w, 1e-12)) + 0.5 * k * math.log(ns)


def select_k_searched(xs: torch.Tensor, n_sampled: int, intrinsic_dim: int,
                      eps_hint: float | None = None, seed: int = 42,
                      max_points: int = 4096) -> int:
    """Optimal-K search: the candidates of k_search_range, each scored by
    _kmeans_bic on a subsample of max_points; the lowest score wins."""
    lo, hi = k_search_range(n_sampled, intrinsic_dim, eps_hint)
    lo = min(lo, xs.shape[0])
    hi = min(hi, xs.shape[0])
    if hi <= lo:
        return lo
    rng = np.random.default_rng(seed)
    if xs.shape[0] > max_points:
        sub = _index(xs, np.sort(rng.choice(xs.shape[0], size=max_points,
                                            replace=False)))
    else:
        sub = xs
    msg = f"reduction: testing K range [{lo}, {hi}] with step 1"
    dbg_println(msg)
    log_clustering.info(msg)
    cands = list(range(lo, hi + 1))
    scores = [_kmeans_bic(sub, kk, seed) for kk in cands]
    k_opt = cands[int(np.argmin(scores))]
    msg = (f"reduction: optimal K={k_opt} (BIC "
           + ", ".join(f"K={kk}: {s:.1f}" for kk, s in zip(cands, scores))
           + ")")
    dbg_println(msg)
    log_clustering.info(msg)
    return k_opt


def reduce_corpus(x: torch.Tensor, seed: int = 42,
                  keep_rate: float = SAMPLING_KEEP_RATE,
                  k_clusters: int | None = None,
                  n_iters: int = 12,
                  eps_hint: float | None = None) -> ReductionResult:
    """Run the reduction stage; returns centroids over the sampled set and
    assignments for the FULL corpus."""
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    n_keep = max(2, int(round(n * keep_rate)))
    # The draw always runs: its stream also feeds the centroid init below.
    sel = np.sort(rng.choice(n, size=n_keep, replace=False))
    xs = x if n_keep >= n else _index(x, sel)
    msg = (f"reduction: raw-input saved; sampled {n_keep}/{n} "
           f"(keep_rate={keep_rate})")
    dbg_println(msg)
    log_sampling.debug(msg)

    idim, mlm = twonn_intrinsic_dim(xs, seed=seed)
    msg = f"reduction: TwoNN mean-log-ratio={mlm:.4f} -> ID={idim}"
    dbg_println(msg)
    log_clustering.debug(msg)

    k = (k_clusters if k_clusters is not None
         else select_k_searched(xs, n_keep, idim, eps_hint, seed=seed))
    k = min(k, n_keep)
    msg = f"reduction: clustering K={k}"
    dbg_println(msg)
    log_clustering.debug(msg)

    init_sel = rng.choice(n_keep, size=k, replace=False)
    centroids, _ = _lloyd(xs, _index(xs, init_sel), n_iters)
    assignments = _assign_argmin(x, centroids)
    return ReductionResult(centroids=centroids, assignments=assignments,
                           intrinsic_dim=idim, n_sampled=n_keep, k_clusters=k)
