"""Dims-reduction / sampling / clustering stage — the port of
pyarrowspace_tpu/reduction/pipeline.py.

  1. random sampling with ~60% keep rate (seeded; reference seed 42),
  2. Two-NN intrinsic-dimension estimate,
  3. K from the rate estimate, searched over [K, K+1] by a BIC objective,
  4. Lloyd's K-means -> centroid "signals" matrix, assignments for all items.

The serving clustering of blocked IVF adds ``lloyd_reseed`` (Lloyd with
empty-cluster reseeding, ``reduce_corpus(reseed_empty=True)``),
``lloyd_tighten`` (split fat or oversized clusters) and
``planned_slab_cap``.

Every random draw is a numpy ``default_rng`` draw in the same calls and
the same order as the reference, and the reseeding's Gumbel noise is the
reference's ``jax.random`` stream (utils/prng.py), so on CPU the port
picks the same sample, initial centroids and reseeds.  On the CPU the
centroid sums are ``utils.stats.segment_sum`` (the rows added in row
order).  On the card they are exact int64 fixed-point sums
(``fixed_point_sums``) and every assignment product has one shape
(``_assign_block``): two runs give the same bits (close to the
reference's, not equal to them), and so does any split of the rows across
the ranks of parallel/sharded.py.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from ..utils import prng
from ..utils.debug import dbg_println, span
from ..utils.logging import get_logger
from ..utils.stats import median, segment_sum

log_sampling = get_logger("sampling")
log_clustering = get_logger("clustering")

SAMPLING_KEEP_RATE = 0.6  # observed in reference build logs (suggested_eps.md:6)

# Row blocks keep the [rows, K] assignment distances near this many elements
# (CPU); on the card every assignment product has _CUDA_ROWS rows.
_ASSIGN_BLOCK_ELEMS = 2 ** 27
_CUDA_ROWS = 8192


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


def _assign_block(n: int, k: int, device: torch.device) -> int:
    """Rows of one assignment product.  On the card always _CUDA_ROWS (the
    last block zero padded), so a row's distances come from products of
    one shape wherever the row sits: one device and the shards of
    parallel/sharded.py give the same bits.  On the CPU, blocks of a
    bounded [rows, K] size."""
    if device.type == "cuda":
        return _CUDA_ROWS
    return n if n * k <= _ASSIGN_BLOCK_ELEMS else max(
        8, (_ASSIGN_BLOCK_ELEMS // k) // 8 * 8)


def _assign_argmin_dist(x: torch.Tensor, c: torch.Tensor):
    """Nearest centroid per row (first index on ties) and the squared
    distance to it, in row blocks (``_assign_block``)."""
    n, k = x.shape[0], c.shape[0]
    c_sq = torch.sum(c * c, dim=1)[None, :]
    block = _assign_block(n, k, x.device)
    pad = x.device.type == "cuda"
    out_a, out_d = [], []
    for s in range(0, n, block):
        xb = x[s:s + block]
        rows = xb.shape[0]
        if pad and rows < block:
            xb = torch.cat([xb, xb.new_zeros((block - rows, xb.shape[1]))])
        d2 = torch.sum(xb * xb, dim=1)[:, None] + c_sq - 2.0 * (xb @ c.T)
        d2min, a = torch.min(d2[:rows], dim=1)
        out_a.append(a.to(torch.int32))
        out_d.append(d2min)
    if not out_a:
        return (torch.empty(0, dtype=torch.int32, device=x.device),
                x.new_empty(0))
    return torch.cat(out_a), torch.cat(out_d)


def _assign_argmin(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return _assign_argmin_dist(x, c)[0]


def _lloyd(x: torch.Tensor, centroids: torch.Tensor, n_iters: int):
    """Fixed-iteration Lloyd's K-means; empty clusters keep their centroid."""
    c = centroids
    for _ in range(n_iters):
        c, _ = _centroid_update(x, _assign_argmin(x, c), c)
    return c, _assign_argmin(x, c)


def fixed_point_scale(max_abs: float, n: int) -> float:
    """2^s for exact int64 sums of n values of magnitude at most max_abs:
    the largest s with n * max_abs * 2^s under 2^61."""
    if not max_abs > 0:
        return 1.0
    return math.ldexp(1.0, math.floor(61 - math.log2(max_abs * max(n, 1))))


def fixed_point_sums(x: torch.Tensor, a: torch.Tensor, k: int,
                     scale: float) -> torch.Tensor:
    """[k, F] int64 sums of the rows of x per segment a, each value taken
    as round(x * scale): integer sums, exact in any order and any split of
    the rows (the atomics of index_add_ give the same bits every run)."""
    q = torch.round(x * scale).to(torch.int64)
    out = torch.zeros((k, x.shape[1]), dtype=torch.int64, device=x.device)
    return out.index_add_(0, a.to(torch.int64), q)


def centroids_from_sums(sums: torch.Tensor, cnts: torch.Tensor,
                        c: torch.Tensor, scale: float) -> torch.Tensor:
    """The means of fixed_point_sums (float64, then c's dtype); an empty
    cluster keeps its centroid."""
    mean = (sums.to(torch.float64) / scale) / torch.clamp_min(
        cnts.to(torch.float64), 1.0)[:, None]
    return torch.where(cnts[:, None] > 0, mean.to(c.dtype), c)


def _centroid_update(x: torch.Tensor, a: torch.Tensor, c: torch.Tensor):
    """Lloyd's mean update (empty clusters keep their centroid) and the
    cluster sizes.  On the card the sums are fixed_point_sums at the
    scale of the rows' largest magnitude (the same bits for any split of
    the rows: parallel/sharded.py's Lloyd); on the CPU, segment_sum."""
    k = c.shape[0]
    a = a.to(torch.int64)
    # Counts are integers: exact in any order.
    cnts = torch.bincount(a, minlength=k)
    if x.device.type == "cuda":
        scale = fixed_point_scale(float(x.abs().max()) if x.numel() else 0.0,
                                  x.shape[0])
        return (centroids_from_sums(fixed_point_sums(x, a, k, scale), cnts,
                                    c, scale), cnts.to(x.dtype))
    sums = segment_sum(x, a, k)
    cnts = cnts.to(x.dtype)
    return torch.where(cnts[:, None] > 0,
                       sums / torch.clamp_min(cnts[:, None], 1.0), c), cnts


def lloyd_reseed(x: torch.Tensor, centroids: torch.Tensor, n_iters: int,
                 seed: int = 0):
    """Lloyd's K-means with empty-cluster reseeding — the serving-quality
    clustering for IVF slab layouts and exactness certificates.

    Each iteration recycles EMPTY clusters and one of each pair of TWIN
    centroids (nearest-centroid distance under 0.4 x the median),
    reseeding them at corpus points drawn without replacement in
    proportion to their squared distance to the current assignment: a
    Gumbel top-k over log d^2 + g, where g is the reference's
    ``jax.random.gumbel(fold_in(PRNGKey(seed), it), (N,), float32)``
    (utils/prng.py), drawn on the host.  The last two iterations never
    reseed.

    The reference writes the self-distance mask as ``cc + eye(K) * inf``,
    which is NaN off the diagonal when evaluated op by op; compiled under
    its ``jit``, XLA folds it to +inf on the diagonal and 0 elsewhere,
    and that is the behaviour the port reproduces."""
    k = centroids.shape[0]
    key = prng.prng_key(seed)
    c = centroids
    eye = torch.eye(k, dtype=torch.bool, device=x.device)
    ar = torch.arange(k, device=x.device)
    for it in range(n_iters):
        a, d2 = _assign_argmin_dist(x, c)
        new_c, cnts = _centroid_update(x, a, c)
        empty = cnts <= 0
        sq = torch.sum(new_c * new_c, dim=1)
        cc = (sq[:, None] + sq[None, :]
              - 2.0 * (new_c @ new_c.T).to(torch.float32))
        cc = cc.masked_fill(eye, math.inf)
        cc = torch.where(empty[:, None] | empty[None, :], math.inf, cc)
        nn_d2 = torch.min(cc, dim=1).values
        nn_id = torch.argmin(cc, dim=1)
        finite = torch.isfinite(nn_d2)
        fill = torch.max(torch.where(finite, nn_d2, 0.0))
        med = median(torch.where(finite, nn_d2, fill))
        twin = (nn_d2 < 0.16 * med) & (ar < nn_id)
        recycle = empty | twin
        if it < n_iters - 2 and bool(recycle.any()):
            g = torch.from_numpy(prng.gumbel(prng.fold_in(key, it),
                                             x.shape[0])).to(x.device)
            score = torch.log(torch.clamp_min(d2.to(torch.float32),
                                              1e-30)) + g
            pick = torch.sort(score, descending=True,
                              stable=True).indices[:k]
            rank = torch.cumsum(recycle.to(torch.int64), dim=0) - 1
            reseeded = x[pick[torch.clamp(rank, 0, k - 1)]]
            new_c = torch.where(recycle[:, None], reseeded, new_c)
        c = new_c
    return c, _assign_argmin(x, c)


def _radius_stats(x: torch.Tensor, c: torch.Tensor):
    """Per-cluster max squared member distance to the UNIT centroid (the
    anchor of the certification bound), one farthest member id, and the
    cluster sizes.  Assumes unit-normalized x."""
    k = c.shape[0]
    a, d2 = _assign_argmin_dist(x, c)
    a64 = a.to(torch.int64)
    cn = torch.sqrt(torch.clamp_min(torch.sum(c * c, dim=1), 1e-30))[a64]
    # ||x - c/||c||||^2 from ||x-c||^2 via x.c = (1 + ||c||^2 - d^2)/2.
    d2u = torch.clamp_min(2.0 - (1.0 + cn * cn - d2) / cn, 0.0)
    rmax2 = torch.full((k,), -math.inf, dtype=d2u.dtype,
                       device=x.device).scatter_reduce_(0, a64, d2u, "amax")
    is_far = d2u >= rmax2[a64] - 1e-12
    ids = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    far = torch.full((k,), torch.iinfo(torch.int32).min, dtype=torch.int32,
                     device=x.device).scatter_reduce_(
        0, a64, torch.where(is_far, ids, -1), "amax")
    sizes = torch.bincount(a64, minlength=k)
    return a, rmax2, far, sizes


def _pad_k(c: torch.Tensor) -> torch.Tensor:
    """At K >= 1024, pad the centroid set to a multiple of 128 with far
    sentinels (1e6 rows: they capture no member and bound as empty
    slabs).  K sets the slab layout, so the port pads as the reference
    does."""
    k = c.shape[0]
    k_pad = ((k + 127) // 128) * 128
    if k < 1024 or k_pad == k:
        return c
    sentinel = torch.full((k_pad - k, c.shape[1]), 1e6, dtype=c.dtype,
                          device=c.device)
    return torch.cat([c, sentinel])


def lloyd_tighten(x: torch.Tensor, centroids: torch.Tensor,
                  assignments=None, r_max: float = 0.75,
                  max_rounds: int = 8, settle_iters: int = 2,
                  max_size: int | None = None):
    """Grow the centroid set until every cluster's covering radius (to its
    unit centroid) is <= r_max and, when max_size is given, no cluster
    has more than max_size members: a fat cluster saturates its
    certification bound, and an oversized one spills in
    build_blocked_ivf.  Each round plants a new centroid at every
    offending cluster's farthest member and settles with plain Lloyd;
    K grows by the number of splits (padded by _pad_k at K >= 1024).
    Returns (centroids, assignments)."""
    c = centroids
    for _ in range(max_rounds):
        a, rmax2, far, sizes = _radius_stats(x, c)
        fat = rmax2 > r_max * r_max
        if max_size is not None:
            fat |= sizes > max_size
        fat &= sizes > 0                 # sentinels never split
        if not bool(fat.any()):
            return c, (a if assignments is None else _assign_argmin(x, c))
        new_ids = far[fat]
        new_ids = new_ids[new_ids >= 0].to(torch.int64)
        c = _pad_k(torch.cat([c, x[new_ids]]))
        c, _ = _lloyd(x, c, settle_iters)
    return c, _assign_argmin(x, c)


def planned_slab_cap(n: int, k: int, capacity_factor: float = 2.0) -> int:
    """The slab capacity build_blocked_ivf chooses for n items and k
    clusters (rounded up to 128) — lloyd_tighten's max_size for a
    spill-free partition."""
    cap = max(8, int(np.ceil(capacity_factor * n / k)))
    return ((cap + 127) // 128) * 128


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
    _kmeans_bic on a subsample of max_points; the lowest score wins.
    ARROWSPACE_K_SEARCH=0 takes the closed-form K (the range's low end)."""
    lo, hi = k_search_range(n_sampled, intrinsic_dim, eps_hint)
    lo = min(lo, xs.shape[0])
    hi = min(hi, xs.shape[0])
    if os.environ.get("ARROWSPACE_K_SEARCH", "1") == "0" or hi <= lo:
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
                  eps_hint: float | None = None,
                  reseed_empty: bool = False) -> ReductionResult:
    """Run the reduction stage; returns centroids over the sampled set and
    assignments for the FULL corpus.  reseed_empty=True clusters with
    lloyd_reseed (the serving clustering of enable_ivf) instead of plain
    Lloyd.  At keep_rate=1.0 the sample is the whole corpus and is not
    gathered (a second copy of a 1M x 768 corpus is 3 GB).  Its steps are
    the ranges ``reduction.twonn``, ``.select_k``, ``.lloyd`` and
    ``.assign`` of a ``torch.profiler`` trace (utils/debug.py::span)."""
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

    with span("reduction.twonn"):
        idim, mlm = twonn_intrinsic_dim(xs, seed=seed)
    msg = f"reduction: TwoNN mean-log-ratio={mlm:.4f} -> ID={idim}"
    dbg_println(msg)
    log_clustering.debug(msg)

    with span("reduction.select_k"):
        k = (k_clusters if k_clusters is not None
             else select_k_searched(xs, n_keep, idim, eps_hint, seed=seed))
    k = min(k, n_keep)
    msg = f"reduction: clustering K={k}"
    dbg_println(msg)
    log_clustering.debug(msg)

    with span("reduction.lloyd"):
        init_sel = rng.choice(n_keep, size=k, replace=False)
        if reseed_empty:
            centroids, _ = lloyd_reseed(xs, _index(xs, init_sel), n_iters,
                                        seed=seed)
        else:
            centroids, _ = _lloyd(xs, _index(xs, init_sel), n_iters)
    with span("reduction.assign"):
        assignments = _assign_argmin(x, centroids)
    return ReductionResult(centroids=centroids, assignments=assignments,
                           intrinsic_dim=idim, n_sampled=n_keep, k_clusters=k)
