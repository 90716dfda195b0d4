"""Plain reference of the index's spectral state: the reduction (sample,
BIC K search, Lloyd), the F x F feature Laplacian, and each item's taumode
lambda.

A frozen copy of the port's plain PyTorch stages (reduction/pipeline.py,
graph/feature.py, ops/rayleigh.py, spectral/taumode.py, utils/stats.py and
graph/build.py::_assemble_from_knn's order), so that no change to the
program moves what it is held to.  The port's TwoNN estimate is left out:
it only logs, and draws from a generator of its own.  The reduction and the feature Laplacian
run in float32, the configuration's precision, because their choices (the
sample, K, each row's centroid, each column's neighbours) are discrete and
must follow the same arithmetic; the energies, dispersions, tau* and lambdas
are then worked out in ``final_dtype`` (float64 by default) from that
Laplacian.  Imports torch and numpy only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SAMPLING_KEEP_RATE = 0.6
REDUCTION_MIN_N = 4096
REDUCTION_SEED = 42          # the reference binding's fixed seed
TAU_MIX = 0.275
_TAU_FLOOR = 1e-10
_ASSIGN_BLOCK_ELEMS = 2 ** 27
_CUDA_ROWS = 8192


# -- utils/stats.py ---------------------------------------------------------
def median(x: torch.Tensor, dim=None, ignore_nan: bool = False):
    """The mean of the two middle values of an even count; NaNs left out
    with ``ignore_nan``."""
    if dim is None:
        x = x.reshape(-1)
        dim = 0
    s = torch.sort(x, dim=dim).values
    size = s.shape[dim]
    if ignore_nan:
        count = (~torch.isnan(s)).sum(dim=dim, keepdim=True)
    else:
        count = torch.full_like(s.narrow(dim, 0, 1), size, dtype=torch.int64)
    half = (count - 1).clamp_min(0)
    low = torch.gather(s, dim, half // 2)
    high = torch.gather(s, dim, (half + 1) // 2)
    return ((low + high) * 0.5).squeeze(dim)


def segment_sum(values, seg, n_seg: int):
    seg = seg.to(torch.int64)
    order = torch.sort(seg, stable=True).indices
    lengths = torch.bincount(seg, minlength=n_seg)
    return torch.segment_reduce(values[order], "sum", lengths=lengths,
                                axis=0, unsafe=True)


# -- reduction/pipeline.py ----------------------------------------------------
def _index(x, sel: np.ndarray):
    return x[torch.as_tensor(sel, dtype=torch.int64, device=x.device)]


def _assign_block(n: int, k: int, device) -> int:
    if device.type == "cuda":
        return _CUDA_ROWS
    return n if n * k <= _ASSIGN_BLOCK_ELEMS else max(
        8, (_ASSIGN_BLOCK_ELEMS // k) // 8 * 8)


def _assign_argmin_dist(x, c):
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
    return torch.cat(out_a), torch.cat(out_d)


def _assign_argmin(x, c):
    return _assign_argmin_dist(x, c)[0]


def _fixed_point_scale(max_abs: float, n: int) -> float:
    if not max_abs > 0:
        return 1.0
    return math.ldexp(1.0, math.floor(61 - math.log2(max_abs * max(n, 1))))


def _centroid_update(x, a, c):
    """Lloyd's mean update; empty clusters keep their centroid.  On the
    card: exact int64 fixed-point sums; on the CPU: segment sums."""
    k = c.shape[0]
    a = a.to(torch.int64)
    cnts = torch.bincount(a, minlength=k)
    if x.device.type == "cuda":
        scale = _fixed_point_scale(float(x.abs().max()) if x.numel() else 0.0,
                                   x.shape[0])
        q = torch.round(x * scale).to(torch.int64)
        sums = torch.zeros((k, x.shape[1]), dtype=torch.int64,
                           device=x.device).index_add_(0, a, q)
        mean = (sums.to(torch.float64) / scale) / torch.clamp_min(
            cnts.to(torch.float64), 1.0)[:, None]
        return torch.where(cnts[:, None] > 0, mean.to(c.dtype), c), cnts
    sums = segment_sum(x, a, k)
    cnts_f = cnts.to(x.dtype)
    return torch.where(cnts_f[:, None] > 0,
                       sums / torch.clamp_min(cnts_f[:, None], 1.0), c), cnts


def _lloyd(x, centroids, n_iters: int):
    c = centroids
    for _ in range(n_iters):
        c, _ = _centroid_update(x, _assign_argmin(x, c), c)
    return c, _assign_argmin(x, c)


def _select_k(n_sampled: int, eps_hint) -> int:
    factor = 1.0
    if eps_hint is not None and eps_hint > 0:
        factor = max(0.25, 1.0 + 0.08 * math.log(eps_hint))
    return int(np.clip(round(math.sqrt(n_sampled) / 2.5 * factor), 16, 512))


def _kmeans_bic(xs, k: int, seed: int, n_iters: int = 4) -> float:
    rng = np.random.default_rng(seed)
    init = rng.choice(xs.shape[0], size=min(k, xs.shape[0]), replace=False)
    c, _ = _lloyd(xs, _index(xs, init), n_iters)
    _, d2 = _assign_argmin_dist(xs, c)
    ns = xs.shape[0]
    w = float(torch.mean(d2))
    return ns * math.log(max(w, 1e-12)) + 0.5 * k * math.log(ns)


def _select_k_searched(xs, n_sampled: int, eps_hint, seed: int,
                       max_points: int = 4096) -> int:
    lo = _select_k(n_sampled, eps_hint)
    lo, hi = min(lo, xs.shape[0]), min(lo + 1, xs.shape[0])
    if hi <= lo:
        return lo
    rng = np.random.default_rng(seed)
    if xs.shape[0] > max_points:
        sub = _index(xs, np.sort(rng.choice(xs.shape[0], size=max_points,
                                            replace=False)))
    else:
        sub = xs
    cands = list(range(lo, hi + 1))
    scores = [_kmeans_bic(sub, kk, seed) for kk in cands]
    return cands[int(np.argmin(scores))]


def reduce_corpus(x, eps_hint, seed: int = REDUCTION_SEED,
                  keep_rate: float = SAMPLING_KEEP_RATE, n_iters: int = 12):
    """Centroids of the sampled rows: the signals of the feature graph."""
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    n_keep = max(2, int(round(n * keep_rate)))
    sel = np.sort(rng.choice(n, size=n_keep, replace=False))
    xs = x if n_keep >= n else _index(x, sel)
    k = min(_select_k_searched(xs, n_keep, eps_hint, seed), n_keep)
    init_sel = rng.choice(n_keep, size=k, replace=False)
    centroids, _ = _lloyd(xs, _index(xs, init_sel), n_iters)
    return centroids


# -- graph/feature.py ---------------------------------------------------------
def laplacian_from_sq_dists(d2, *, k_f: int, sigma_scale=None):
    f = d2.shape[0]
    dev = d2.device
    eye = torch.eye(f, dtype=torch.bool, device=dev)
    d2 = d2.masked_fill(eye, float("inf"))
    kk = max(1, min(k_f, f - 1))
    nbr = torch.sort(d2, dim=1, stable=True).indices[:, :kk]
    mask = torch.zeros((f, f), dtype=torch.bool, device=dev)
    rows = torch.arange(f, device=dev)[:, None].expand(f, kk)
    mask[rows.reshape(-1), nbr.reshape(-1)] = True
    mask = mask | mask.T
    if sigma_scale is None:
        w_f = mask.to(d2.dtype)
    else:
        d = torch.sqrt(torch.where(eye, 0.0, torch.clamp_min(d2, 0.0)))
        kept = torch.where(mask, d, float("nan"))
        med = median(kept, ignore_nan=True)
        med = torch.where(torch.isfinite(med) & (med > 0), med, 1.0)
        nn_mask = torch.zeros((f, f), dtype=torch.bool, device=dev)
        nn_mask[torch.arange(f, device=dev), nbr[:, 0]] = True
        nn_mask = nn_mask | nn_mask.T
        keep = (mask & (d <= sigma_scale * med)) | nn_mask
        keep = keep | keep.T
        kept_d = torch.where(keep, d, float("nan"))
        m_i = median(kept_d, dim=1, ignore_nan=True)
        m_i = torch.where(torch.isfinite(m_i) & (m_i > 0), m_i, med)
        sig2 = (sigma_scale * sigma_scale) * m_i[:, None] * m_i[None, :]
        w_f = torch.where(keep, torch.exp(-(d * d) / (2.0 * sig2)), 0.0)
    degrees = torch.sum(w_f, dim=1)
    return w_f, torch.diag(degrees) - w_f


def feature_laplacian(signals, *, k_f: int, sigma_scale=None):
    cols = signals.T
    sq = torch.sum(cols * cols, dim=1)
    d2 = torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * (cols @ cols.T),
                         0.0)
    return laplacian_from_sq_dists(d2, k_f=k_f, sigma_scale=sigma_scale)


# -- ops/rayleigh.py, spectral/taumode.py -----------------------------------
def rayleigh(x, lap_f):
    return torch.clamp_min(torch.sum((x @ lap_f) * x, dim=-1), 0.0)


def dispersion(x, w_f, e):
    w2 = w_f * w_f
    r = torch.sum(w2, dim=1)
    x2 = x * x
    x3 = x2 * x
    x4 = x2 * x2
    t1 = (x4 @ r[:, None])[..., 0]
    t2 = torch.sum((x2 @ w2) * x2, dim=-1)
    t3 = torch.sum((x @ w2) * x3, dim=-1)
    sum_m2 = 2.0 * t1 + 6.0 * t2 - 8.0 * t3
    sum_m = 2.0 * e
    denom = sum_m * sum_m
    g = torch.where(denom > 0, 2.0 * sum_m2 / torch.clamp_min(denom, 1e-30),
                    0.0)
    return torch.clamp(g, 0.0, 1.0)


def synthesize(e, g, tau_star, tau_mix: float = TAU_MIX):
    tau_star = torch.clamp_min(tau_star, _TAU_FLOOR)
    return tau_mix * (e / (e + tau_star)) + (1.0 - tau_mix) * g


def lambdas_of(x, lap_f, w_f, tau_star, rows: int = 65536):
    """Taumode lambdas of the rows of x against (lap_f, w_f, tau*), in row
    blocks, in x's dtype."""
    out = []
    for s in range(0, x.shape[0], rows):
        xb = x[s:s + rows]
        e = rayleigh(xb, lap_f)
        out.append(synthesize(e, dispersion(xb, w_f, e), tau_star))
    return torch.cat(out)


# -- the build's order (graph/build.py::_assemble_from_knn) ------------------
def index_state(x: torch.Tensor, graph_params: dict,
                final_dtype=torch.float64) -> dict:
    """The spectral state a build derives from its float32 corpus ``x``:
    lap_f, w_f (float32), then tau* and every item's lambda in
    ``final_dtype``."""
    n = x.shape[0]
    eps, topk = float(graph_params["eps"]), int(graph_params["topk"])
    if n >= REDUCTION_MIN_N:
        signals = reduce_corpus(x, eps_hint=eps)
        sigma_scale = float(np.clip(eps / 10.0, 0.25, 4.0))
    else:
        signals, sigma_scale = x, None
    w_f, lap_f = feature_laplacian(signals, k_f=topk, sigma_scale=sigma_scale)
    del signals
    lap, w = lap_f.to(final_dtype), w_f.to(final_dtype)
    e = torch.cat([rayleigh(x[s:s + 65536].to(final_dtype), lap)
                   for s in range(0, n, 65536)])
    tau_star = torch.clamp_min(median(e), _TAU_FLOOR)
    lam = torch.cat([
        synthesize(e[s:s + 65536],
                   dispersion(x[s:s + 65536].to(final_dtype), w,
                              e[s:s + 65536]), tau_star)
        for s in range(0, n, 65536)])
    return dict(lap_f=lap, w_f=w, tau_star=tau_star, lambdas=lam)
