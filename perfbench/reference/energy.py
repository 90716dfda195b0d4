"""Plain reference of the energy index and its routed search: the EnergyMaps
build (the upstream's build_energy, src/lib.rs:303-376: compress the corpus
to optical_tokens centroids, diffuse them over their k-NN graph, split the
most dispersed, energy features against the nodes' feature Laplacian) and
search_energy's candidate-pool routing (:311-323) with its score

    D  = max(e_q + e_i - 2 q^T L_f x_i, 0),   D' = D / (D + max(tau*, 1e-10))
    s  = w_l / (1 + |lambda_i - lambda_q|) + w_d / (1 + D')

over each query's pool, ranked descending, ties to the smaller id.

As reference/spectral.py does, the build's discrete choices (the sample,
each row's centroid, the centroids' k-NN graph, the trimmed rows, the split
centroids, each feature column's neighbours) are taken in float32, the
configuration's precision, by the same arithmetic as the program's
(``build(..., torch.float32)``, whose ``choices`` a float64 build then
reuses); the values (centroids as the float32 reduction leaves them, then
diffusion, dispersions, nodes, energies, tau*, lambdas and every search
term) are worked out in float64.  Imports torch, numpy and the spectral
reference beside it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import spectral

TAU_MIX = spectral.TAU_MIX
_TAU_FLOOR = 1e-10
# The routing table's bucket capacity, in mean cluster sizes (the
# program's ops/ivf.py layout at the factor its energy search uses).
CAP_FACTOR = 2.0
_ROWS = 65536


def _sq_dists(a, b):
    d2 = (torch.sum(a * a, dim=1)[:, None] + torch.sum(b * b, dim=1)[None, :]
          - 2.0 * (a @ b.T))
    return torch.clamp_min(d2, 0.0)


def _knn_mask(d, k: int):
    """Symmetrized k-NN mask of a dense distance matrix (self excluded,
    ties to the lower index)."""
    m = d.shape[0]
    eye = torch.eye(m, dtype=torch.bool, device=d.device)
    kk = max(1, min(k, m - 1))
    nbr = torch.sort(d.masked_fill(eye, math.inf), dim=1,
                     stable=True).indices[:, :kk]
    mask = torch.zeros((m, m), dtype=torch.bool, device=d.device)
    rows = torch.arange(m, device=d.device)[:, None].expand(m, kk)
    mask[rows.reshape(-1), nbr.reshape(-1)] = True
    return mask | mask.T


def _reduce(x, k0: int, seed: int, keep_rate: float = 0.6,
            n_iters: int = 12):
    """(centroids, assignments) of the energy build's reduction: a seeded
    sample, K = k0 given, Lloyd from a seeded draw of the sample."""
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    n_keep = max(2, int(round(n * keep_rate)))
    sel = np.sort(rng.choice(n, size=n_keep, replace=False))
    xs = x if n_keep >= n else spectral._index(x, sel)
    k = min(k0, n_keep)
    init = rng.choice(n_keep, size=k, replace=False)
    c, _ = spectral._lloyd(xs, spectral._index(xs, init), n_iters)
    return c, spectral._assign_argmin(x, c)


def build(x: torch.Tensor, graph_params: dict, energy_params: dict,
          dtype=torch.float64, choices: dict | None = None):
    """(state, choices) of the energy index of the float32 corpus x.
    ``choices`` None takes the discrete choices here (call it with
    float32 first); given, they are reused.  state: nodes, node_lambda,
    node_e, node_centroid, lap_f, w_f, tau_star, lambdas, e (items),
    assignments, n_centroids."""
    ep = energy_params
    n, f = x.shape
    fresh = choices is None
    ch = {} if fresh else choices
    # compress (float32: its choices, and the centroids it leaves)
    if fresh:
        k0 = max(2, min(int(ep["optical_tokens"]), n))
        c32, assign = _reduce(x, k0, int(graph_params.get("seed", 42)))
        ch.update(centroids=c32, assignments=assign)
    c = ch["centroids"].to(dtype)
    a = ch["assignments"].to(torch.int64)
    k = c.shape[0]
    # diffuse: `steps` explicit heat steps over the centroids' k-NN graph
    d = torch.sqrt(_sq_dists(c, c))
    if fresh:
        ch["centroid_mask"] = _knn_mask(d, int(ep["neighbor_k"]))
    mask = ch["centroid_mask"]
    sigma = spectral.median(torch.where(mask, d, math.nan), ignore_nan=True)
    sigma = torch.where(torch.isfinite(sigma) & (sigma > 0), sigma, 1.0)
    w = torch.where(mask, 1.0 / (1.0 + (d / sigma) ** 2), 0.0)
    lap_c = torch.diag(torch.sum(w, dim=1)) - w
    for _ in range(int(ep["steps"])):
        c = c - float(ep["eta"]) * (lap_c @ c)
    # split: trimmed member dispersion and dominant residual direction
    xd = x.to(dtype)
    resid = xd - c[a]
    dist = torch.linalg.norm(resid, dim=1)
    if fresh:
        cutoff = torch.quantile(dist, 1.0 - float(ep["trim_quantile"]))
        ch["trimmed"] = dist <= cutoff
    wgt = ch["trimmed"].to(dtype)
    cnt = spectral.segment_sum(wgt, a, k)
    disp = spectral.segment_sum(wgt * dist, a, k)
    disp = torch.where(cnt > 0, disp / torch.clamp_min(cnt, 1.0), 0.0)
    u = torch.ones((f,), dtype=dtype, device=x.device) / math.sqrt(f)
    v = spectral.segment_sum(resid * (wgt * (resid @ u))[:, None], a, k)
    del resid
    vn = torch.linalg.norm(v, dim=1, keepdim=True)
    v = torch.where(vn > 0, v / torch.clamp_min(vn, 1e-12), 0.0)
    if fresh:
        thresh = torch.quantile(disp, 1.0 - float(ep["split_quantile"]))
        ch["split"] = disp >= thresh
    split = ch["split"]
    off = float(ep["split_tau"]) * torch.clamp_min(disp[:, None], 1e-12) * v
    src = torch.arange(k, dtype=torch.int64, device=x.device)
    nodes = torch.cat([c, (c + off)[split], (c - off)[split]])
    node_src = torch.cat([src, src[split], src[split]])
    # features: the nodes' binary feature k-NN Laplacian, then energies,
    # dispersions, tau* and lambdas of nodes and items
    if fresh:
        cols = nodes.T
        ch["feature_mask"] = _knn_mask(_sq_dists(cols, cols),
                                       int(graph_params["topk"]))
    w_f = ch["feature_mask"].to(dtype)
    lap_f = torch.diag(torch.sum(w_f, dim=1)) - w_f
    e_nodes = spectral.rayleigh(nodes, lap_f)
    g_nodes = spectral.dispersion(nodes, w_f, e_nodes)
    e = torch.cat([spectral.rayleigh(xd[s:s + _ROWS], lap_f)
                   for s in range(0, n, _ROWS)])
    tau_star = torch.clamp_min(spectral.median(e), _TAU_FLOOR)
    lam = torch.cat([
        spectral.synthesize(e[s:s + _ROWS], spectral.dispersion(
            xd[s:s + _ROWS], w_f, e[s:s + _ROWS]), tau_star)
        for s in range(0, n, _ROWS)])
    state = dict(nodes=nodes, node_lambda=spectral.synthesize(
        e_nodes, g_nodes, tau_star), node_e=e_nodes, node_centroid=node_src,
        node_disp=disp[node_src], lap_f=lap_f, w_f=w_f, tau_star=tau_star,
        lambdas=lam, e=e, assignments=a, n_centroids=k)
    return state, ch


def energy_graph(state: dict, energy_params: dict) -> torch.Tensor:
    """[M, M] dense Laplacian D - W of the energy graph over the nodes: each
    node's neighbor_k nearest by w_lambda |dlambda| + w_disp |ddisp| +
    w_dirichlet |de| (ties to the lower node), weights 1 / (1 + d), the
    union of both directions (no width cap)."""
    ep = energy_params

    def gap(v):
        return torch.abs(v[:, None] - v[None, :])

    d = (float(ep["w_lambda"]) * gap(state["node_lambda"])
         + float(ep["w_disp"]) * gap(state["node_disp"])
         + float(ep["w_dirichlet"]) * gap(state["node_e"]))
    w = torch.where(_knn_mask(d, int(ep["neighbor_k"])), 1.0 / (1.0 + d),
                    0.0)
    return torch.diag(torch.sum(w, dim=1)) - w


def route_keys(assignments: torch.Tensor, n_centroids: int) -> torch.Tensor:
    """[n] int64: each item's centroid where the centroid's bucket holds it
    (its rank among the centroid's items, by id, under the capacity
    max(8, ceil(CAP_FACTOR n / K))), else n_centroids, the shared tail."""
    n = assignments.shape[0]
    a = assignments.to(torch.int64)
    cap = max(8, int(np.ceil(CAP_FACTOR * n / n_centroids)))
    order = torch.sort(a, stable=True).indices
    starts = torch.searchsorted(a[order], torch.arange(
        n_centroids, device=a.device))
    rank = torch.empty_like(a)
    rank[order] = torch.arange(n, device=a.device) - starts[a[order]]
    return torch.where(rank < cap, a, n_centroids)


def query_terms(q: torch.Tensor, state: dict):
    """(lambda_q, e_q, q L_f) of the rows of q in the state's dtype."""
    qd = q.to(state["lap_f"].dtype)
    ql = qd @ state["lap_f"]
    e_q = torch.clamp_min(torch.sum(ql * qd, dim=-1), 0.0)
    lam_q = spectral.synthesize(
        e_q, spectral.dispersion(qd, state["w_f"], e_q), state["tau_star"])
    return lam_q, e_q, ql


def node_distances(lam_q, e_q, ql, state: dict, w_l: float, w_d: float):
    """[Q, M]: w_l |lambda_node - lambda_q| + w_d D'(q, node)."""
    ts = torch.clamp_min(state["tau_star"], _TAU_FLOOR)
    d = torch.clamp_min(e_q[:, None] + state["node_e"][None, :]
                        - 2.0 * (ql @ state["nodes"].T), 0.0)
    return (w_l * torch.abs(state["node_lambda"][None, :] - lam_q[:, None])
            + w_d * d / (d + ts))


def pools(order, node_centroid, n_centroids: int, probe: int):
    """[Q, K + 1] bool: the centroids of each query's first ``probe``
    nodes in ``order`` [Q, M], and the tail."""
    hit = torch.zeros((order.shape[0], n_centroids + 1), dtype=torch.bool,
                      device=order.device)
    hit.scatter_(1, node_centroid.to(torch.int64)[order[:, :probe]], True)
    hit[:, n_centroids] = True
    return hit


def routed_items(q, state: dict, keys, w_l: float, w_d: float,
                 probe: int) -> int:
    """The items in the routed pools of the queries q, summed."""
    lam_q, e_q, ql = query_terms(q, state)
    order = torch.sort(node_distances(lam_q, e_q, ql, state, w_l, w_d),
                       dim=1, stable=True).indices
    counts = torch.bincount(keys, minlength=state["n_centroids"] + 1)
    hit = pools(order, state["node_centroid"], state["n_centroids"], probe)
    return int((hit * counts).sum())


def scores(x, state: dict, lam_q, e_q, ql, w_l: float, w_d: float):
    """[Q, n] energy scores of the queries against every item."""
    ts = torch.clamp_min(state["tau_star"], _TAU_FLOOR)
    d = torch.clamp_min(e_q[:, None] + state["e"][None, :]
                        - 2.0 * (ql @ x.to(ql.dtype).T), 0.0)
    prox = 1.0 / (1.0 + torch.abs(state["lambdas"][None, :]
                                  - lam_q[:, None]))
    return w_l * prox + w_d / (1.0 + d / (d + ts))
