"""EnergyMaps — the cosine-free (energy-only) index pipeline (port of
pyarrowspace_tpu/energy/maps.py).

Behavioural equivalent of the reference engine's `EnergyMapsBuilder`
(reference src/lib.rs:303-376):

  1. optical compression: seeded Lloyd k-means to ~optical_tokens
     centroids (reduction/pipeline.reduce_corpus);
  2. diffusion: `steps` explicit heat steps C <- C - eta L C over the
     centroids' k-NN graph;
  3. dispersion-quantile splitting: the top split_quantile fraction of
     centroids by trimmed member dispersion each add two nodes offset by
     +-split_tau along their dominant residual direction;
  4. energy features of nodes and items against the feature Laplacian of
     the nodes (Rayleigh energy, dispersion, taumode lambdas);
  5. the energy graph: k-NN over a pure energy distance (lambda,
     dispersion and Dirichlet energy gaps; no cosine), symmetrized.

Tie rules follow the JAX package: ``lax.top_k`` of negated distances
picks the lowest index among ties, which a stable ascending sort does;
``jnp.nanmedian`` averages the two middle values (utils/stats.median);
``jnp.quantile`` and ``torch.quantile`` both interpolate linearly.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.laplacian import GraphLaplacian
from ..core.params import EnergyParams, GraphParams
from ..core.space import ArrowSpace
from ..graph.build import _pick_dtype, resolve_device, validate_items
from ..graph.feature import build_feature_laplacian
from ..ops.distance import unit_normalize
from ..ops.rayleigh import dispersion_batch, rayleigh_batch
from ..ops.symmetrize import symmetrize_to_ell
from ..reduction.pipeline import reduce_corpus, select_k
from ..spectral.taumode import TAU_MIX, derive_tau_star, synthesize
from ..utils.debug import dbg_println, phase, reset_phase_timings
from ..utils.logging import get_logger
from ..utils.stats import median, segment_sum

log = get_logger("energymaps")


def _pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d2 = (torch.sum(a * a, dim=1)[:, None] + torch.sum(b * b, dim=1)[None, :]
          - 2.0 * (a @ b.T))
    return torch.clamp_min(d2, 0.0)


def _centroid_knn_graph(c: torch.Tensor, k: int):
    """Dense k-NN graph over centroids (Euclidean), kernel-weighted with an
    adaptive sigma = median kept distance.  Returns (w [K,K], lap [K,K])."""
    kdim = c.shape[0]
    kk = max(1, min(k, kdim - 1))
    d = torch.sqrt(_pairwise_sq_dists(c, c))
    eye = torch.eye(kdim, dtype=torch.bool, device=c.device)
    d = d.masked_fill(eye, math.inf)
    nbr = torch.sort(d, dim=1, stable=True).indices[:, :kk]
    mask = torch.zeros((kdim, kdim), dtype=torch.bool, device=c.device)
    rows = torch.arange(kdim, device=c.device)[:, None].expand(kdim, kk)
    mask[rows.reshape(-1), nbr.reshape(-1)] = True
    mask = mask | mask.T
    sigma = median(torch.where(mask, d, math.nan), ignore_nan=True)
    sigma = torch.where(torch.isfinite(sigma) & (sigma > 0), sigma, 1.0)
    w = torch.where(mask, 1.0 / (1.0 + (d / sigma) ** 2), 0.0)
    lap = torch.diag(torch.sum(w, dim=1)) - w
    return w, lap


def _diffuse(c: torch.Tensor, lap: torch.Tensor, eta: float,
             steps: int) -> torch.Tensor:
    """`steps` explicit-Euler heat steps C <- C - eta L C, unnormalized:
    eta is a true step size, stable below 2 / lambda_max(L); past it the
    map degenerates, as the reference's recorded sweep shows."""
    for _ in range(steps):
        c = c - eta * (lap @ c)
    return c


def _member_stats(x: torch.Tensor, centroids: torch.Tensor,
                  assignments: torch.Tensor, trim_quantile: float):
    """Per-centroid dispersion (mean member distance, the top trim_quantile
    of the corpus' member distances left out) and dominant residual
    direction (one batched power-iteration step from a constant probe)."""
    k = centroids.shape[0]
    a = assignments.to(torch.int64)
    resid = x - centroids[a]
    dist = torch.linalg.norm(resid, dim=1)
    cutoff = torch.quantile(dist, 1.0 - trim_quantile)
    wgt = (dist <= cutoff).to(x.dtype)
    cnt = segment_sum(wgt, a, k)
    disp = segment_sum(wgt * dist, a, k)
    disp = torch.where(cnt > 0, disp / torch.clamp_min(cnt, 1.0), 0.0)
    u = torch.ones((x.shape[1],), dtype=x.dtype,
                   device=x.device) / math.sqrt(x.shape[1])
    proj = resid @ u
    v = segment_sum(resid * (wgt * proj)[:, None], a, k)
    vnorm = torch.linalg.norm(v, dim=1, keepdim=True)
    v = torch.where(vnorm > 0, v / torch.clamp_min(vnorm, 1e-12), 0.0)
    return disp, v


@dataclasses.dataclass
class EnergyMaps:
    """Energy-node table attached to an energy-built ArrowSpace."""

    nodes: torch.Tensor           # [M, F] energy-node coordinates
    node_lambda: torch.Tensor     # [M]
    node_disp: torch.Tensor       # [M]
    node_dirichlet: torch.Tensor  # [M]
    node_centroid: torch.Tensor   # [M] int32 source-centroid id
    candidate_m: int


def build_energy_maps(items, ep: EnergyParams, gp: GraphParams, device=None
                      ) -> tuple[ArrowSpace, GraphLaplacian]:
    """Full energy-only build: (ArrowSpace with ``_energy_maps``, the
    energy graph's GraphLaplacian over the nodes)."""
    reset_phase_timings()
    arr = validate_items(items)
    dev = resolve_device(items, device)
    dtype = _pick_dtype(arr, dev)
    x = torch.as_tensor(arr).to(device=dev, dtype=dtype).contiguous()
    n, f = x.shape
    stored = unit_normalize(x) if gp.normalise else x

    with phase("energy_compress", dev):
        # Energy builds pass a fixed 0.35 reduction tolerance, not the graph
        # eps (reference src/lib.rs:358-359).
        k0 = (ep.optical_tokens if ep.optical_tokens is not None
              else select_k(n, 0, eps_hint=0.35))
        k0 = max(2, min(k0, n))
        red = reduce_corpus(stored, seed=gp.seed, k_clusters=k0)
        centroids, assignments = red.centroids, red.assignments
        # reduce_corpus clamps K to its sample: use the actual count.
        k0 = int(centroids.shape[0])
    msg = f"energy: compressed {n} items -> {k0} optical tokens"
    dbg_println(msg)
    log.debug(msg)

    with phase("energy_diffuse", dev):
        _, lap_c = _centroid_knn_graph(centroids, ep.neighbor_k)
        centroids = _diffuse(centroids, lap_c, ep.eta, ep.steps)

    with phase("energy_split", dev):
        disp, vdir = _member_stats(stored, centroids, assignments,
                                   ep.trim_quantile)
        thresh = torch.quantile(disp, 1.0 - ep.split_quantile)
        split = disp >= thresh
        off = ep.split_tau * torch.clamp_min(disp[:, None], 1e-12) * vdir
        src = torch.arange(k0, dtype=torch.int32, device=dev)
        nodes = torch.cat([centroids, (centroids + off)[split],
                           (centroids - off)[split]])
        node_src = torch.cat([src, src[split], src[split]])
    m = int(nodes.shape[0])
    dbg_println(f"energy: split {int(split.sum())} high-dispersion tokens "
                f"-> {m} graph nodes")

    with phase("energy_features", dev):
        w_f, lap_f, _ = build_feature_laplacian(nodes, k_f=gp.topk)
        e_nodes = rayleigh_batch(nodes, lap_f, normalized=False)
        g_nodes = dispersion_batch(nodes, w_f, e_nodes)
        e_items = rayleigh_batch(stored, lap_f, normalized=False)
        tau_star = derive_tau_star(e_items, gp.synthesis, gp.tau_fixed)
        g_items = dispersion_batch(stored, w_f, e_items)
        lam_items = synthesize(e_items, g_items, tau_star, TAU_MIX)
        lam_nodes = synthesize(e_nodes, g_nodes, tau_star, TAU_MIX)
        disp_nodes = disp[node_src.to(torch.int64)]

    with phase("energy_graph", dev):
        d_energy = (ep.w_lambda * torch.abs(lam_nodes[:, None]
                                            - lam_nodes[None, :])
                    + ep.w_disp * torch.abs(disp_nodes[:, None]
                                            - disp_nodes[None, :])
                    + ep.w_dirichlet * torch.abs(e_nodes[:, None]
                                                 - e_nodes[None, :]))
        d_energy = d_energy.masked_fill(
            torch.eye(m, dtype=torch.bool, device=dev), math.inf)
        kk = max(1, min(ep.neighbor_k, m - 1))
        nd, ni = torch.sort(d_energy, dim=1, stable=True)
        w_e = 1.0 / (1.0 + nd[:, :kk])
        nbr_idx, nbr_w, degrees, n_dropped = symmetrize_to_ell(
            ni[:, :kk].to(torch.int32), w_e, 2 * kk)
    gl_energy = GraphLaplacian._from_ell(nbr_idx, nbr_w, degrees, gp,
                                         n_dropped=int(n_dropped))

    emaps = EnergyMaps(nodes=nodes, node_lambda=lam_nodes,
                       node_disp=disp_nodes, node_dirichlet=e_nodes,
                       node_centroid=node_src, candidate_m=ep.candidate_m)
    aspace = ArrowSpace._from_build(
        data=stored, data_unit=unit_normalize(x), lambdas=lam_items,
        e_raw=e_items, lap_f=lap_f, w_f=w_f, tau_star=tau_star, params=gp,
        rayleigh_normalized=False, tau_mix=TAU_MIX,
        centroids=centroids, assignments=assignments)
    aspace._energy_maps = emaps
    return aspace, gl_energy
