"""Query-time ranking (port of pyarrowspace_tpu/ops/search.py).

Lambda-aware ranking (reference TAUMODE.md:33, src/lib.rs:132-174):

  score(q, i) = tau * cos(q, x_i) + (1 - tau) / (1 + |lambda_i - lambda_q|)

with tau the blend control (tau = 1.0 -> pure cosine ranking); hybrid
ranking gates the cosine instead, cos * (tau + (1 - tau) * prox); energy
ranking has no cosine (see energy_topk).  Results are descending, ties to
the smallest id, or for a rescored pool to the pool position (a stable
sort: ``lax.top_k``'s rule; ``torch.topk`` promises no order among
ties).
"""

from __future__ import annotations

import torch

from .cuda import scan_energy, scan_int8, scan_topk
from .distance import unit_normalize
from .rayleigh import dispersion_batch, rayleigh_batch
from .subtile_scan import subtile_search
from ..spectral.taumode import synthesize
from ..utils.debug import span

# Gathers of [queries, pool, F] rows (the int8 rescore, gather IVF) are
# chunked by queries to about this many bytes, the JAX package's budget
# for its routed energy search.
GATHER_BYTES = 512 << 20


def lambda_aware_topk(xu: torch.Tensor, lambdas: torch.Tensor,
                      q: torch.Tensor, lam_q: torch.Tensor, tau,
                      topk: int):
    """Top-k by tau-blended cosine + lambda-proximity (single query);
    returns (idx [topk], vals [topk])."""
    qn = unit_normalize(q)
    cos = xu.to(qn.dtype) @ qn
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
    with span("search.query_lambda"):
        lam_q = query_lambdas(q_batch, lap_f, w_f, tau_star,
                              rayleigh_normalized=rayleigh_normalized,
                              tau_mix=tau_mix)
        qn = unit_normalize(q_batch)
    with span("search.scan"):
        return scan_topk.lambda_search(xu, lambdas, qn, lam_q, tau, topk)


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
    with span("search.query_lambda"):
        lam_q = query_lambdas(q_batch, lap_f, w_f, tau_star,
                              rayleigh_normalized=rayleigh_normalized,
                              tau_mix=tau_mix)
        qn = unit_normalize(q_batch.to(torch.float32))
    return subtile_search(xu_scan, xu_f32, lambdas_pad, qn,
                          lam_q.to(torch.float32), tau, n_real, topk=topk,
                          pool_m=2 * topk)


def rescore_candidates(xu: torch.Tensor, lambdas: torch.Tensor,
                       qn: torch.Tensor, lam_q: torch.Tensor, tau,
                       cand_idx: torch.Tensor, *, topk: int,
                       q_chunk: int | None = None):
    """Exact float32 rescore of a quantized scan's candidate pool
    cand_idx [Q, M]: the gathered corpus rows' cosines by batched
    products, in as few chunks of queries as keep a [chunk, M, F] gather
    within GATHER_BYTES (and within q_chunk queries, when given), then
    over all Q at once the blend, ids < 0 masked to -inf, and the top-k
    over pool positions by a stable sort.  tau stays a 0-dim CPU tensor:
    one made on the device from a Python number is a copy from pageable
    memory, which waits for the stream to drain the scan before it, so
    the launches after it would find the device idle.  Returns (idx [Q,
    topk] int32, scores [Q, topk] float32): the exact scan's whenever its
    top-k is in the pool."""
    f32 = torch.float32
    nq, m = cand_idx.shape
    if nq == 0:
        return (torch.empty((0, topk), dtype=torch.int32, device=xu.device),
                torch.empty((0, topk), dtype=f32, device=xu.device))
    fit = max(1, GATHER_BYTES // max(1, 4 * m * xu.shape[1]))
    q_chunk = fit if q_chunk is None else max(1, min(q_chunk, fit))
    xu32, qn32 = xu.to(f32), qn.to(f32)
    tau32 = torch.as_tensor(tau, dtype=f32)
    safe = torch.clamp_min(cand_idx, 0).to(torch.int64)
    cos = torch.cat([
        torch.bmm(xu32[safe[s:s + q_chunk]],
                  qn32[s:s + q_chunk, :, None])[:, :, 0]
        for s in range(0, nq, q_chunk)])
    prox = 1.0 / (1.0 + torch.abs(lambdas.to(f32)[safe]
                                  - lam_q.to(f32)[:, None]))
    sc = tau32 * cos + (1.0 - tau32) * prox
    sc = torch.where(cand_idx >= 0, sc, -torch.inf)
    vals, pos = torch.sort(sc, dim=1, descending=True, stable=True)
    return (torch.gather(cand_idx, 1, pos[:, :topk]).to(torch.int32),
            vals[:, :topk])


def fused_query_pipeline_quantized(
        xu: torch.Tensor, xq: torch.Tensor, scales: torch.Tensor,
        lambdas: torch.Tensor, lap_f: torch.Tensor, w_f: torch.Tensor,
        tau_star: torch.Tensor, q_batch: torch.Tensor, tau, *, topk: int,
        rescore_m: int, rayleigh_normalized: bool, tau_mix: float):
    """The int8 serving step: query lambda synthesis, the int8 candidate
    scan of a rescore_m pool (kernel K7 on CUDA, its plain version on CPU),
    and the exact float32 rescore of the pool."""
    with span("search.query_lambda"):
        lam_q = query_lambdas(q_batch, lap_f, w_f, tau_star,
                              rayleigh_normalized=rayleigh_normalized,
                              tau_mix=tau_mix)
        qn = unit_normalize(q_batch.to(torch.float32))
    with span("search.scan"):
        cand_idx, _ = scan_int8.lambda_search_quantized(
            xq, scales, lambdas, qn, lam_q, tau, rescore_m)
    with span("search.rescore"):
        return rescore_candidates(xu, lambdas, qn, lam_q, tau, cand_idx,
                                  topk=topk)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Low-precision (bf16 / f16) products accumulate in float32."""
    return (torch.float32 if dtype in (torch.bfloat16, torch.float16)
            else dtype)


def hybrid_topk(xu: torch.Tensor, lambdas: torch.Tensor, q: torch.Tensor,
                lam_q: torch.Tensor, tau, topk: int):
    """Hybrid ranking: score = cos * (tau + (1 - tau) * prox), the cosine
    gated by spectral proximity (tau = 1.0 is pure cosine).  The reference
    exposes search_lambda_aware_hybrid without documenting its formula
    (reference src/lib.rs:182-219); this gate is the JAX package's.
    Single query: returns (idx [topk], vals [topk])."""
    qn = unit_normalize(q)
    cos = xu.to(qn.dtype) @ qn
    prox = 1.0 / (1.0 + torch.abs(lambdas - lam_q))
    score = cos * (tau + (1.0 - tau) * prox)
    vals, idx = torch.sort(score, descending=True, stable=True)
    return idx[:topk], vals[:topk]


def hybrid_topk_batch(xu: torch.Tensor, lambdas: torch.Tensor,
                      q_batch: torch.Tensor, lam_q: torch.Tensor, tau,
                      topk: int):
    """Batched hybrid ranking: q_batch [Q, F], lam_q [Q] -> (idx [Q, topk]
    int32, vals [Q, topk]), queries in chunks as scan_plain takes them.  As
    in the JAX package, the queries are rounded to the corpus dtype and
    the products summed in _acc_dtype(xu.dtype)."""
    qn = unit_normalize(q_batch.to(_acc_dtype(q_batch.dtype)))
    acc = _acc_dtype(xu.dtype)
    xt = xu.to(acc).T
    step = max(1, scan_topk._PLAIN_CHUNK_ELEMS // max(xu.shape[0], 1))
    out_i, out_s = [], []
    for s in range(0, qn.shape[0], step):
        cos = qn[s:s + step].to(xu.dtype).to(acc) @ xt
        t = torch.as_tensor(tau, device=cos.device).to(cos.dtype)
        prox = 1.0 / (1.0 + torch.abs(
            lambdas.to(cos.dtype)[None, :]
            - lam_q[s:s + step].to(cos.dtype)[:, None]))
        score = cos * (t + (1.0 - t) * prox)
        vals, order = torch.sort(score, dim=1, descending=True, stable=True)
        out_i.append(order[:, :topk].to(torch.int32))
        out_s.append(vals[:, :topk])
    return torch.cat(out_i), torch.cat(out_s)


def bounded_energy(e: torch.Tensor, tau_star: torch.Tensor) -> torch.Tensor:
    """E' = e / (e + tau*), the taumode bounding (TAUMODE.md)."""
    ts = torch.clamp_min(tau_star, 1e-10)
    return e / (e + ts)


def energy_topk(x: torch.Tensor, lambdas: torch.Tensor, e_raw: torch.Tensor,
                lap_f: torch.Tensor, q: torch.Tensor, lam_q: torch.Tensor,
                e_q: torch.Tensor, tau_star: torch.Tensor, w_lambda,
                w_dirichlet, topk: int):
    """Energy-only ranking, no cosine (reference src/lib.rs:221-262):

        score(q, i) = w_lambda / (1 + |lambda_i - lambda_q|)
                    + w_dirichlet / (1 + D'(q, x_i))

    with D(q, x) = e_q + e_i - 2 q^T L_f x_i the residual Dirichlet energy
    (e the RAW energies x^T L_f x) and D' = D / (D + tau*).  The one energy
    formula of every path: exact, batched and routed.  Single query:
    returns (idx [topk], vals [topk])."""
    ts = torch.clamp_min(tau_star, 1e-10)
    qL = lap_f @ q
    cross = x @ qL
    d = torch.clamp_min(e_q + e_raw - 2.0 * cross, 0.0)
    db = d / (d + ts)
    prox_l = 1.0 / (1.0 + torch.abs(lambdas - lam_q))
    score = w_lambda * prox_l + w_dirichlet / (1.0 + db)
    vals, idx = torch.sort(score, descending=True, stable=True)
    return idx[:topk], vals[:topk]


def energy_topk_batch(x: torch.Tensor, lambdas: torch.Tensor,
                      e_raw: torch.Tensor, lap_f: torch.Tensor,
                      q_batch: torch.Tensor, lam_q: torch.Tensor,
                      e_q: torch.Tensor, tau_star: torch.Tensor, w_lambda,
                      w_dirichlet, topk: int):
    """Batched energy_topk: lam_q / e_q [Q] -> (idx [Q, k] int32,
    vals [Q, k]) with k = min(topk, N): kernel K8 over every item on CUDA,
    its plain version (queries in chunks as scan_plain takes them) on
    CPU."""
    return scan_energy.energy_scan(x, lambdas, e_raw, q_batch @ lap_f, lam_q,
                                   e_q, tau_star, w_lambda, w_dirichlet, topk)


def energy_route(ql: torch.Tensor, lam_q: torch.Tensor, e_q: torch.Tensor,
                 nodes: torch.Tensor, node_lambda: torch.Tensor,
                 node_e: torch.Tensor, node_centroid: torch.Tensor,
                 tau_star: torch.Tensor, route_counts: torch.Tensor, w_l,
                 w_d, *, probe: int):
    """The candidate-pool routing of the energy search (the reference's
    candidate_m pool routing, src/lib.rs:311-323), on the queries' device
    with no read back: the best ``probe`` energy nodes per query by
    w_l |lambda_node - lambda_q| + w_d D'(q, node) (a stable sort: ties to
    the lower node), their source centroids, and the shared tail.  ql [Q,
    F] = q L_f; route_counts [K + 1]: the items keyed to each centroid's
    bucket, then the tail's.  Returns (bitmap [Q, B] uint8: bit c set for
    each probed centroid c and for the tail, c = K; pool [Q] int64: the
    items the bitmap admits)."""
    nq = ql.shape[0]
    n_keys = route_counts.shape[0]
    ts = torch.clamp_min(tau_star, 1e-10)
    cross = ql @ nodes.T                                        # [Q, M]
    d_qn = torch.clamp_min(e_q[:, None] + node_e[None, :] - 2.0 * cross,
                           0.0)
    d_qn_b = d_qn / (d_qn + ts)
    d_nodes = (w_l * torch.abs(node_lambda[None, :] - lam_q[:, None])
               + w_d * d_qn_b)                                  # [Q, M]
    m_nodes = min(probe, d_nodes.shape[1])
    node_sel = torch.sort(d_nodes, dim=1, stable=True).indices[:, :m_nodes]
    hit = torch.zeros((nq, scan_energy.bitmap_bytes(n_keys) * 8),
                      dtype=torch.bool, device=ql.device)
    hit.scatter_(1, node_centroid.to(torch.int64)[node_sel], True)
    hit[:, n_keys - 1] = True
    pool = (hit[:, :n_keys] * route_counts.to(torch.int64)).sum(dim=1)
    weights = torch.pow(2, torch.arange(8, dtype=torch.int32,
                                        device=ql.device))
    bitmap = (hit.view(nq, -1, 8).to(torch.int32)
              * weights).sum(dim=2).to(torch.uint8)
    return bitmap, pool


def exact_where_short(bitmap: torch.Tensor, pool: torch.Tensor,
                      k: int) -> torch.Tensor:
    """The batch's bitmaps, or all ones (the exact energy scan) for every
    query when any query's pool holds fewer than k items: decided on the
    device, with no read back."""
    return torch.where(torch.any(pool < k), torch.full_like(bitmap, 0xFF),
                       bitmap)


def energy_routed_topk_batch(x: torch.Tensor, lambdas: torch.Tensor,
                             e_items: torch.Tensor, nodes: torch.Tensor,
                             node_lambda: torch.Tensor,
                             node_e: torch.Tensor,
                             node_centroid: torch.Tensor,
                             lap_f: torch.Tensor, tau_star: torch.Tensor,
                             route_keys: torch.Tensor,
                             route_counts: torch.Tensor,
                             q: torch.Tensor, lam_q: torch.Tensor,
                             e_q: torch.Tensor, w_l, w_d, *, probe: int,
                             topk: int):
    """Candidate-pool routed energy search: energy_route's pools scored
    with energy_topk's formula (kernel K8 on CUDA, its plain version on
    CPU).  route_keys [N] int32: each item's centroid where its bucket
    holds it, else K (the tail).  Returns (idx [Q, k] int32, -1 where the
    pool has no k-th item, vals [Q, k], -inf there) with k = min(topk, N),
    ties to the smaller id."""
    ql = q.to(lap_f.dtype) @ lap_f                              # [Q, F]
    bitmap, _ = energy_route(ql, lam_q, e_q, nodes, node_lambda, node_e,
                             node_centroid, tau_star, route_counts, w_l,
                             w_d, probe=probe)
    return scan_energy.energy_scan(x, lambdas, e_items, ql, lam_q, e_q,
                                   tau_star, w_l, w_d, topk, route_keys,
                                   bitmap)
