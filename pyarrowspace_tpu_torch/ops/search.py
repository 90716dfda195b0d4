"""Query-time ranking (port of pyarrowspace_tpu/ops/search.py).

Lambda-aware ranking (reference TAUMODE.md:33, src/lib.rs:132-174):

  score(q, i) = tau * cos(q, x_i) + (1 - tau) / (1 + |lambda_i - lambda_q|)

with tau the blend control (tau = 1.0 -> pure cosine ranking); hybrid
ranking gates the cosine instead, cos * (tau + (1 - tau) * prox); energy
ranking has no cosine (see energy_topk).  Results are descending, ties to
the smallest id or pool position (a stable sort: ``lax.top_k``'s rule;
``torch.topk`` promises no order among ties).
"""

from __future__ import annotations

import torch

from .cuda import scan_int8, scan_topk
from .distance import unit_normalize
from .rayleigh import dispersion_batch, rayleigh_batch
from .subtile_scan import subtile_search
from ..spectral.taumode import synthesize
from ..utils.debug import span

# Gathers of [queries, pool, F] rows (the int8 rescore, gather IVF, the
# routed energy search) are chunked by queries to about this many bytes,
# the JAX package's budget for the routed energy search.
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
                       q_chunk: int = 512):
    """Exact float32 rescore of a quantized scan's candidate pool
    cand_idx [Q, M]: gathered corpus rows, one batched product a chunk of
    at most q_chunk queries (fewer when [q_chunk, M, F] would pass
    GATHER_BYTES), the blend, ids < 0 masked to -inf, and the top-k over
    pool positions by a stable sort.  Returns (idx [Q, topk] int32,
    scores [Q, topk] float32): the exact scan's whenever its top-k is in
    the pool."""
    f32 = torch.float32
    q_chunk = max(1, min(q_chunk, GATHER_BYTES
                         // max(1, 4 * cand_idx.shape[1] * xu.shape[1])))
    xu32, lam32 = xu.to(f32), lambdas.to(f32)
    tau32 = torch.as_tensor(tau, dtype=f32, device=xu.device)
    out_i, out_s = [], []
    for s in range(0, cand_idx.shape[0], q_chunk):
        idx_c = cand_idx[s:s + q_chunk]
        safe = torch.clamp_min(idx_c, 0).to(torch.int64)
        qn_c = qn[s:s + q_chunk].to(f32)
        cos = torch.bmm(xu32[safe], qn_c[:, :, None])[:, :, 0]
        prox = 1.0 / (1.0 + torch.abs(lam32[safe]
                                      - lam_q[s:s + q_chunk].to(f32)[:, None]))
        sc = tau32 * cos + (1.0 - tau32) * prox
        sc = torch.where(idx_c >= 0, sc, -torch.inf)
        vals, pos = torch.sort(sc, dim=1, descending=True, stable=True)
        out_i.append(torch.gather(idx_c, 1, pos[:, :topk]).to(torch.int32))
        out_s.append(vals[:, :topk])
    if not out_i:
        return (torch.empty((0, topk), dtype=torch.int32, device=xu.device),
                torch.empty((0, topk), dtype=f32, device=xu.device))
    return torch.cat(out_i), torch.cat(out_s)


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
    """Batched energy_topk: lam_q / e_q [Q] -> (idx [Q, topk] int32,
    vals [Q, topk]), queries in chunks as scan_plain takes them."""
    ts = torch.clamp_min(tau_star, 1e-10)
    qL = q_batch @ lap_f
    step = max(1, scan_topk._PLAIN_CHUNK_ELEMS // max(x.shape[0], 1))
    out_i, out_s = [], []
    for s in range(0, qL.shape[0], step):
        cross = qL[s:s + step] @ x.T
        d = torch.clamp_min(e_q[s:s + step, None] + e_raw[None, :]
                            - 2.0 * cross, 0.0)
        db = d / (d + ts)
        prox_l = 1.0 / (1.0 + torch.abs(lambdas[None, :]
                                        - lam_q[s:s + step, None]))
        score = w_lambda * prox_l + w_dirichlet / (1.0 + db)
        vals, order = torch.sort(score, dim=1, descending=True, stable=True)
        out_i.append(order[:, :topk].to(torch.int32))
        out_s.append(vals[:, :topk])
    return torch.cat(out_i), torch.cat(out_s)


def energy_routed_topk_batch(x: torch.Tensor, lambdas: torch.Tensor,
                             e_items: torch.Tensor, nodes: torch.Tensor,
                             node_lambda: torch.Tensor,
                             node_e: torch.Tensor,
                             node_centroid: torch.Tensor,
                             lap_f: torch.Tensor, tau_star: torch.Tensor,
                             buckets: torch.Tensor, tail: torch.Tensor,
                             q: torch.Tensor, lam_q: torch.Tensor,
                             e_q: torch.Tensor, w_l, w_d, *, probe: int,
                             topk: int):
    """Candidate-pool routed energy search (the reference's candidate_m
    pool routing, src/lib.rs:311-323): the best ``probe`` energy nodes per
    query by w_l |lambda_node - lambda_q| + w_d D'(q, node), deduplicated
    to their first occurrence of each source centroid (a strictly lower
    triangular mask), and those centroids' bucket members plus the shared
    tail scored with energy_topk's formula.  Returns (idx [Q, k] int32,
    -1 where a score is not finite, vals [Q, k]) with k = min(topk, pool)."""
    nq = lam_q.shape[0]
    ts = torch.clamp_min(tau_star, 1e-10)
    qL = q.to(lap_f.dtype) @ lap_f                              # [Q, F]
    cross = qL @ nodes.T                                        # [Q, M]
    d_qn = torch.clamp_min(e_q[:, None] + node_e[None, :] - 2.0 * cross,
                           0.0)
    d_qn_b = d_qn / (d_qn + ts)
    d_nodes = (w_l * torch.abs(node_lambda[None, :] - lam_q[:, None])
               + w_d * d_qn_b)                                  # [Q, M]
    m_nodes = min(probe, d_nodes.shape[1])
    node_sel = torch.sort(d_nodes, dim=1, stable=True).indices[:, :m_nodes]
    cent_sel = node_centroid.to(torch.int64)[node_sel]          # [Q, P]
    earlier = torch.tril(torch.ones((m_nodes, m_nodes), dtype=torch.bool,
                                    device=q.device), diagonal=-1)
    dup = torch.any((cent_sel[:, :, None] == cent_sel[:, None, :])
                    & earlier[None], dim=2)                     # [Q, P]
    cand = torch.where(dup[:, :, None], -1, buckets[cent_sel].to(torch.int64))
    cand = torch.cat([cand.reshape(nq, -1),
                      tail.to(torch.int64)[None, :].expand(nq, -1)], dim=1)
    valid = cand >= 0
    safe = torch.clamp_min(cand, 0)
    xc = x[safe].to(qL.dtype)                                   # [Q, M, F]
    cross_i = torch.bmm(xc, qL[:, :, None])[:, :, 0]
    d_qa = torch.clamp_min(e_q[:, None] + e_items[safe] - 2.0 * cross_i, 0.0)
    d_qa_b = d_qa / (d_qa + ts)
    prox_l = 1.0 / (1.0 + torch.abs(lambdas[safe] - lam_q[:, None]))
    score = torch.where(valid, w_l * prox_l + w_d / (1.0 + d_qa_b),
                        -torch.inf)
    k = min(topk, score.shape[1])
    vals, pos = torch.sort(score, dim=1, descending=True, stable=True)
    vals = vals[:, :k]
    idx = torch.gather(cand, 1, pos[:, :k])
    idx = torch.where(torch.isfinite(vals), idx, -1).to(torch.int32)
    return idx, vals
