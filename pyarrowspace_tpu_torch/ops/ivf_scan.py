"""Cluster-contiguous blocked IVF and certified serving (port of
pyarrowspace_tpu/ops/pallas/ivf_scan.py, everything but the Pallas call).

The corpus lies in a cluster-contiguous layout ([K, cap, F] slabs,
padded), and routing is per QUERY BLOCK:

  1. route: query -> centroid scores; queries are sorted (stably) by their
     top centroid so blocks are coherent;
  2. each block's probe list = its n_probe best clusters, by the blended
     score upper bound (bound-ordered, when the index carries the
     certification state) or by demand votes;
  3. the probe scan, kernel K6 (ops/cuda/ivf_scan.py), keeps each query's
     exact top-k over its block's probed slabs.

Certified serving adds a per-query exactness certificate: a query is
certified when no unprobed cluster's upper bound (unit-centroid covering
radius + lambda interval) beats its served kth score, so its served top-k
provably equals the exact float32 blended-scan top-k.  Over bf16 or f16
slabs the scan pools m_pool candidates, rescores them against the float32
corpus and certifies with a second, precision-robust condition.  Refusals
widen (doubled n_probe, still certified) and then escalate to the exact
scan (widen_refusals, escalate_uncertified).

Every ``lax.top_k`` of the reference is a stable descending sort here:
ties go to the smallest index, as they do in ``lax.top_k``.  Widening and
escalation batches pad to powers of two, as in the reference: queries
share probe lists by blocks, so the padding decides which queries share
a block, and with it each certificate.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .cuda.ivf_scan import NEG_INF, ivf_scan, slab_tiles
from .distance import unit_normalize
from .search import query_lambdas

_F32 = torch.float32
# Absolute slack of both certificates: absorbs the float32 summation-order
# drift between the routing matmul and the scan's dot (scores are O(1)).
CERT_SLACK = 1e-5
# Elements of the [chunk, cap, F] temporaries of the per-slab statistics,
# and of the [rows, m_pool, F] gather of the rescore.
_CHUNK_ELEMS = 2 ** 25
_RESCORE_CHUNK_ELEMS = 2 ** 27


class BlockedIVF(NamedTuple):
    centroids_unit: torch.Tensor   # [K, F] float32
    slabs: torch.Tensor            # [K * cap, F] cluster-contiguous, padded
    slab_lambdas: torch.Tensor     # [K * cap] float32 (+inf on padding)
    slab_ids: torch.Tensor         # [K * cap] int32 item ids (-1 padding)
    cap: int
    # Per-slab count of 64-row tiles up to its last real row (int32, the
    # probe scan walks only those; cuda/ivf_scan.py::slab_tiles).
    slab_tiles: torch.Tensor       # [K]
    # Certification state (None when built with certify=False): per-slab
    # covering radius around the unit centroid, lambda interval and
    # non-emptiness.
    radii: Optional[torch.Tensor] = None      # [K]
    lam_lo: Optional[torch.Tensor] = None     # [K]
    lam_hi: Optional[torch.Tensor] = None     # [K]
    nonempty: Optional[torch.Tensor] = None   # [K] bool
    # Per-slab max cast-residual norm max_x ||x - cast(x)|| (reduced-
    # precision slabs with certify=True only).
    res_eps: Optional[torch.Tensor] = None    # [K]

    @property
    def n_clusters(self) -> int:
        return int(self.slab_lambdas.shape[0] // self.cap)


def _topk_ids(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest per row, ties to the smallest index (the
    rule of ``lax.top_k``)."""
    return torch.sort(score, dim=-1, descending=True, stable=True).indices[
        ..., :k]


def slab_cap(n: int, k: int, capacity_factor: float = 2.0,
             min_cap: Optional[int] = None) -> int:
    """The slab capacity of n items in k clusters: max(8, ceil(
    capacity_factor * n / k)), at least min_cap, rounded up to 128 (the
    reference's layout)."""
    cap = max(8, int(np.ceil(capacity_factor * n / k)))
    if min_cap is not None:
        cap = max(cap, int(min_cap))
    return ((cap + 127) // 128) * 128


def unit_centroids(centroids: torch.Tensor) -> torch.Tensor:
    """float32 unit centroids (a zero centroid stays zero)."""
    cu = centroids.to(_F32)
    return cu / torch.clamp_min(torch.linalg.norm(cu, dim=1, keepdim=True),
                                1e-30)


def plan_slots(assign: np.ndarray, k: int, cap: int,
               overflow_candidates) -> np.ndarray:
    """The slab layout's slot table [k * cap] (int64 item id, -1 for a
    padded slot): each cluster's members in item order up to cap, then the
    items beyond their cluster's capacity spilled to the NEAREST cluster
    with free capacity (a host greedy over the free-slot table; candidates
    best first from ``overflow_candidates(ids) -> [len(ids), m]``), then to
    any free slot, so the layout is a PARTITION of the items."""
    n = assign.shape[0]
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    starts = np.searchsorted(sorted_assign, np.arange(k))
    rank = np.arange(n) - starts[sorted_assign]
    in_slab = rank < cap
    slot = np.full(k * cap, -1, dtype=np.int64)
    slot[sorted_assign[in_slab] * cap + rank[in_slab]] = order[in_slab]
    overflow = order[~in_slab]
    if overflow.size:
        free_per = cap - np.minimum(np.bincount(assign, minlength=k), cap)
        cand = np.asarray(overflow_candidates(overflow))
        m_cand = cand.shape[1]
        placed = np.zeros(overflow.size, dtype=bool)
        for m in range(m_cand):   # candidate rank, best first
            rem = np.flatnonzero(~placed)
            if rem.size == 0:
                break
            c_m = cand[rem, m]
            order_m = np.argsort(c_m, kind="stable")
            c_sorted = c_m[order_m]
            starts_m = np.searchsorted(c_sorted, np.arange(k))
            pos_in_c = np.arange(rem.size) - starts_m[c_sorted]
            take = pos_in_c < free_per[c_sorted]
            sel_items = rem[order_m[take]]
            sel_c = c_sorted[take]
            slot[sel_c * cap + (cap - free_per[sel_c])
                 + pos_in_c[take]] = overflow[sel_items]
            free_per -= np.bincount(sel_c, minlength=k)
            placed[sel_items] = True
        rest = overflow[~placed]
        if rest.size:
            free = np.flatnonzero(slot < 0)
            if free.size < rest.size:   # cap guarantees k * cap >= n
                raise AssertionError("slab capacity accounting violated")
            slot[free[: rest.size]] = rest
    return slot


def build_blocked_ivf(xu: torch.Tensor, lambdas: torch.Tensor,
                      centroids: torch.Tensor, assignments,
                      capacity_factor: float = 2.0, slab_dtype=None,
                      certify: bool = True,
                      min_cap: Optional[int] = None) -> BlockedIVF:
    """Reorder the corpus cluster-contiguously with per-cluster padding.

    Items beyond their cluster's capacity spill to the NEAREST cluster with
    free capacity (by unit-centroid similarity, 8 candidates each;
    plan_slots), so the slab layout is a PARTITION of the corpus.  cap is
    slab_cap(n, K, capacity_factor, min_cap).  slab_dtype (torch.bfloat16
    / torch.float16) stores the slabs in reduced precision, with the
    per-slab cast residuals the rescored certificate needs."""
    n = xu.shape[0]
    k = centroids.shape[0]
    dev = xu.device
    assign = torch.as_tensor(assignments).cpu().numpy().astype(np.int64)
    cap = slab_cap(n, k, capacity_factor, min_cap)
    cu = unit_centroids(centroids)
    m_cand = min(8, k)
    slot = plan_slots(assign, k, cap, lambda ov: _topk_ids(
        xu.to(_F32)[torch.as_tensor(ov, device=dev)] @ cu.T,
        m_cand).cpu().numpy())
    # Only the slot table crosses to the device; the reorder is a gather
    # there.  Padded slots hold a copy of row 0: the scan masks them by
    # id < 0, and their lambda +inf zeroes the proximity term.
    valid = torch.as_tensor(slot >= 0, device=dev)
    safe = torch.as_tensor(np.where(slot >= 0, slot, 0), device=dev)
    return blocked_from_slots(xu.to(_F32)[safe], lambdas.to(_F32)[safe],
                              slot, cu, cap, certify=certify,
                              slab_dtype=slab_dtype)


def blocked_from_slots(rows32: torch.Tensor, lam32: torch.Tensor,
                       slot: np.ndarray, cu: torch.Tensor, cap: int, *,
                       certify: bool = True, slab_dtype=None) -> BlockedIVF:
    """A BlockedIVF over the slots ``slot`` [K * cap] (item id or -1) of
    K = len(cu) clusters: ``rows32`` [K * cap, F] and ``lam32`` [K * cap]
    hold each slot's row and lambda in float32 (anything where the slot
    is padded), ``cu`` [K, F] the unit centroids."""
    k = cu.shape[0]
    dev = rows32.device
    valid = torch.as_tensor(slot >= 0, device=dev)
    slabs = rows32
    lam = torch.where(valid, lam32, torch.inf)
    radii = lam_lo = lam_hi = nonempty = res_eps = None
    if certify:
        radii, lam_lo, lam_hi, nonempty = _cert_state(slabs, lam, valid, cu,
                                                      k, cap)
    if slab_dtype is not None and slab_dtype != _F32:
        cast = slabs.to(slab_dtype)
        if certify:
            res_eps = _res_state(slabs, cast, valid, k, cap)
        slabs = cast
    ids = torch.as_tensor(np.where(slot >= 0, slot, -1).astype(np.int32),
                          device=dev)
    return BlockedIVF(cu, slabs, lam, ids, cap, slab_tiles(ids, cap),
                      radii=radii, lam_lo=lam_lo, lam_hi=lam_hi,
                      nonempty=nonempty, res_eps=res_eps)


def _cluster_chunks(k: int, cap: int, f: int):
    chunk = max(1, min(k, _CHUNK_ELEMS // max(1, cap * f)))
    return [(c0, min(k, c0 + chunk)) for c0 in range(0, k, chunk)]


def _cert_state(slabs, lam, valid, cu, k: int, cap: int):
    """Per-slab covering radius to the UNIT centroid (the anchor of the
    routing similarity), lambda interval and non-emptiness, over the slab
    layout (spilled items count for their adopting slab).  Chunked over
    clusters to bound the [chunk, cap, F] temporaries."""
    f = slabs.shape[1]
    s3 = slabs.view(k, cap, f)
    v2 = valid.view(k, cap)
    radii = torch.empty(k, dtype=_F32, device=slabs.device)
    for c0, c1 in _cluster_chunks(k, cap, f):
        d2 = torch.sum(torch.square(s3[c0:c1].to(_F32) - cu[c0:c1, None, :]),
                       dim=-1)
        radii[c0:c1] = torch.sqrt(torch.amax(torch.where(v2[c0:c1], d2, 0.0),
                                             dim=-1))
    lam2 = lam.view(k, cap)
    lam_lo = torch.amin(lam2, dim=1)                      # pads are +inf
    lam_hi = torch.amax(torch.where(v2, lam2, -torch.inf), dim=1)
    return radii, lam_lo, lam_hi, torch.any(v2, dim=1)


def _res_state(slabs32, cast, valid, k: int, cap: int):
    """Per-slab max cast-residual norm max_x ||x - cast(x)|| over real rows:
    the data side of the reduced-precision dot-error bound of the rescored
    certificate.  Chunked over clusters."""
    f = slabs32.shape[1]
    s3 = slabs32.view(k, cap, f)
    c3 = cast.view(k, cap, f)
    v2 = valid.view(k, cap)
    out = torch.empty(k, dtype=_F32, device=slabs32.device)
    for c0, c1 in _cluster_chunks(k, cap, f):
        r2 = torch.sum(torch.square(s3[c0:c1] - c3[c0:c1].to(_F32)), dim=-1)
        out[c0:c1] = torch.sqrt(torch.amax(torch.where(v2[c0:c1], r2, 0.0),
                                           dim=-1))
    return out


def cast_residual_worst(slab_dtype) -> float:
    """Worst-case ||x - cast(x)|| for a unit-norm row: per-element
    round-to-nearest error <= u |x_i| gives norm <= u ||x|| = u, the unit
    roundoff of the slab dtype."""
    if slab_dtype == _F32:
        return 0.0
    u = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}.get(slab_dtype)
    if u is None:
        raise ValueError(f"no dot-error model for slab dtype {slab_dtype}")
    return u


def scan_dot_eps(slab_dtype, f: int) -> float:
    """Sound bound on |dot(cast(q), cast(x)) - dot_f32(q, x)| for unit rows
    when BOTH operands are rounded to slab_dtype and summed in float32:
    (2u + u^2)(1 + u)^2 + 2 f 2^-24.  The worst-case both-sides model; the
    scan keeps queries float32, so the rescored certificate uses the
    tighter per-slab residuals (res_eps) instead."""
    u = cast_residual_worst(slab_dtype)
    if u == 0.0:
        return 0.0
    return (2.0 * u + u * u) * (1.0 + u) ** 2 + 2.0 * f * 2.0 ** -24


def _bound_matrix(sims, lamq, radii, lam_lo, lam_hi, nonempty, tau):
    """Sound per-(query, cluster) score upper bound [rows, K]: unit-vector
    triangle inequality around the unit centroid + lambda-interval
    proximity; empty clusters bound to -inf."""
    d_qc = torch.sqrt(torch.clamp_min(2.0 - 2.0 * sims, 0.0))
    cos_b = torch.clamp_max(
        1.0 - 0.5 * torch.square(torch.clamp_min(d_qc - radii[None, :], 0.0)),
        1.0)
    dl = torch.clamp_min(torch.maximum(lam_lo[None, :] - lamq[:, None],
                                       lamq[:, None] - lam_hi[None, :]), 0.0)
    bound = tau * cos_b + (1.0 - tau) * (1.0 / (1.0 + dl))
    return torch.where(nonempty[None, :], bound, -torch.inf)


def _block_reduce(x: torch.Tensor, qb: int, op) -> torch.Tensor:
    return op(x.view(x.shape[0] // qb, qb, -1), dim=1)


class Routed(NamedTuple):
    """The routing of one batch: queries and lambdas sorted by top
    centroid and padded to whole blocks, the permutation (order) and its
    inverse (inv), the probe table, and the [Q, K] bound matrix (None
    under demand-vote routing)."""
    qn_pad: torch.Tensor       # [Q_pad, F] float32
    lamq_pad: torch.Tensor     # [Q_pad] float32
    order: torch.Tensor        # [Q]
    inv: torch.Tensor          # [Q]
    probe_tbl: torch.Tensor    # [n_blocks, n_probe] int32
    bound: Optional[torch.Tensor]


def route(ivf: BlockedIVF, qn32, lamq32, tau, *, qb: int, n_probe: int,
          use_bound: bool) -> Routed:
    """Route a batch: sort queries stably by top centroid, cut blocks of
    qb, and give each block its n_probe clusters, by the block's largest
    blended-score upper bound (use_bound) or by demand votes."""
    q = qn32.shape[0]
    q_pad = -(-q // qb) * qb
    dev = qn32.device
    sims_c = qn32 @ ivf.centroids_unit.T                           # [Q, K]
    top1 = torch.argmax(sims_c, dim=1)
    order = torch.sort(top1, stable=True).indices
    inv = torch.sort(order, stable=True).indices
    lamq_sorted = lamq32[order]
    sims_sorted = sims_c[order]
    pad = q_pad - q

    def padded(x, value):
        if pad == 0:
            return x
        fill = torch.full((pad,) + tuple(x.shape[1:]), value,
                          dtype=x.dtype, device=dev)
        return torch.cat([x, fill])

    bound_sorted = None
    if use_bound:
        bound_sorted = _bound_matrix(sims_sorted, lamq_sorted, ivf.radii,
                                     ivf.lam_lo, ivf.lam_hi, ivf.nonempty,
                                     tau)
        block_bound = _block_reduce(padded(bound_sorted, -torch.inf), qb,
                                    torch.amax)
        # Saturated-tie break: clusters whose covering radius exceeds the
        # query distance all bound alike; a small centroid-similarity term
        # orders them by relevance.
        block_sims = _block_reduce(padded(sims_sorted, -1.0), qb, torch.amax)
        probe_tbl = _topk_ids(block_bound + 1e-4 * block_sims, n_probe)
    else:
        sims_pad = padded(sims_sorted, 0.0)
        n_k = sims_pad.shape[1]
        n_blocks = q_pad // qb
        # Demand votes: each real query nominates its top-2 clusters; the
        # remaining slots go to the highest summed routing scores.
        n_vote = min(2, n_k)
        top2 = _topk_ids(sims_pad, n_vote)
        valid_q = (torch.arange(q_pad, device=dev) < q).to(_F32)
        block_ids = (torch.arange(q_pad, device=dev) // qb)[:, None]
        # Votes are 0 / 1: their float sums are exact in any order, so the
        # atomics of index_add_ give the same bits on every run.
        votes = torch.zeros(n_blocks * n_k, dtype=_F32, device=dev)
        votes.index_add_(0, (block_ids * n_k + top2).reshape(-1),
                         valid_q[:, None].expand(-1, n_vote).reshape(-1))
        block_sims = _block_reduce(sims_pad, qb, torch.sum)
        lo, hi = block_sims.min(), block_sims.max()
        sims_01 = (block_sims - lo) / torch.clamp_min(hi - lo, 1e-9)
        probe_tbl = _topk_ids(votes.view(n_blocks, n_k) + 0.5 * sims_01,
                              n_probe)
    return Routed(padded(qn32[order], 0.0).contiguous(),
                  padded(lamq_sorted, 0.0).contiguous(), order, inv,
                  probe_tbl.to(torch.int32).contiguous(), bound_sorted)


def _route_scan_core(ivf: BlockedIVF, qn32, lamq32, tau, *, k: int, qb: int,
                     n_probe: int, use_bound: bool):
    """Routing + scan (kernel K6).  Returns, in routing-sorted query order,
    the scan's (ids [Q_pad, k], scores [Q_pad, k]), inv, order, the sorted
    lambdas, the probe table and the bound matrix."""
    r = route(ivf, qn32, lamq32, tau, qb=qb, n_probe=n_probe,
              use_bound=use_bound)
    s, i = ivf_scan(ivf.slabs, ivf.slab_lambdas, ivf.slab_ids, r.qn_pad,
                    r.lamq_pad, r.probe_tbl, float(tau), k=k, q_block=qb,
                    cap=ivf.cap, tiles=ivf.slab_tiles)
    return (i, s, r.inv, r.order, r.lamq_pad[:qn32.shape[0]], r.probe_tbl,
            r.bound)


def cert_violations(bound, kth_sorted, probe_tbl, margin, *, qb: int,
                    q: int):
    """Per-query bound violations (sorted order): True where some UNPROBED
    cluster's upper bound beats the query's kth served score, less margin
    (>= 0 refuses more) and the CERT_SLACK."""
    n_blocks = probe_tbl.shape[0]
    probed = torch.zeros((n_blocks, bound.shape[1]), dtype=torch.bool,
                         device=bound.device)
    probed.scatter_(1, probe_tbl.to(torch.int64), True)
    probed_q = probed[torch.arange(q, device=bound.device) // qb]
    limit = kth_sorted - _f32(margin) - _f32(CERT_SLACK)
    return torch.any((bound > limit[:, None]) & ~probed_q, dim=1)


def _f32(v) -> torch.Tensor:
    """A float32 scalar; on the host, so reading it never waits for the
    device."""
    return torch.tensor(float(v), dtype=_F32)


def _blocked_ivf(ivf, qn32, lamq32, tau, *, k, qb, n_probe):
    """Routing + scan, unsorted back to the caller's query order."""
    q = qn32.shape[0]
    i, s, inv, _, _, _, _ = _route_scan_core(
        ivf, qn32, lamq32, _f32(tau), k=k, qb=qb,
        n_probe=n_probe, use_bound=ivf.radii is not None)
    return i[:q][inv], s[:q][inv]


def _blocked_ivf_cert(ivf, qn32, lamq32, tau, margin, *, k, qb, n_probe):
    """Routing + scan + per-query exactness certificate over float32 slabs
    (bound-ordered routing)."""
    q = qn32.shape[0]
    i, s, inv, _, _, probe_tbl, bound = _route_scan_core(
        ivf, qn32, lamq32, _f32(tau), k=k, qb=qb,
        n_probe=n_probe, use_bound=True)
    viol = cert_violations(bound, s[:q, k - 1], probe_tbl, margin, qb=qb,
                           q=q)
    return i[:q][inv], s[:q][inv], (~viol)[inv]


def _rescore(xu_f32, lambdas_f32, ids, qn_sorted, lamq_sorted, tau):
    """float32 blended scores of the pooled candidates ids [q, m]
    (-3e38 where id < 0), a gather + batched dot chunked over queries."""
    q, m = ids.shape
    f = xu_f32.shape[1]
    step = max(1, _RESCORE_CHUNK_ELEMS // max(1, m * f))
    out = []
    for s0 in range(0, q, step):
        ids_c = ids[s0:s0 + step]
        safe = torch.clamp_min(ids_c, 0).to(torch.int64)
        cos = torch.einsum("qmf,qf->qm", xu_f32[safe], qn_sorted[s0:s0 + step])
        prox = 1.0 / (1.0 + torch.abs(lambdas_f32[safe]
                                      - lamq_sorted[s0:s0 + step, None]))
        s32 = tau * cos + (1.0 - tau) * prox
        out.append(torch.where(ids_c >= 0, s32, NEG_INF))
    return torch.cat(out)


def _blocked_ivf_cert_rescored(ivf, xu_f32, lambdas_f32, qn32, lamq32, tau,
                               res_eps, margin, *, k, m_pool, qb, n_probe):
    """Certified serving over reduced-precision slabs: scan a pool of
    m_pool, rescore it against the float32 corpus, cut the served top-k
    there, and certify with (A) the unprobed-cluster bound and (B) the
    pool condition: any probed item outside the pool has a scan score
    <= pool_min, so a true score <= pool_min + tau * (r + 2F 2^-24), r
    the largest cast residual of the block's probed slabs (queries stay
    float32 in the scan, so only the slab rounding enters)."""
    q = qn32.shape[0]
    dev = qn32.device
    tau_t = _f32(tau)
    i, s, inv, order, lamq_sorted, probe_tbl, bound = _route_scan_core(
        ivf, qn32, lamq32, tau_t, k=m_pool, qb=qb, n_probe=n_probe,
        use_bound=True)
    ids = i[:q]
    s32 = _rescore(xu_f32, lambdas_f32, ids, qn32[order], lamq_sorted,
                   tau_t)
    pos = _topk_ids(s32, k)
    vals = torch.gather(s32, 1, pos)
    idx_k = torch.gather(ids, 1, pos)
    kth = vals[:, k - 1]
    viol_a = cert_violations(bound, kth, probe_tbl, margin, qb=qb, q=q)
    f_dim = ivf.slabs.shape[1]
    r_blk = torch.amax(res_eps[probe_tbl.to(torch.int64)], dim=1)
    r_q = r_blk[torch.arange(q, device=dev) // qb]
    eps = tau_t * (r_q + _f32(2.0 * f_dim * 2.0 ** -24))
    pool_min = s[:q, m_pool - 1]
    viol_b = pool_min + eps > kth - _f32(margin) - _f32(CERT_SLACK)
    cert = ~(viol_a | viol_b)
    return idx_k[inv], vals[inv], cert[inv]


def pack_certified(idx, vals, cert) -> torch.Tensor:
    """One [Q, 2k + 1] float32 tensor (idx bit-cast, vals, cert as 0/1), so
    a certified result crosses to the host in one copy."""
    return torch.cat([idx.to(torch.int32).view(_F32), vals.to(_F32),
                      cert.to(_F32)[:, None]], dim=1)


def unpack_certified(packed, topk: int):
    """Host inverse of pack_certified: [Q, 2k + 1] float32 -> (idx [Q, k]
    int32, vals [Q, k] float32, cert [Q] bool).  k comes from the width
    (the served width may be clamped below topk, never above it)."""
    packed = (packed.cpu().numpy() if isinstance(packed, torch.Tensor)
              else np.asarray(packed))
    k = (packed.shape[1] - 1) // 2
    if k > topk:
        raise ValueError(f"packed width {packed.shape[1]} implies k={k} "
                         f"> requested topk={topk}")
    return packed[:, :k].view(np.int32), packed[:, k:2 * k], \
        packed[:, 2 * k] > 0.5


def q_block_for(q: int, q_block: int = 16) -> int:
    """Query-block width for a batch of q: q_block, or the next power of two
    of q when that is smaller (at least 8)."""
    return min(q_block, max(8, 1 << (q - 1).bit_length()))


def default_q_block(certify: bool, n_probe: int) -> int:
    """Default query-block width: 16, but 8 for certified serving at
    n_probe < 8, where a wide block dilutes each query's share of the
    block-shared probe list and the certification rate falls."""
    return 8 if (certify and n_probe < 8) else 16


def _res_eps_vector(ivf: BlockedIVF) -> torch.Tensor:
    """Per-slab cast-residual norms; an index without them falls back to
    the sound worst case u * ||x|| = u per slab."""
    if ivf.res_eps is not None:
        return ivf.res_eps
    return torch.full((ivf.n_clusters,), cast_residual_worst(ivf.slabs.dtype),
                      dtype=_F32, device=ivf.slabs.device)


def cert_pool_width(m_pool: Optional[int], topk: int, served_max: int) -> int:
    """Scan pool width of the rescored certificate: default
    max(4 topk, topk + 6), clamped to the served width cap * n_probe (a
    narrower served width refuses via widening)."""
    mp = max(4 * topk, topk + 6) if m_pool is None else int(m_pool)
    if mp < topk:
        raise ValueError(f"m_pool ({mp}) must be >= topk ({topk})")
    return max(1, min(mp, served_max))


def _check_certifiable(ivf: BlockedIVF, rescore_corpus,
                       rescore_lambdas) -> bool:
    """Whether certify needs the rescored path; raises when it cannot."""
    if ivf.radii is None:
        raise ValueError("certify=True needs an index built with "
                         "build_blocked_ivf(..., certify=True)")
    if ivf.slabs.dtype == _F32:
        return False
    if rescore_corpus is None or rescore_lambdas is None:
        raise ValueError(
            "certify=True over reduced-precision slabs needs "
            "rescore_corpus/rescore_lambdas (float32, original-id order) "
            "for the precision-robust certificate; pass them or rebuild "
            "with float32 slabs")
    return True


def blocked_ivf_search(ivf: BlockedIVF, qn, lam_q, tau, topk: int,
                       n_probe: int = 16, q_block: Optional[int] = None,
                       certify: bool = False, margin: float = 0.0,
                       rescore_corpus=None, rescore_lambdas=None,
                       m_pool: Optional[int] = None):
    """Blocked IVF top-k of unit queries qn [Q, F] with lambdas lam_q [Q]:
    (idx [Q, k] int32, scores [Q, k] float32), k = min(topk, cap *
    n_probe), plus a per-query exactness certificate [Q] bool when
    certify=True.  Certification over reduced-precision slabs needs
    rescore_corpus [N, F] / rescore_lambdas [N] (float32, by original id)
    and pools m_pool candidates (cert_pool_width)."""
    q = qn.shape[0]
    n_probe = max(1, min(n_probe, ivf.n_clusters))
    qb = q_block_for(q, default_q_block(certify, n_probe)
                     if q_block is None else q_block)
    k = max(1, min(topk, ivf.cap * n_probe))
    qn32 = qn.to(_F32)
    lamq32 = lam_q.to(_F32)
    if not certify:
        return _blocked_ivf(ivf, qn32, lamq32, tau, k=k, qb=qb,
                            n_probe=n_probe)
    if _check_certifiable(ivf, rescore_corpus, rescore_lambdas):
        mp = cert_pool_width(m_pool, topk, ivf.cap * n_probe)
        return _blocked_ivf_cert_rescored(
            ivf, rescore_corpus.to(_F32), rescore_lambdas.to(_F32), qn32,
            lamq32, tau, _res_eps_vector(ivf), margin, k=k, m_pool=mp, qb=qb,
            n_probe=n_probe)
    return _blocked_ivf_cert(ivf, qn32, lamq32, tau, margin, k=k, qb=qb,
                             n_probe=n_probe)


def blocked_ivf_search_fused(ivf: BlockedIVF, queries, lap_f, w_f, tau_star,
                             tau, topk: int, n_probe: int = 16,
                             q_block: Optional[int] = None,
                             rayleigh_normalized: bool = False,
                             tau_mix: Optional[float] = None,
                             certify: bool = False, margin: float = 0.0,
                             rescore_corpus=None, rescore_lambdas=None,
                             m_pool: Optional[int] = None,
                             pack_out: bool = False):
    """Blocked-IVF serving from raw queries: query-lambda synthesis (in
    float32, as the reference's fused serving program computes it), unit
    queries, then blocked_ivf_search.  pack_out=True (certify only)
    returns one packed [Q, 2k + 1] tensor (pack_certified)."""
    from ..spectral.taumode import TAU_MIX

    q32 = queries.to(_F32)
    lam_q = query_lambdas(q32, lap_f.to(_F32), w_f.to(_F32),
                          tau_star.to(_F32),
                          rayleigh_normalized=rayleigh_normalized,
                          tau_mix=TAU_MIX if tau_mix is None
                          else float(tau_mix))
    out = blocked_ivf_search(ivf, unit_normalize(q32), lam_q, tau, topk,
                             n_probe=n_probe, q_block=q_block,
                             certify=certify, margin=margin,
                             rescore_corpus=rescore_corpus,
                             rescore_lambdas=rescore_lambdas, m_pool=m_pool)
    return pack_certified(*out) if (pack_out and certify) else out


def widen_refusals(idx, vals, cert, run_certified, topk: int, n_probe: int,
                   n_probe_max: int):
    """Bound-ordered widening: re-serve certificate refusals at doubled
    n_probe (up to n_probe_max), splicing in rows whose OWN certificate
    holds at the wider probe list.  `run_certified(sel, n_probe)` returns
    certified ivf_block results (idx, vals, cert) for the query indices
    sel; each round's selection pads to the next power of two.  Returns
    (idx, vals, cert) with cert updated; the remaining refusals are the
    caller's to escalate."""
    idx = np.array(idx)
    vals = np.array(vals)
    cert = np.array(cert, dtype=bool)
    if idx.shape[1] < topk:
        # The served width was clamped below topk: nothing served is
        # usable, but widening raises the width with the probe list.
        cert = np.zeros_like(cert)
    np_cur = n_probe
    while np_cur * 2 <= n_probe_max:
        bad = np.flatnonzero(~cert)
        if bad.size == 0:
            break
        np_cur *= 2
        n_pad = 1 << int(bad.size - 1).bit_length()
        sel = np.concatenate([bad, np.full(n_pad - bad.size, bad[0])])
        i2, v2, c2 = run_certified(sel, np_cur)
        i2 = np.asarray(i2)[: bad.size]
        v2 = np.asarray(v2)[: bad.size]
        c2 = np.asarray(c2)[: bad.size].astype(bool)
        if i2.shape[1] < topk:
            continue   # still width-clamped; keep widening
        if idx.shape[1] < topk:
            idx = np.zeros((idx.shape[0], topk), dtype=i2.dtype)
            vals = np.zeros((vals.shape[0], topk), dtype=v2.dtype)
        hit = bad[c2]
        idx[hit] = i2[c2, :topk]
        vals[hit] = v2[c2, :topk]
        cert[hit] = True
    return idx, vals, cert


def escalate_uncertified(idx, vals, cert, run_exact, topk: int):
    """Splice exact results over certificate refusals (every query when
    the served width is below topk).  `run_exact(sel)` returns exact
    [len(sel), topk] results; the batch pads to the next power of two."""
    idx = np.array(idx)
    vals = np.array(vals)
    n_q = idx.shape[0]
    if idx.shape[1] < topk:
        bad = np.arange(n_q)
    else:
        bad = np.flatnonzero(~np.asarray(cert))
    if bad.size == 0:
        return idx, vals
    n_pad = 1 << int(bad.size - 1).bit_length()
    sel = np.concatenate([bad, np.full(n_pad - bad.size, bad[0])])
    ei, ev = run_exact(sel)
    ei = np.asarray(ei)[: bad.size]
    ev = np.asarray(ev)[: bad.size]
    if idx.shape[1] < topk:
        idx = np.zeros((n_q, topk), dtype=ei.dtype)
        vals = np.zeros((n_q, topk), dtype=ev.dtype)
    idx[bad] = ei
    vals[bad] = ev
    return idx, vals
