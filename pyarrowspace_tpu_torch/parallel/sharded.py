"""Multi-device sharded build and serving on ``torch.distributed`` (port of
pyarrowspace_tpu/parallel/sharded.py).

The JAX package drives every device from one process with ``shard_map``;
``torch.distributed`` is SPMD, one process per device.  So every public
function and method here is a collective: call it on every rank of the
mesh, with the same arguments, in the same order.  Every replicated result
(``lambdas()``, ``tau_star``, ``search_batch``'s ids and scores, the
GraphLaplacian, the centroids) is the same on every rank, bit for bit, as
the JAX package's ``out_specs=P()`` results are.

  * corpus rows shard across ranks; rank r holds rows [r L, (r + 1) L) of
    the zero-padded corpus (L = N_pad / d, N_pad a multiple of 128 d);
    ``ingest_sharded`` moves only those rows to the rank's device;
  * exact k-NN by a ring: the corpus blocks pass from rank to rank with
    ``batch_isend_irecv`` while each rank keeps its rows' running lists;
    each step is one seeded launch of kernel K1 over the visiting block
    (``ops/cuda/knn.knn_visit``), whose lexicographic (distance, id) merge
    makes the lists the one-device scan's bit for bit;
  * the symmetrize routes reverse edges to their column's owner with one
    ``all_to_all`` and exchanges fit flags twice (the one-device op's
    ranks and ties, so the graph is its bits); a capacity overflow routes
    the whole stage to the replicated one-device op, on the device;
  * the reduction stage clusters the sharded rows (never gathering the
    corpus onto one rank): sampled rows are gathered only for the
    TwoNN / K-search subsamples and the initial centroids; on the card
    Lloyd's sums are the one-device Lloyd's exact int64 fixed-point sums,
    so the centroids are one device's bit for bit at any world size (on
    the CPU, per-rank segment sums added in rank order);
  * the F x F column Gram is the rank-ordered sum of per-rank partials;
    tau* comes from the gathered energies;
  * serving: replicated query lambdas, a per-rank scan (K2 for "exact",
    K3 / K4b / K5 / K4a for "subtile", K6 for "ivf_block" and
    "certified"), then an ``all_gather`` of each rank's top-k and a
    stable merge; certificate violations are OR-ed across ranks.

Every cross-rank float sum is gathered and added in rank order on every
rank (``mesh.Comm.sum_ordered``).  At world size 1 every stage is the
one-device computation.

Divergences from the reference, kept on purpose:
  * the certified ladder's probe ceiling is bounded by n_probe << n_widen
    at every n_widen (the reference's ``_probe_ceiling`` leaves it
    unbounded at n_widen=0, sharded.py:871-880), as the one-device
    ``ArrowSpace._certified_finalize`` is;
  * subtile serving pads each rank's own rows to its 8,192-row layout (the
    reference re-pads the global corpus and reshards it), so no row moves
    between ranks; the result is the same exact routed top-k.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..core.laplacian import GraphLaplacian
from ..core.params import GraphParams, TauMode
from ..core.space import ArrowSpace, _WIDEN_MIN_CERT_RATE, \
    AUTO_SUBTILE_MIN_ITEMS
from ..graph.build import (BuildConfig, DEFAULT_BUILD_CONFIG, _pick_dtype,
                           symmetrize_auto_widen, validate_items)
from ..graph.feature import build_feature_laplacian, laplacian_from_sq_dists
from ..ops import ivf_scan as ivf_ops
from ..ops import search as search_ops
from ..ops.cuda import knn as knn_kernel
from ..ops.cuda import scan_topk
from ..ops.distance import kernel_weights, unit_normalize
from ..ops.rayleigh import dispersion_batch, rayleigh_batch
from ..ops.subtile_scan import build_subtile_state, subtile_search
from ..ops.symmetrize import (_lexsort_row_negw_col, _rank_sorted,
                              symmetrize_to_ell)
from ..reduction import pipeline as rp
from ..spectral.taumode import TAU_MIX, derive_tau_star, synthesize
from ..utils.debug import dbg_println, phase
from ..utils.logging import get_logger
from ..utils.stats import segment_sum
from .mesh import Comm, local_real, make_mesh

log = get_logger("sharded")

_INF = knn_kernel.INF_DIST
_ROW_BLOCK = 128       # shards are whole K1 row tiles
_NEG = -torch.inf

# Sharded symmetrize stages routed to the replicated one-device op by a
# bucket overflow, since import (or since the caller last reset it).
SYMMETRIZE_FALLBACKS = 0


# -- ingest ------------------------------------------------------------------
def ingest_sharded(arr, comm: Comm, dtype: torch.dtype,
                   block: int = _ROW_BLOCK) -> tuple[torch.Tensor, int]:
    """This rank's rows of the corpus (or of any per-row array): (x_loc
    [L, ...] on the rank's device, n_pad).  The rows pad with zeros to
    n_pad, a multiple of block * d, and rank r takes rows [r L, (r + 1) L).
    A host array (or a CPU tensor) is sliced on the host and only the slice
    moves to the device; a device tensor is sliced where it lies."""
    n = arr.shape[0]
    n_pad = -(-n // (block * comm.size)) * (block * comm.size)
    n_loc = n_pad // comm.size
    lo = comm.rank * n_loc
    hi = min(lo + n_loc, n)
    part = arr[lo:hi] if hi > lo else arr[:0]
    if not isinstance(part, torch.Tensor):
        part = torch.from_numpy(np.ascontiguousarray(part))
    x = part.to(device=comm.device, dtype=dtype)
    if x.shape[0] < n_loc:
        x = torch.cat([x, x.new_zeros((n_loc - x.shape[0],)
                                      + tuple(x.shape[1:]))])
    return x.contiguous(), n_pad


def gather_rows(comm: Comm, x_loc: torch.Tensor, ids: np.ndarray
                ) -> torch.Tensor:
    """Rows ``ids`` (global row ids, any order) of the sharded rows x_loc,
    on every rank, in the order of ids: each rank contributes the rows it
    owns; one gather."""
    n_loc = x_loc.shape[0]
    ids = np.asarray(ids, dtype=np.int64)
    owner = ids // n_loc
    mine = np.flatnonzero(owner == comm.rank)
    sel = torch.as_tensor(ids[mine] - comm.rank * n_loc, device=x_loc.device)
    parts = comm.all_gather_ragged(x_loc[sel])
    out = x_loc.new_empty((ids.shape[0], x_loc.shape[1]))
    for r, part in enumerate(parts):
        where = torch.as_tensor(np.flatnonzero(owner == r),
                                device=x_loc.device)
        out[where] = part
    return out


# -- ring k-NN ---------------------------------------------------------------
def ring_knn(comm: Comm, xu_loc: torch.Tensor, k: int, eps: float,
             n_real: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact eps/k-NN lists of this rank's rows over the whole corpus:
    (dist [L, k], idx [L, k] int32), ascending by (distance, id), missing
    entries (2.0, -1), padding rows empty.  Step s scans the block of
    rank (r + s) mod d, seeded with the lists so far, while the block for
    step s + 1 is on its way (double buffered)."""
    n_loc = xu_loc.shape[0]
    my, d = comm.rank, comm.size
    rows = local_real(n_real, my * n_loc, n_loc)
    dist = torch.full((n_loc, k), _INF, dtype=xu_loc.dtype,
                      device=xu_loc.device)
    idx = torch.full((n_loc, k), -1, dtype=torch.int32, device=xu_loc.device)
    if rows:
        dd, ii = knn_kernel.knn_visit(xu_loc, n_loc, rows, rows, k, eps,
                                      row_id0=my * n_loc,
                                      col_id0=my * n_loc)
        dist[:rows], idx[:rows] = dd, ii
    if d == 1:
        return dist, idx
    # Two buffers [local rows; visiting block]: a step scans one while the
    # next block arrives in the other.
    bufs = [torch.cat([xu_loc, xu_loc]) for _ in range(2)]
    works = comm.ring_shift(xu_loc, bufs[1][n_loc:])
    for s in range(1, d):
        for w in works:
            w.wait()
        cur = bufs[s % 2]
        works = (comm.ring_shift(cur[n_loc:], bufs[(s + 1) % 2][n_loc:])
                 if s + 1 < d else [])
        src = (my + s) % d
        cols = local_real(n_real, src * n_loc, n_loc)
        if rows and cols:
            dd, ii = knn_kernel.knn_visit(
                cur, n_loc, rows, cols, k, eps, row_id0=my * n_loc,
                col_id0=src * n_loc, seed=(dist[:rows].contiguous(),
                                           idx[:rows].contiguous()))
            dist[:rows], idx[:rows] = dd, ii
    return dist, idx


# -- symmetrize ----------------------------------------------------------------
def _union_width_bound(comm: Comm, idx_loc: torch.Tensor, n_pad: int) -> int:
    """The one-device ``union_width_bound`` over the sharded lists: fwd
    counts per own row plus a global in-degree histogram (an exact integer
    all-reduce), maxed across ranks."""
    valid = idx_loc >= 0
    hist = torch.bincount(idx_loc[valid].to(torch.int64), minlength=n_pad)
    hist = comm.sum_exact(hist)
    n_loc = idx_loc.shape[0]
    lo = comm.rank * n_loc
    own = valid.sum(dim=1) + hist[lo:lo + n_loc]
    return comm.max_int(int(own.max()) if own.numel() else 0)


def _symmetrize_local(comm: Comm, idx_l: torch.Tensor, w_l: torch.Tensor, *,
                      m: int, cap: int, n_real: int):
    """This rank's rows of the symmetrized ELL graph (the JAX package's
    ``_symmetrize_local``), or None after a bucket overflow on any rank.

    Entry space: [0, Lk) forward edges; [Lk, 2Lk) diagonal reverse copies
    (column owned here); [2Lk, 2Lk + d cap) reverse copies received over
    the all_to_all.  Returns (nbr_idx [L, m], nbr_w [L, m], n_dropped) or
    (None, overflow)."""
    n_dev, my = comm.size, comm.rank
    big_l, k = idx_l.shape
    dev = idx_l.device
    base = my * big_l
    lk = big_l * k
    row_g = base + torch.arange(big_l, device=dev)
    idx64 = idx_l.to(torch.int64)
    valid_f = (idx64 >= 0) & (row_g[:, None] < n_real)
    col_f = torch.where(valid_f, idx64, -1).reshape(-1)
    w_f = w_l.reshape(-1)
    orow_f = row_g[:, None].expand(big_l, k).reshape(-1)
    vf = valid_f.reshape(-1)

    # Phase 1: route the reverse copies to their column's owner.
    dest = torch.where(vf, torch.div(col_f, big_l, rounding_mode="floor"),
                       n_dev)
    is_diag = vf & (dest == my)
    off = vf & (dest != my) & (dest < n_dev)
    dkey = torch.where(off, dest, n_dev)
    eid_s = torch.sort(-w_f, stable=True).indices
    eid_s = eid_s[torch.sort(dkey[eid_s], stable=True).indices]
    dkey_s = dkey[eid_s]
    in_bucket = dkey_s < n_dev
    brank = _rank_sorted(dkey_s, in_bucket)
    keep = in_bucket & (brank < cap)
    overflow = comm.sum_int(int((in_bucket & ~keep).sum()))
    if overflow:
        return None, overflow
    slot = torch.where(keep, dkey_s * cap + brank, n_dev * cap)

    def scatter_slots(vals, fill):
        buf = torch.full((n_dev * cap + 1,), fill, dtype=vals.dtype,
                         device=dev)
        buf[slot] = torch.where(keep, vals, fill)
        return buf[:n_dev * cap]

    send_col = scatter_slots(col_f[eid_s], -1)
    send_orow = scatter_slots(orow_f[eid_s], -1)
    send_w = scatter_slots(w_f[eid_s], 0.0)
    send_eid = scatter_slots(eid_s, -1)          # stays local
    sent_slot = torch.full((lk + 1,), n_dev * cap, dtype=torch.int64,
                           device=dev)
    sent_slot[torch.where(keep, eid_s, lk)] = slot
    sent_slot = sent_slot[:lk]

    recv_col = comm.all_to_all(send_col)
    recv_orow = comm.all_to_all(send_orow)
    recv_w = comm.all_to_all(send_w)
    vr = recv_col >= 0

    def mutual_of(dest_col, origin_row, valid):
        """(origin -> dest) is mutual iff origin is in dest's own list;
        returns (mutual, partner slot)."""
        c_loc = torch.clamp(torch.where(valid, dest_col - base, 0), 0,
                            big_l - 1)
        eq = idx64[c_loc] == origin_row[:, None]
        return valid & eq.any(dim=1), torch.argmax(eq.to(torch.uint8), dim=1)

    mut_d, pslot_d = mutual_of(col_f, orow_f, is_diag)
    mut_r, pslot_r = mutual_of(recv_col, recv_orow, vr)
    cand_d = is_diag & ~mut_d
    cand_r = vr & ~mut_r

    # Phase 2: one local sort over every candidate entry.
    rows_all = torch.cat([torch.where(vf, orow_f - base, big_l),
                          torch.where(cand_d, col_f - base, big_l),
                          torch.where(cand_r, recv_col - base, big_l)])
    cols_all = torch.cat([col_f, orow_f, recv_orow])
    w_all = torch.cat([w_f, w_f, recv_w])
    e2 = _lexsort_row_negw_col(rows_all, -w_all, cols_all)
    r2, c2, w2 = rows_all[e2], cols_all[e2], w_all[e2]
    in_row = r2 < big_l
    fits_sorted = in_row & (_rank_sorted(r2, in_row) < m)
    fits = torch.empty_like(fits_sorted)
    fits[e2] = fits_sorted
    fits_fwd, fits_diag, fits_recv = fits[:lk], fits[lk:2 * lk], \
        fits[2 * lk:]

    # Phase 3: exchange the fit flags (receiver -> origin: the partner's
    # flag; origin -> receiver: the forward edge's own).
    fits_fwd_2d = fits_fwd.reshape(big_l, k)
    c_loc_r = torch.clamp(torch.where(vr, recv_col - base, 0), 0, big_l - 1)
    resp = torch.where(mut_r, fits_fwd_2d[c_loc_r, pslot_r], fits_recv)
    resp_back = comm.all_to_all(resp.to(torch.uint8)) > 0
    pad1 = torch.zeros(1, dtype=torch.bool, device=dev)
    fwd_fit_send = torch.cat([fits_fwd, pad1])[
        torch.where(send_eid >= 0, send_eid, lk)]
    fwd_fit_recv = comm.all_to_all(fwd_fit_send.to(torch.uint8)) > 0

    # Phase 4: survival, counting, placement.
    partner_routed = torch.cat([resp_back, pad1])[sent_slot]
    c_loc_d = torch.clamp(torch.where(is_diag, col_f - base, 0), 0,
                          big_l - 1)
    partner_diag = torch.where(mut_d, fits_fwd_2d[c_loc_d, pslot_d],
                               fits_diag)
    partner = torch.where(is_diag, partner_diag, partner_routed)
    surv_fwd = vf & fits_fwd & partner
    surv_diag = cand_d & fits_diag & fits_fwd
    surv_recv = cand_r & fits_recv & fwd_fit_recv
    dropped = comm.sum_int(int((vf & ~surv_fwd).sum()
                               + (cand_d & ~surv_diag).sum()
                               + (cand_r & ~surv_recv).sum()))
    surv_sorted = torch.cat([surv_fwd, surv_diag, surv_recv])[e2]
    pos2 = _rank_sorted(r2, surv_sorted)
    flat = torch.where(surv_sorted, r2 * m + pos2, big_l * m)
    nbr_idx = torch.full((big_l * m + 1,), -1, dtype=torch.int32, device=dev)
    nbr_w = torch.zeros((big_l * m + 1,), dtype=w_l.dtype, device=dev)
    nbr_idx[flat] = torch.where(surv_sorted, c2, -1).to(torch.int32)
    nbr_w[flat] = torch.where(surv_sorted, w2, 0.0)
    return (nbr_idx[:big_l * m].reshape(big_l, m),
            nbr_w[:big_l * m].reshape(big_l, m), dropped)


def sharded_symmetrize(comm: Comm, idx_loc: torch.Tensor,
                       w_loc: torch.Tensor, ell_width: int, n_real: int):
    """Sharded symmetrize-to-ELL, bit for bit ``ops.symmetrize_to_ell`` on
    the whole graph: (nbr_idx [n_real, m], nbr_w, degrees, n_dropped),
    replicated on every rank.  Each rank sorts about (2 + 4)·(Lk) entries
    instead of 2Nk.  An off-diagonal bucket holds 4 L k / d entries; if
    one overflows on any rank (a pathological column concentration), the
    stage gathers the lists and runs the replicated one-device op instead
    of dropping entries (counted in SYMMETRIZE_FALLBACKS)."""
    global SYMMETRIZE_FALLBACKS
    big_l, k = idx_loc.shape
    cap = max(k, int(np.ceil(4.0 * big_l * k / max(comm.size, 1))))
    res = _symmetrize_local(comm, idx_loc, w_loc, m=ell_width, cap=cap,
                            n_real=n_real)
    if res[0] is None:
        SYMMETRIZE_FALLBACKS += 1
        dbg_println(f"sharded symmetrize: bucket overflow ({res[1]} "
                    "entries) -> replicated one-device op")
        i_all = comm.all_gather_cat(idx_loc)[:n_real]
        w_all = comm.all_gather_cat(w_loc)[:n_real]
        return symmetrize_to_ell(i_all, w_all, ell_width)
    nbr_idx, nbr_w, dropped = res
    nbr_idx = comm.all_gather_cat(nbr_idx)[:n_real]
    nbr_w = comm.all_gather_cat(nbr_w)[:n_real]
    return nbr_idx, nbr_w, nbr_w.sum(dim=1), dropped


# -- reduction, Gram, lambdas ----------------------------------------------------
def _owned(comm: Comm, ids: np.ndarray, n_loc: int) -> np.ndarray:
    """The local row numbers of the sorted global ids this rank owns."""
    lo = comm.rank * n_loc
    return ids[(ids >= lo) & (ids < lo + n_loc)] - lo


def _sharded_assign(x_loc: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return rp._assign_argmin(x_loc, c) if x_loc.shape[0] else \
        torch.empty(0, dtype=torch.int32, device=x_loc.device)


def _sharded_lloyd(comm: Comm, xs_loc: torch.Tensor, c: torch.Tensor,
                   n_iters: int, n_keep: int) -> torch.Tensor:
    """Lloyd's K-means over the sharded sample of n_keep rows, counts
    summed exactly, empty clusters keeping their centroid.  On the card the
    sums are the one-device Lloyd's exact int64 fixed-point sums at the
    same scale (the sample's largest magnitude, maxed across ranks),
    summed exactly across ranks: the one-device centroids bit for bit.  On
    the CPU, per-rank segment sums added in rank order."""
    k = c.shape[0]
    exact = xs_loc.device.type == "cuda"
    if exact:
        local_max = xs_loc.abs().max() if xs_loc.numel() else \
            xs_loc.new_zeros(())
        scale = rp.fixed_point_scale(
            float(torch.stack(comm.all_gather(local_max.reshape(1))).max()),
            n_keep)
    for _ in range(n_iters):
        a = _sharded_assign(xs_loc, c).to(torch.int64)
        cnts = comm.sum_exact(torch.bincount(a, minlength=k))
        if exact:
            sums = comm.sum_exact(rp.fixed_point_sums(xs_loc, a, k, scale))
            c = rp.centroids_from_sums(sums, cnts, c, scale)
            continue
        sums = comm.sum_ordered(segment_sum(xs_loc, a, k))
        cnts = cnts.to(c.dtype)
        c = torch.where(cnts[:, None] > 0,
                        sums / torch.clamp_min(cnts[:, None], 1.0), c)
    return c


def sharded_reduce(comm: Comm, x_loc: torch.Tensor, n_real: int, *,
                   seed: int = 42, keep_rate: float = rp.SAMPLING_KEEP_RATE,
                   n_iters: int = 12, eps_hint: Optional[float] = None):
    """``reduction.reduce_corpus`` over sharded rows: the same sample,
    subsamples, K and initial centroids (the same numpy draws), Lloyd on
    the sharded sample.  Returns (centroids [K, F] replicated, assignments
    of this rank's real rows [L_real] int32)."""
    n_loc = x_loc.shape[0]
    rows = local_real(n_real, comm.rank * n_loc, n_loc)
    rng = np.random.default_rng(seed)
    n_keep = max(2, int(round(n_real * keep_rate)))
    sel = np.sort(rng.choice(n_real, size=n_keep, replace=False))
    xs_loc = x_loc[torch.as_tensor(_owned(comm, sel, n_loc),
                                   device=x_loc.device)]
    dbg_println(f"reduction: raw-input saved; sampled {n_keep}/{n_real} "
                f"(keep_rate={keep_rate})")

    # TwoNN and the K search on gathered subsamples (the same draws).
    sub_rng = np.random.default_rng(seed)
    twonn = (sel[sub_rng.choice(n_keep, size=2048, replace=False)]
             if n_keep > 2048 else sel)
    mlm = rp._twonn_ratio(gather_rows(comm, x_loc, twonn))
    idim = 1 if mlm <= 1e-9 else max(1, int(round(1.0 / mlm)))
    lo, hi = rp.k_search_range(n_keep, idim, eps_hint)
    lo, hi = min(lo, n_keep), min(hi, n_keep)
    if os.environ.get("ARROWSPACE_K_SEARCH", "1") == "0" or hi <= lo:
        k = lo
    else:
        krng = np.random.default_rng(seed)
        pick = (np.sort(krng.choice(n_keep, size=4096, replace=False))
                if n_keep > 4096 else np.arange(n_keep))
        sub = gather_rows(comm, x_loc, sel[pick])
        cands = list(range(lo, hi + 1))
        scores = [rp._kmeans_bic(sub, kk, seed) for kk in cands]
        k = cands[int(np.argmin(scores))]
    k = min(k, n_keep)
    dbg_println(f"reduction: clustering K={k}")
    init = gather_rows(comm, x_loc, sel[rng.choice(n_keep, size=k,
                                                   replace=False)])
    centroids = _sharded_lloyd(comm, xs_loc, init, n_iters, n_keep)
    return centroids, _sharded_assign(x_loc[:rows], centroids)


def sharded_col_sq_dists(comm: Comm, x_loc: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances between feature columns [F, F] from
    the rank-ordered sum of per-rank partial Grams (zero padding rows add
    nothing)."""
    gram = comm.sum_ordered(x_loc.T @ x_loc)
    sq = torch.diagonal(gram)
    return torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * gram, 0.0)


def sharded_lambdas(comm: Comm, x_loc: torch.Tensor, lap_f: torch.Tensor,
                    w_f: torch.Tensor, *, n_real: int,
                    rayleigh_normalized: bool, tau_mix: float,
                    synthesis: TauMode = TauMode.MEDIAN,
                    tau_fixed: Optional[float] = None):
    """Rank-local Rayleigh / dispersion over the real rows (the products
    of the one-device build's shape at world 1; padding rows get 0), tau*
    from the gathered energies of the real rows (``derive_tau_star`` on
    them, every synthesis mode).  Returns (lambdas_loc, e_loc, e_un_loc,
    tau_star)."""
    n_loc = x_loc.shape[0]
    xr = x_loc[:local_real(n_real, comm.rank * n_loc, n_loc)]

    def padded(v):
        return torch.cat([v, v.new_zeros(n_loc - v.shape[0])])

    e_un = rayleigh_batch(xr, lap_f, normalized=False)
    e = (rayleigh_batch(xr, lap_f, normalized=True)
         if rayleigh_normalized else e_un)
    g = padded(dispersion_batch(xr, w_f, e_un))
    e_un, e = padded(e_un), padded(e)
    tau_star = derive_tau_star(comm.all_gather_cat(e)[:n_real], synthesis,
                               tau_fixed)
    return synthesize(e, g, tau_star, tau_mix), e, e_un, tau_star


# -- serving -------------------------------------------------------------------
def _merge_topk(comm: Comm, idx: torch.Tensor, vals: torch.Tensor,
                topk: int):
    """Every rank's [Q, topk] candidates gathered in rank order and cut to
    the top-k by a stable descending sort (ties to the earlier rank, then
    the earlier position: lax.top_k's rule on the concatenation)."""
    all_v = torch.cat(comm.all_gather(vals.contiguous()), dim=1)
    all_i = torch.cat(comm.all_gather(idx.to(torch.int32).contiguous()),
                      dim=1)
    fv, pos = torch.sort(all_v, dim=1, descending=True, stable=True)
    return torch.gather(all_i, 1, pos[:, :topk]), fv[:, :topk]


def _pad_candidates(idx, vals, topk: int):
    """Widen a rank's [Q, j <= topk] list to topk with (-1, -inf)."""
    q, j = idx.shape
    if j == topk:
        return idx, vals
    return (torch.cat([idx.to(torch.int32), torch.full(
                (q, topk - j), -1, dtype=torch.int32, device=idx.device)],
                dim=1),
            torch.cat([vals, torch.full((q, topk - j), _NEG,
                                        dtype=vals.dtype,
                                        device=vals.device)], dim=1))


class ShardedArrowSpace:
    """Multi-device ArrowSpace: row-sharded corpus + replicated spectral
    state.  Serving (``search_batch`` and the hybrid / energy batches,
    ``serving_stream``) and ``to_local`` back to a one-device ArrowSpace.
    Every method is a collective (module docstring)."""

    def __init__(self, mesh, xu_loc, stored_loc, lambdas_loc, e_loc, lap_f,
                 w_f, tau_star, params: GraphParams, n_real: int,
                 tau_mix: float = TAU_MIX, rayleigh_normalized: bool = False,
                 centroids=None, assignments=None, e_un_loc=None,
                 ivf_cap_plan=None, ivf_cap_factor=None, knn=None,
                 comm: Optional[Comm] = None):
        self.mesh = mesh
        self.comm = comm or Comm(mesh)
        self._xu_loc = xu_loc
        self._stored_loc = stored_loc
        self._lambdas_loc = lambdas_loc
        self._e_loc = e_loc
        # RAW x^T L x energies when e_loc holds normalized quotients; None
        # means e_loc IS raw.
        self._e_un_loc = e_un_loc
        self._lap_f = lap_f
        self._w_f = w_f
        self._tau_star = tau_star
        self._params = params
        self._n_real = n_real
        self._tau_mix = tau_mix
        self._rayleigh_normalized = rayleigh_normalized
        self._centroids = centroids        # replicated
        self._assignments = assignments    # replicated, [n_real]
        self._ivf_cap_plan = ivf_cap_plan
        self._ivf_cap_factor = ivf_cap_factor
        # This rank's k-NN lists of the build ([L, k]), when it built them.
        self.knn = knn
        self._subtile: Optional[dict] = None
        # This rank's clusters of the blocked-IVF layout (global item ids).
        self._ivf_shard: Optional[ivf_ops.BlockedIVF] = None

    @property
    def _n_loc(self) -> int:
        return int(self._xu_loc.shape[0])

    @property
    def _lo(self) -> int:
        return self.comm.rank * self._n_loc

    @property
    def _rows(self) -> int:
        """This rank's real rows."""
        return local_real(self._n_real, self._lo, self._n_loc)

    @property
    def device(self) -> torch.device:
        return self.comm.device

    @classmethod
    def from_local(cls, aspace: ArrowSpace, gl=None, mesh=None
                   ) -> "ShardedArrowSpace":
        """Shard a one-device ArrowSpace (built, or loaded with
        io.load_index, on every rank) across a mesh: each rank keeps its
        rows on its device — the build-once / serve-sharded path."""
        del gl
        mesh = mesh or make_mesh()
        comm = Comm(mesh)

        def shard(t):
            return ingest_sharded(t, comm, t.dtype)[0]

        def rep(t):
            return None if t is None else t.to(comm.device)

        return cls(mesh, shard(aspace._data_unit), shard(aspace._data),
                   shard(aspace._lambdas), shard(aspace._e_raw),
                   rep(aspace._lap_f), rep(aspace._w_f),
                   rep(aspace._tau_star), aspace._params, aspace.nitems,
                   tau_mix=aspace._tau_mix,
                   rayleigh_normalized=aspace._rayleigh_normalized,
                   centroids=rep(aspace._centroids),
                   assignments=rep(aspace._assignments),
                   e_un_loc=(shard(aspace._energies_raw())
                             if aspace._rayleigh_normalized else None),
                   ivf_cap_plan=aspace._ivf_cap_plan,
                   ivf_cap_factor=aspace._ivf_cap_factor, comm=comm)

    def _gather(self, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        if t is None:
            return None
        return self.comm.all_gather_cat(t)[:self._n_real]

    def to_local(self) -> ArrowSpace:
        """A one-device ArrowSpace on every rank (gathers the shards)."""
        out = ArrowSpace._from_build(
            data=self._gather(self._stored_loc),
            data_unit=self._gather(self._xu_loc),
            lambdas=self._gather(self._lambdas_loc),
            e_raw=self._gather(self._e_loc),
            e_un=self._gather(self._e_un_loc),
            lap_f=self._lap_f, w_f=self._w_f, tau_star=self._tau_star,
            params=self._params,
            rayleigh_normalized=self._rayleigh_normalized,
            tau_mix=self._tau_mix, centroids=self._centroids,
            assignments=self._assignments)
        out._ivf_cap_plan = self._ivf_cap_plan
        out._ivf_cap_factor = self._ivf_cap_factor
        return out

    @property
    def nitems(self) -> int:
        return self._n_real

    @property
    def nfeatures(self) -> int:
        return int(self._stored_loc.shape[1])

    def lambdas(self) -> np.ndarray:
        return self._gather(self._lambdas_loc).cpu().numpy().astype(
            np.float64)

    @property
    def tau_star(self) -> float:
        return float(self._tau_star)

    def _queries(self, queries) -> torch.Tensor:
        q = torch.as_tensor(queries).to(device=self.device,
                                        dtype=self._stored_loc.dtype)
        if q.dim() != 2 or q.shape[1] != self.nfeatures:
            raise ValueError(f"queries must be [Q, {self.nfeatures}], got "
                             f"{tuple(q.shape)}")
        return q

    def prepare_queries(self, queries) -> torch.Tensor:
        """Synthetic lambdas of a query batch (replicated)."""
        return search_ops.query_lambdas(
            self._queries(queries), self._lap_f, self._w_f, self._tau_star,
            rayleigh_normalized=self._rayleigh_normalized,
            tau_mix=self._tau_mix)

    def _topk(self, topk) -> int:
        return min(self._params.topk if topk is None else int(topk),
                   self._n_real)

    # -- exact and hybrid -------------------------------------------------------
    def _exact(self, q: torch.Tensor, tau, topk: int):
        """Per-rank K2 over the real rows, then the merge."""
        lam_q = self.prepare_queries(q)
        rows = self._rows
        if rows:
            tau_arg = (float(tau) if self.device.type == "cuda"
                       else torch.as_tensor(tau, dtype=q.dtype))
            idx, vals = scan_topk.lambda_search(
                self._xu_loc[:rows], self._lambdas_loc[:rows],
                unit_normalize(q), lam_q, tau_arg, min(topk, rows))
            idx = idx + self._lo
        else:
            idx = torch.empty((q.shape[0], 0), dtype=torch.int32,
                              device=self.device)
            vals = torch.empty((q.shape[0], 0), dtype=q.dtype,
                               device=self.device)
        return _merge_topk(self.comm, *_pad_candidates(idx, vals, topk), topk)

    def search_hybrid_batch(self, queries, tau: float,
                            topk: Optional[int] = None):
        """Sharded hybrid (multiplicative-gate) serving: the one-device
        search_hybrid_batch's results."""
        q = self._queries(queries)
        topk = self._topk(topk)
        lam_q = self.prepare_queries(q)
        rows = self._rows
        idx, vals = search_ops.hybrid_topk_batch(
            self._xu_loc[:rows], self._lambdas_loc[:rows], q, lam_q,
            torch.as_tensor(tau, dtype=q.dtype), min(topk, rows))
        idx, vals = _merge_topk(self.comm, *_pad_candidates(
            idx + self._lo, vals, topk), topk)
        return idx.cpu().numpy(), vals.cpu().numpy()

    def search_energy_batch(self, queries, k: int,
                            w_lambda: Optional[float] = None,
                            w_dirichlet: Optional[float] = None):
        """Sharded energy-only serving (the exact bounded-energy scan of
        ``ops/search.energy_topk_batch`` per rank, then the merge): the
        one-device results on a standard-built space."""
        q = self._queries(queries)
        w_l = 1.0 if w_lambda is None else float(w_lambda)
        w_d = 0.5 if w_dirichlet is None else float(w_dirichlet)
        k_eff = min(int(k), self._n_real)
        e_q = rayleigh_batch(q, self._lap_f, normalized=False)
        lam_q = self.prepare_queries(q)
        rows = self._rows
        e_items = (self._e_un_loc if self._e_un_loc is not None
                   else self._e_loc)
        dt = q.dtype
        idx, vals = search_ops.energy_topk_batch(
            self._stored_loc[:rows], self._lambdas_loc[:rows],
            e_items[:rows], self._lap_f, q, lam_q, e_q, self._tau_star,
            torch.as_tensor(w_l, dtype=dt), torch.as_tensor(w_d, dtype=dt),
            min(k_eff, rows))
        idx, vals = _merge_topk(self.comm, *_pad_candidates(
            idx + self._lo, vals, k_eff), k_eff)
        return idx.cpu().numpy(), vals.cpu().numpy()

    # -- subtile -----------------------------------------------------------------
    def _ensure_subtile_state(self) -> dict:
        """This rank's rows in the padded subtile layout (a multiple of
        8,192 rows, bf16 scan copy + float32 rescore copy)."""
        if self._subtile is None:
            self._subtile = build_subtile_state(
                self._xu_loc[:self._rows].to(torch.float32),
                self._lambdas_loc[:self._rows].to(torch.float32))
        return self._subtile

    def _subtile_search(self, q: torch.Tensor, tau, topk: int):
        lam_q = self.prepare_queries(q).to(torch.float32)
        if not self._rows:                  # a shard of padding rows only
            empty = torch.empty((q.shape[0], 0), device=self.device)
            return _merge_topk(self.comm, *_pad_candidates(
                empty.to(torch.int32), empty, topk), topk)
        st = self._ensure_subtile_state()
        qn = unit_normalize(q.to(torch.float32))
        idx, vals = subtile_search(st["xu_scan"], st["xu_f32"],
                                   st["lambdas"], qn, lam_q, float(tau),
                                   st["n_real"], topk=topk, pool_m=2 * topk)
        idx = torch.where(idx < st["n_real"], idx + self._lo, -1)
        vals = torch.where(idx >= 0, vals, _NEG)
        return _merge_topk(self.comm, idx, vals, topk)

    # -- blocked IVF -------------------------------------------------------------
    def _ensure_ivf_block_state(self) -> ivf_ops.BlockedIVF:
        """The cluster-partitioned blocked-IVF layout: the centroids pad to
        a multiple of d, the global slot table (the one-device layout of
        ``build_blocked_ivf``) is planned on every rank from the gathered
        assignments, and each rank receives the rows of its contiguous
        cluster range with one all_to_all."""
        if self._ivf_shard is not None:
            return self._ivf_shard
        if self._centroids is None or self._assignments is None:
            raise ValueError(
                "ivf_block needs centroids/assignments; build with the "
                "reduction stage or call enable_ivf() on the local space "
                "before from_local")
        comm, dev = self.comm, self.device
        d, n, n_loc, lo = comm.size, self._n_real, self._n_loc, self._lo
        cents = self._centroids
        k = cents.shape[0]
        k_pad = -(-k // d) * d
        if k_pad > k:
            cents = torch.cat([cents, cents.new_zeros((k_pad - k,
                                                       cents.shape[1]))])
        cap = ivf_ops.slab_cap(n, k_pad, self._ivf_cap_factor or 2.0,
                               self._ivf_cap_plan)
        cu = ivf_ops.unit_centroids(cents)
        assign = self._assignments.cpu().numpy().astype(np.int64)
        xu32 = self._xu_loc.to(torch.float32)
        m_cand = min(8, k_pad)

        def candidates(overflow: np.ndarray) -> np.ndarray:
            mine = np.flatnonzero((overflow >= lo) & (overflow < lo + n_loc))
            sims = xu32[torch.as_tensor(overflow[mine] - lo, device=dev)] \
                @ cu.T
            own = ivf_ops._topk_ids(sims, m_cand).to(torch.int64)
            parts = comm.all_gather_ragged(own)
            out = np.empty((overflow.size, m_cand), dtype=np.int64)
            for r, part in enumerate(parts):
                out[np.flatnonzero((overflow >= r * n_loc)
                                   & (overflow < (r + 1) * n_loc))] = \
                    part.cpu().numpy()
            return out

        slot = ivf_ops.plan_slots(assign, k_pad, cap, candidates)
        k_loc = k_pad // d
        per = k_loc * cap
        # Each rank sends every other rank the rows (and lambdas) of its
        # own items in that rank's slots, in slot order.
        packed = torch.cat([xu32, self._lambdas_loc.to(torch.float32)[:,
                            None]], dim=1)
        owner = np.where(slot >= 0, slot // n_loc, -1)
        counts = np.array([[np.count_nonzero(owner[t * per:(t + 1) * per]
                                             == r) for t in range(d)]
                           for r in range(d)])          # [src, dst]
        width = max(1, int(counts.max()))
        send = packed.new_zeros((d * width, packed.shape[1]))
        for t in range(d):
            dst_slots = slot[t * per:(t + 1) * per]
            mine = dst_slots[owner[t * per:(t + 1) * per] == comm.rank]
            send[t * width:t * width + mine.size] = packed[
                torch.as_tensor(mine - lo, device=dev)]
        recv = comm.all_to_all(send)
        my_slots = slot[comm.rank * per:(comm.rank + 1) * per]
        my_owner = owner[comm.rank * per:(comm.rank + 1) * per]
        rows = packed.new_zeros((per, packed.shape[1]))
        for r in range(d):
            at = np.flatnonzero(my_owner == r)
            rows[torch.as_tensor(at, device=dev)] = \
                recv[r * width:r * width + at.size]
        ivf = ivf_ops.blocked_from_slots(
            rows[:, :-1].contiguous(), rows[:, -1].contiguous(), my_slots,
            cu[comm.rank * k_loc:(comm.rank + 1) * k_loc].contiguous(), cap)
        self._ivf_shard = ivf
        return ivf

    def _ivf_block(self, q: torch.Tensor, tau, topk: int, n_probe: int,
                   certify: bool, margin: float = 0.0):
        """Per-rank routing over the rank's own clusters and K6 over its
        n_probe best, then the merge; with certify, each rank checks its
        unprobed clusters' bounds against the MERGED kth and the
        violations are OR-ed across ranks (sound: the slabs partition the
        corpus).  Returns (idx, vals[, cert]) as tensors."""
        ivf = self._ensure_ivf_block_state()
        n_q = q.shape[0]
        qb = ivf_ops.q_block_for(n_q, ivf_ops.default_q_block(certify,
                                                              n_probe))
        lam_q = self.prepare_queries(q).to(torch.float32)
        qn = unit_normalize(q.to(torch.float32))
        tau32 = ivf_ops._f32(tau)
        i_s, s_s, inv, order, _, probe_tbl, bound = ivf_ops._route_scan_core(
            ivf, qn, lam_q, tau32, k=topk, qb=qb,
            n_probe=min(n_probe, ivf.n_clusters), use_bound=True)
        fi, fv = _merge_topk(self.comm, i_s[:n_q][inv], s_s[:n_q][inv], topk)
        if not certify:
            return fi, fv
        viol = ivf_ops.cert_violations(bound, fv[:, topk - 1][order],
                                       probe_tbl, margin, qb=qb, q=n_q)
        viol_any = self.comm.sum_exact(viol[inv].to(torch.int32)) > 0
        return fi, fv, ~viol_any

    def _probe_ceiling(self, n_probe: int, n_widen: int) -> int:
        """The widening ladder's n_probe ceiling, per shard (n_probe counts
        each shard's own clusters): the shard's cluster count, the shard's
        items over twice the cap, and n_probe << n_widen (at n_widen=0:
        no widening; the reference leaves that bound out, module
        docstring)."""
        return min(self._structural_ceiling(), n_probe << n_widen)

    def _structural_ceiling(self) -> int:
        ivf = self._ensure_ivf_block_state()
        d = self.comm.size
        return min(ivf.n_clusters,
                   max(1, (self._n_real // d) // max(1, 2 * ivf.cap)))

    def _certified_finalize(self, queries: torch.Tensor, out, tau,
                            topk: int, n_probe: int, n_widen: int,
                            margin: float = 0.0):
        """Widen, then escalate, a certified ivf_block result to exact
        results (the one-device ladder; widening skipped below
        _WIDEN_MIN_CERT_RATE).  Returns (idx, vals, base_cert_rate)."""
        idx, vals, cert = (o.cpu().numpy() for o in out)
        rate0 = float(cert.mean()) if cert.size else 1.0

        def take(sel):
            return queries[torch.as_tensor(sel, device=queries.device)]

        if rate0 >= _WIDEN_MIN_CERT_RATE:
            idx, vals, cert = ivf_ops.widen_refusals(
                idx, vals, cert,
                lambda sel, np2: tuple(o.cpu().numpy() for o in
                                       self._ivf_block(take(sel), tau, topk,
                                                       np2, True, margin)),
                topk, n_probe, self._probe_ceiling(n_probe, n_widen))
        idx, vals = ivf_ops.escalate_uncertified(
            idx, vals, cert,
            lambda sel: tuple(o.cpu().numpy() for o in
                              self._exact(take(sel), tau, topk)), topk)
        return idx, vals, rate0

    def search_batch(self, queries, tau: float, topk: Optional[int] = None,
                     mode: str = "exact", n_probe: int = 16,
                     certify: bool = False, margin: float = 0.0,
                     n_widen: int = 2):
        """(indices [Q, topk], scores [Q, topk]) over the whole corpus,
        replicated on every rank.

        mode "exact": K2 over each rank's rows; "subtile": the per-rank
        routed scan (K3, K4b, K5, K4a; exact at its bf16 scan dtype,
        float32-rescored); "auto": subtile when each SHARD holds at least
        AUTO_SUBTILE_MIN_ITEMS items, else exact; "ivf_block"
        (approximate): each rank probes its n_probe best local clusters
        with K6, and certify=True adds the per-query certificate;
        "certified": exact results at IVF cost, refusals re-probed at
        doubled n_probe (up to n_widen rounds) and the rest escalated to
        the exact scan."""
        if mode not in ("auto", "exact", "subtile", "ivf_block",
                        "certified"):
            raise ValueError(f"unknown search mode {mode!r}; expected "
                             "'auto', 'exact', 'subtile', 'ivf_block', "
                             "or 'certified'")
        if certify and mode != "ivf_block":
            raise ValueError("certify=True requires mode='ivf_block'")
        q = self._queries(queries)
        topk = self._topk(topk)
        if mode == "certified":
            out = self._ivf_block(q, tau, topk, n_probe, True, margin)
            idx, vals, _ = self._certified_finalize(q, out, tau, topk,
                                                    n_probe, n_widen, margin)
            return idx, vals
        if mode == "auto":
            per_shard = self._n_real // max(1, self.comm.size)
            mode = ("subtile" if per_shard >= AUTO_SUBTILE_MIN_ITEMS
                    else "exact")
        if mode == "ivf_block":
            out = self._ivf_block(q, tau, topk, n_probe, certify, margin)
            return tuple(o.cpu().numpy() for o in out)
        if mode == "subtile":
            idx, vals = self._subtile_search(q, tau, topk)
        else:
            idx, vals = self._exact(q, tau, topk)
        return idx.cpu().numpy(), vals.cpu().numpy()

    def serving_stream(self, tau: float, topk: Optional[int] = None,
                       n_probe: int = 8, n_widen: int = 2,
                       depth: int = 4, cert_floor: float = 0.35,
                       floor_patience: int = 2,
                       fallback_mode: Optional[str] = "auto",
                       margin: float = 0.0, probe_escalations: int = 2):
        """Pipelined sharded certified serving (serving.CertifiedStream):
        per-batch results equal search_batch(mode="certified"); on a
        certificate collapse n_probe doubles (up to probe_escalations
        rungs, within the shard's cluster ceiling), then later batches go
        to fallback_mode.  Every rank submits the same batches."""
        from ..serving import CertifiedStream

        topk_eff = self._topk(topk)
        self._ensure_ivf_block_state()
        state = {"n_probe": int(n_probe),
                 "rungs": max(0, int(probe_escalations))}

        def dispatch(queries):
            q = self._queries(queries)
            np_cur = state["n_probe"]
            return q, self._ivf_block(q, tau, topk_eff, np_cur, True,
                                      margin), np_cur

        def finalize(_queries, boxed):
            q, out, np_used = boxed
            return self._certified_finalize(q, out, tau, topk_eff, np_used,
                                            n_widen, margin)

        def on_collapse() -> bool:
            np_cur = state["n_probe"]
            np_max = self._structural_ceiling()
            if state["rungs"] <= 0 or np_cur >= np_max:
                return False
            state["rungs"] -= 1
            state["n_probe"] = min(2 * np_cur, np_max)
            log.warning("sharded certification collapsed at n_probe=%d: "
                        "escalating the probe list to n_probe=%d (%d "
                        "rung(s) left) before any fallback", np_cur,
                        state["n_probe"], state["rungs"])
            return True

        fb = fb_fin = None
        if fallback_mode is not None:
            if fallback_mode not in ("auto", "exact"):
                raise ValueError("fallback_mode must be 'auto', 'exact', "
                                 f"or None, got {fallback_mode!r}")

            def fb(queries):
                return self.search_batch(queries, tau, topk=topk_eff,
                                         mode=fallback_mode)

            def fb_fin(_queries, out):
                return out

        return CertifiedStream(dispatch, finalize, fallback=fb,
                               finalize_fallback=fb_fin, depth=depth,
                               cert_floor=cert_floor,
                               floor_patience=floor_patience,
                               on_collapse=on_collapse)


# -- the build -------------------------------------------------------------------
def build_sharded(items, gp: GraphParams, mesh=None,
                  config: BuildConfig = DEFAULT_BUILD_CONFIG
                  ) -> tuple[ShardedArrowSpace, GraphLaplacian]:
    """Multi-device standard build, called on every rank with the same
    items (each rank moves only its rows to its device).  The k-NN lists
    and the graph equal the one-device build's bit for bit at any world
    size; tau* for every synthesis mode, the Gram and the lambdas follow
    the one-device arithmetic, and the reduction stage's rank-ordered sums
    differ from one device's in the last bits at d > 1.  Returns
    (ShardedArrowSpace, GraphLaplacian), the graph replicated."""
    mesh = mesh or make_mesh()
    comm = Comm(mesh)
    dev = comm.device
    arr = validate_items(items)
    dtype = _pick_dtype(arr, dev)
    n, f = arr.shape
    with phase("sharded_ingest", dev):
        x_loc, n_pad = ingest_sharded(arr, comm, dtype)
    xu_loc = unit_normalize(x_loc).contiguous()
    stored_loc = xu_loc if gp.normalise else x_loc
    k_eff = max(1, min(gp.k, n - 1)) if n > 1 else 1

    with phase("sharded_knn", dev):
        d_loc, i_loc = ring_knn(comm, xu_loc, k_eff, gp.eps, n)
        if k_eff < gp.k:
            pad = gp.k - k_eff
            d_loc = torch.nn.functional.pad(d_loc, (0, pad), value=_INF)
            i_loc = torch.nn.functional.pad(i_loc, (0, pad), value=-1)
        d_loc = d_loc.to(dtype)

    with phase("sharded_symmetrize", dev):
        w_loc = kernel_weights(d_loc, gp.sigma_resolved, gp.p)
        w_loc = torch.where(i_loc >= 0, w_loc, 0.0)
        nbr_idx, nbr_w, degrees, n_dropped = symmetrize_auto_widen(
            lambda width: sharded_symmetrize(comm, i_loc, w_loc, width, n),
            config, gp, n=n, weight_itemsize=w_loc.element_size(),
            width_bound_fn=lambda: _union_width_bound(comm, i_loc, n_pad))
    gl = GraphLaplacian._from_ell(nbr_idx, nbr_w, degrees, gp,
                                  n_dropped=int(n_dropped))

    centroids = assignments = None
    if gp.dims_reduction and n >= config.reduction_min_n:
        with phase("sharded_reduction", dev):
            keep = (config.sampling_rate if config.sampling_rate is not None
                    else rp.SAMPLING_KEEP_RATE)
            centroids, a_loc = sharded_reduce(
                comm, stored_loc, n, seed=gp.seed, keep_rate=keep,
                eps_hint=gp.eps)
            assignments = torch.cat(comm.all_gather_ragged(a_loc))

    with phase("sharded_feature_laplacian", dev):
        k_f = config.feature_k if config.feature_k is not None else gp.topk
        if centroids is not None:
            w_f, lap_f, _ = build_feature_laplacian(
                centroids, k_f=k_f,
                sigma_scale=float(np.clip(gp.eps / 10.0, 0.25, 4.0)))
        else:
            w_f, lap_f, _ = laplacian_from_sq_dists(
                sharded_col_sq_dists(comm, stored_loc), k_f=k_f)

    tau_mix = TAU_MIX if config.tau_mix is None else config.tau_mix
    with phase("sharded_lambdas", dev):
        lam_loc, e_loc, e_un_loc, tau_star = sharded_lambdas(
            comm, stored_loc, lap_f, w_f, n_real=n,
            rayleigh_normalized=config.rayleigh_normalized,
            tau_mix=tau_mix, synthesis=gp.synthesis, tau_fixed=gp.tau_fixed)

    dbg_println(f"sharded build: n={n} over {comm.size} ranks, "
                f"tau_star={float(tau_star):.6g}")
    sspace = ShardedArrowSpace(
        mesh, xu_loc, stored_loc, lam_loc, e_loc, lap_f, w_f, tau_star, gp,
        n, tau_mix, rayleigh_normalized=config.rayleigh_normalized,
        centroids=centroids, assignments=assignments,
        e_un_loc=e_un_loc if config.rayleigh_normalized else None,
        knn=(d_loc, i_loc), comm=comm)
    return sspace, gl
