"""The numbers that decide ``correct``: what the timed path produced, held
against the plain reference (perfbench/reference/), each number against
its limit in the cell's ``perfbench/limits/<cell>.json``.

Build cells hold the last build of the window to the reference:
  knn_dist_gap  widest gap between the program's and the reference's
                ascending k-NN distances, position by position, on the
                checked rows (every row, or whole 128-row blocks drawn
                from the seed with the last block always among them)
  knn_id_gap    widest gap between the reference's distance to each id the
                program listed and the reference's distance at that place
                (2.0 for an id that is the row itself, repeated or out of
                range)
  ell_gap       on sampled checked rows of the ELL Laplacian: 1.0 where
                the columns differ from the union graph of the program's
                lists, else the widest weight gap (a row's reverse edges
                come from every row's list, held to the reference only
                where that row is checked)
  lambda_gap    widest gap between the program's and the reference's lambda
                over every item
Serve cells hold sampled answers of the window to the reference:
  bad_ids       ids out of range, repeated in a list, or rows not answered
  score_gap     widest gap between a served score and the reference's score
                of the served id
  rank_gap      widest amount by which the reference's score of the id
                served at place j lies below the reference's j-th best
  recall        mean share of the reference's top-k among the served ids

The reference works out the index state again from the inputs, which the
benchmark remakes from the seed.  Two parts follow the program's own
output, to judge it: the ELL rows expected from the program's lists (the
lists themselves are held to the reference on their own rows first), and
the ELL's row width.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np

from harness.corpus import SAMPLE_STREAM, stream_seed
from reference.graph import INF_DIST, ell_rows, knn_rows
from reference.serve import scores as ref_scores, topk

BIG = 1e30   # stands for a gap that is not a finite number


@contextlib.contextmanager
def tf32(torch, enabled: bool):
    """Float32 products in TF32 (``enabled``) or in full float32 inside the
    block; the flags are restored after it."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def finite(v: float) -> float:
    v = float(v)
    return v if math.isfinite(v) else BIG


def sample_rows(n: int, count: int, seed: int) -> np.ndarray:
    """``count`` distinct rows of n, sorted, drawn from the run's seed."""
    rng = np.random.default_rng(stream_seed(seed, SAMPLE_STREAM))
    return np.sort(rng.choice(n, size=min(count, n), replace=False))


def block_rows(n: int, pairs: float, seed: int, block: int = 128
               ) -> np.ndarray:
    """Rows of whole ``block``-row blocks, sorted, whose distances to all n
    rows number at most ``pairs``: every row where that covers them, else
    the last (partial) block and further blocks drawn from the run's
    seed.  128 rows is the k-NN kernel's row block, so a fault confined to
    one block's lists is seen whole or not at all."""
    if float(n) * n <= pairs:
        return np.arange(n)
    blocks = -(-n // block)
    count = max(1, min(blocks, int(pairs // (float(n) * block))))
    rng = np.random.default_rng(stream_seed(seed, SAMPLE_STREAM))
    others = (rng.choice(blocks - 1, size=count - 1, replace=False)
              if count > 1 else [])
    pick = sorted({blocks - 1, *(int(b) for b in others)})
    return np.concatenate([np.arange(b * block, min(n, (b + 1) * block))
                           for b in pick])


# -- build ---------------------------------------------------------------
def knn_gaps(torch, xu_ref, rows, k: int, eps: float, d_prog, i_prog):
    """(knn_dist_gap, knn_id_gap) of the program's lists (d_prog, i_prog
    [R, k] of ``rows``) against the reference's over the unit corpus
    xu_ref (float64), in one pass over the rows' distances."""
    n = xu_ref.shape[0]
    i_p = i_prog.to(device=xu_ref.device, dtype=torch.int64)
    valid = (i_p >= 0) & (i_p < n)
    d_ref, _, d_at = knn_rows(xu_ref, rows, k, eps,
                              at=torch.clamp(i_p, 0, n - 1))
    d_p = d_prog.to(xu_ref.dtype)
    dist_gap = torch.nan_to_num((d_p - d_ref).abs(), nan=BIG).max()
    r = rows.to(torch.int64)[:, None].expand_as(i_p)
    d_at = torch.where(valid, d_at, INF_DIST)
    s = torch.sort(i_p, dim=1).values
    rep = torch.zeros_like(valid)
    rep[:, 1:] = (s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)
    bad = (i_p == r) | (~valid & (i_p != -1)) | rep.any(dim=1, keepdim=True)
    gap = torch.where(bad, 2.0, (d_at - d_ref).abs())
    return finite(dist_gap), finite(gap.max())


def ell_gap(torch, lists, rows, ell_idx, ell_w, xu_ref, sigma: float,
            p: float) -> float:
    """ell_gap of the program's ELL rows (ell_idx, ell_w [R, W] of
    ``rows``) against the union graph of its directed lists [n, k]."""
    want = ell_rows(lists, rows, ell_idx.shape[1], xu_ref, sigma, p)
    worst = 0.0
    for t, (cols, ws) in enumerate(want):
        got_c, got_w = ell_idx[t].to(torch.int64), ell_w[t]
        keep = got_c >= 0
        got_c, got_w = got_c[keep], got_w[keep].to(ws.dtype)
        order = torch.argsort(got_c)
        got_c, got_w = got_c[order], got_w[order]
        if got_c.shape != cols.shape or not torch.equal(got_c, cols):
            return 1.0
        if cols.numel():
            worst = max(worst, finite(torch.nan_to_num(
                (got_w - ws).abs(), nan=BIG).max()))
    return worst


def lambda_gap(torch, lam_prog, lam_ref) -> float:
    d = (lam_prog.to(lam_ref.dtype) - lam_ref).abs()
    return finite(torch.nan_to_num(d, nan=1.0).max())


# -- serve ---------------------------------------------------------------
def serve_numbers(torch, xu_ref, lam_ref, queries, lam_q, tau: float, k: int,
                  which, ids, scores, block: int = 64) -> dict:
    """The serve numbers of answers ``ids``/``scores`` [A, k] (numpy) to the
    queries ``queries[which]`` (which [A] indexes the rows of queries),
    against the reference's scores in xu_ref's dtype."""
    n = xu_ref.shape[0]
    dev = xu_ref.device
    ids_t = torch.as_tensor(np.asarray(ids), dtype=torch.int64, device=dev)
    sc_t = torch.as_tensor(np.asarray(scores), device=dev).to(xu_ref.dtype)
    which_t = torch.as_tensor(np.asarray(which), dtype=torch.int64,
                              device=dev)
    valid = (ids_t >= 0) & (ids_t < n)
    s = torch.sort(ids_t, dim=1).values
    rep = (s[:, 1:] == s[:, :-1]).any(dim=1)
    bad_rows = (~valid).any(dim=1) | rep | (ids_t.shape[1] < k)
    score_gap = rank_gap = 0.0
    hits = 0.0
    for b0 in range(0, queries.shape[0], block):
        sel = (which_t >= b0) & (which_t < b0 + block)
        if not bool(sel.any()):
            continue
        full = ref_scores(xu_ref, lam_ref, queries[b0:b0 + block],
                          lam_q[b0:b0 + block], tau)
        best, best_ids = topk(full, k)
        rows = which_t[sel] - b0
        got = ids_t[sel]
        ok = valid[sel]
        at = full[rows[:, None], torch.clamp(got, 0, n - 1)]
        at = torch.where(ok, at, -torch.inf)
        g = torch.where(ok, (sc_t[sel] - at).abs(), 0.0)
        score_gap = max(score_gap, finite(torch.nan_to_num(g, nan=BIG).max()))
        lag = torch.where(ok, torch.clamp_min(best[rows][:, :got.shape[1]]
                                              - at, 0.0), 0.0)
        rank_gap = max(rank_gap, finite(lag.max()))
        hits += float((got[:, :, None] == best_ids[rows][:, None, :])
                      .any(dim=2).sum())
    answers = max(1, ids_t.shape[0])
    return {"bad_ids": float(bad_rows.sum()), "score_gap": score_gap,
            "rank_gap": rank_gap, "recall": hits / (answers * k)}


# -- limits --------------------------------------------------------------
def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(all within their limits, {name: {"value": v, "max"|"min": limit}})
    for every number that has a limit."""
    out, ok = {}, True
    for name, lim in limits.items():
        v = finite(numbers[name])
        if "max" in lim:
            good = v <= float(lim["max"])
            out[name] = {"value": v, "max": float(lim["max"])}
        else:
            good = v >= float(lim["min"])
            out[name] = {"value": v, "min": float(lim["min"])}
        ok = ok and good
    return ok, out
