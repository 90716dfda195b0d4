"""Subtile-max serving (port of pyarrowspace_tpu/ops/pallas/subtile_scan.py).

The block-max bound: for any subtile width W, if item i is in the true
top-k, fewer than k subtiles have a max score above s_i (each holds a
distinct better item), so i's subtile ranks within the top-k subtiles by
max.  Keeping the top S >= k subtiles per query keeps the true top-k.

  a. K3 (ops/cuda/subtile_max): every query's blended score against every
     corpus row, reduced to the max over each 64-row subtile of real rows
     ([Q, n_sub]; a subtile with no real row gets its sentinel).
  b. top-S subtile select: K4b (ops/cuda/extract.extract_ids) on the
     maxima, or above _SINGLE_LEVEL_MAX_NSUB subtiles the two-level select
     (top-S supertiles of 1024 rows, then their subtiles) with K4a
     (extract_pool).  Then K5 (ops/cuda/gather_score) scores each query
     against its S subtiles' whole rows with the same product as K3, the
     blend follows in PyTorch with K3's op order, and K4a cuts the pool.
     K3's max of a subtile is then bit for bit the best score found here,
     so the routing is exact in the scan dtype.
  c. exact float32 rescore of the pool (a gather and a batched matvec) and
     the final top-k by a stable sort (lax.top_k's tie rule: the lower
     position first).

On CUDA tensors each phase launches its hand-written kernel; on CPU tensors
the kernels' plain versions run.  Left out from the JAX module: the
``ARROWSPACE_SUBTILE_W`` override (W stays 64) and the query chunking of
``_gather_score_pallas``, a TPU scalar-memory workaround.
"""

from __future__ import annotations

import torch

from .cuda import extract, gather_score, subtile_max

# Items per subtile (block-max granularity).
SUBTILE = 64
_NEG_INF = -3.0e38
# Rows per supertile of the two-level select, and the padding multiple of
# the serving state: these fix which state and which selection the path
# computes, as in the JAX package.
_COL_TILE = 1024
_PAD_ROWS = 8192
# Beyond this many subtiles the select goes two-level.
_SINGLE_LEVEL_MAX_NSUB = 32768
# Pool widths up to this go through K4a; wider ones through a stable sort.
_EXTRACT_POOL_MAX = 48

_mask_sentinel = subtile_max.sentinel


def build_subtile_state(xu: torch.Tensor, lambdas: torch.Tensor,
                        scan_dtype=torch.bfloat16) -> dict:
    """Pad + precompute the serving layout for subtile_search.

    Pads N to a multiple of 8192 rows with zero rows and lambda -2.0 (a
    routing hint only: n_real, passed through to subtile_search, is what
    keeps padded rows out of the results).  Returns xu_scan (the scan
    copy in ``scan_dtype``), xu_f32 (the rescore copy), lambdas (float32)
    and n_real."""
    n, f = xu.shape
    n_pad = -(-n // _PAD_ROWS) * _PAD_ROWS
    xu32 = torch.zeros((n_pad, f), dtype=torch.float32, device=xu.device)
    xu32[:n] = xu
    lam = torch.full((n_pad,), -2.0, dtype=torch.float32,
                     device=lambdas.device)
    lam[:n] = lambdas
    return dict(xu_scan=xu32.to(scan_dtype), xu_f32=xu32, lambdas=lam,
                n_real=n)


def subtiles_kept(topk: int, n_sub: int, n_subtiles_keep: int = 16) -> int:
    """Subtiles routed per query: at least topk (the block-max bound needs
    s_keep >= topk), a multiple of 128 / W as on the TPU, at most n_sub."""
    align = max(1, 128 // SUBTILE)
    s_keep = max(n_subtiles_keep, topk)
    return min(-(-s_keep // align) * align, n_sub)


def _select_subtiles(sub: torch.Tensor, n_real: int,
                     s_keep: int) -> torch.Tensor:
    """[Q, s_keep] int32 subtile numbers with the largest routing maxima
    (ties to the smaller number)."""
    q, n_sub = sub.shape
    dev = sub.device
    if n_sub <= _SINGLE_LEVEL_MAX_NSUB:
        return extract.extract_ids(sub, s_keep)
    # Two-level: the top-S supertiles provably hold the top-S subtiles
    # (the block-max argument one level up).
    group = _COL_TILE // SUBTILE
    n_tiles = n_sub // group
    sup_keep = min(s_keep, n_tiles)
    tile_ids = torch.arange(n_tiles, dtype=torch.int32, device=dev)
    sup = sub.view(q, n_tiles, group).amax(dim=2)
    sup = torch.where(tile_ids[None, :] * _COL_TILE < n_real, sup,
                      _mask_sentinel(tile_ids)[None, :])
    if sup_keep * group >= s_keep and n_tiles > sup_keep:
        sup_sel = extract.extract_pool(
            sup, tile_ids.expand(q, n_tiles).contiguous(), sup_keep)
        cand_sub = (sup_sel[:, :, None] * group
                    + torch.arange(group, dtype=torch.int32, device=dev))
        cand_sub = cand_sub.reshape(q, sup_keep * group)
        sub_vals = torch.gather(sub, 1, cand_sub.to(torch.int64))
        return extract.extract_pool(sub_vals, cand_sub, s_keep)
    sub_ids = torch.arange(n_sub, dtype=torch.int32, device=dev)
    return extract.extract_pool(sub, sub_ids.expand(q, n_sub).contiguous(),
                                s_keep)


def phase_b_scores(cos_b: torch.Tensor, sub_sel: torch.Tensor,
                   lam32: torch.Tensor, lamq32: torch.Tensor,
                   tau32: torch.Tensor, n_real: int):
    """Blend phase b's cosines [Q, S * 64] of the selected subtiles sub_sel
    [Q, S] with the op order of K3, and mask rows >= n_real to their
    sentinel.  Returns (score_b [Q, S * 64] float32, cand [Q, S * 64] int32
    row ids)."""
    q, s_keep = sub_sel.shape
    cand = (sub_sel[:, :, None] * SUBTILE
            + torch.arange(SUBTILE, dtype=torch.int32, device=cos_b.device))
    cand = cand.reshape(q, s_keep * SUBTILE)
    lam_b = lam32.view(-1, SUBTILE)[sub_sel.to(torch.int64)].reshape(q, -1)
    prox = 1.0 / (1.0 + torch.abs(lam_b - lamq32[:, None]))
    score_b = tau32 * cos_b + (1.0 - tau32) * prox
    return torch.where(cand < n_real, score_b, _mask_sentinel(cand)), cand


def subtile_search(xu_scan: torch.Tensor, xu_f32: torch.Tensor,
                   lambdas: torch.Tensor, qn: torch.Tensor,
                   lam_q: torch.Tensor, tau, n_real: int, *, topk: int,
                   n_subtiles_keep: int = 16, pool_m: int | None = None):
    """Full subtile-routed serving step (phases a + b + c).

    Args:
      xu_scan: [N_pad, F] scan corpus (float32 or bfloat16) from
        build_subtile_state; phases a and b both score against it, so the
        block-max routing bound is exact in the scan dtype.
      xu_f32: float32 corpus for the exact rescore, same padding.
      lambdas: [N_pad] float32, padded with any value.
      qn [Q, F] unit queries, lam_q [Q], tau the blend.
      n_real: number of real (unpadded) corpus rows; candidates >= n_real
        are masked in phases a, b and c.
      pool_m: width of the float32 rescore pool (default topk).
    Returns (idx [Q, topk] int32, scores [Q, topk] float32): the top-k of a
    full scan in the scan dtype, scores exact in float32.
    """
    n_pad, f = xu_scan.shape
    q = qn.shape[0]
    if n_pad % _PAD_ROWS != 0:
        raise ValueError("corpus must be padded with build_subtile_state "
                         f"(N_pad={n_pad})")
    n_real = int(n_real)
    # tau as a float32 scalar on the host: no device sync to read it back.
    tau32 = torch.as_tensor(tau, dtype=torch.float32).cpu()
    tau_f = float(tau32)
    qn_scan = qn.to(xu_scan.dtype).contiguous()
    lam32 = lambdas.to(torch.float32).contiguous()
    lamq32 = lam_q.to(torch.float32).contiguous()

    # Phase a: routing maxima [Q, n_sub], partial and padded subtiles
    # already handled.
    sub = subtile_max.subtile_max(xu_scan, lam32, qn_scan, lamq32, tau_f,
                                  n_real)

    s_keep = subtiles_kept(topk, n_pad // SUBTILE, n_subtiles_keep)
    sub_sel = _select_subtiles(sub, n_real, s_keep)

    m_pool = min(pool_m if pool_m is not None else topk, s_keep * SUBTILE)
    m_pool = max(m_pool, min(topk, s_keep * SUBTILE))

    # Phase b: each query's dot with its selected subtiles' rows, blended
    # with the op order of K3.
    cos_b = gather_score.gather_score(xu_scan, qn_scan, sub_sel)
    score_b, cand = phase_b_scores(cos_b, sub_sel, lam32, lamq32, tau32,
                                   n_real)

    # Pool cut.
    if m_pool <= _EXTRACT_POOL_MAX:
        pool_idx = extract.extract_pool(score_b, cand, m_pool)
    else:
        pos = torch.sort(score_b, dim=1, descending=True, stable=True).indices
        pool_idx = torch.gather(cand, 1, pos[:, :m_pool])

    # Phase c: exact float32 rescore of the pool.
    pool = pool_idx.to(torch.int64)
    xc = xu_f32[pool]                                    # [Q, m, F]
    cos = torch.bmm(xc, qn.to(torch.float32)[:, :, None])[:, :, 0]
    proxp = 1.0 / (1.0 + torch.abs(lam32[pool] - lamq32[:, None]))
    s = tau32 * cos + (1.0 - tau32) * proxp
    s = s.masked_fill(pool_idx >= n_real, _NEG_INF)
    vals, posk = torch.sort(s, dim=1, descending=True, stable=True)
    return torch.gather(pool_idx, 1, posk[:, :topk]), vals[:, :topk]
