"""K7: the int8 candidate scan of ``search_batch(mode="int8")`` — the CUDA
kernel's wrapper and its plain PyTorch version.

``lambda_search_quantized`` is the port of the JAX package's
``lambda_search_quantized`` (ops/pallas/scan_topk.py:257).  It quantizes
the float32 unit queries on their device (ops/quantize.quantize_rows) and
keeps, per query, the k = max(1, min(cand_k, N)) largest

    cos   = (float(qq . xq_i) * qscale_q) * srow_i
    score = tau * cos + (1 - tau) / (1 + |lam_i - lam_q|)

in (score desc, id asc) order; a score that is NaN (lambdas inf - inf) or
at or below -3e38 enters no list, and a list short of k entries ends in
(-3e38, -1).  (The JAX package's kernel differs on NaN: its query takes
nothing of the corpus tile, up to 1,024 items, that holds the NaN.)  On
CPU tensors it runs ``scan_int8_plain``; on CUDA tensors it launches
``csrc/scan_int8.cu`` (built at first use) or raises.  The int8 products
are exact integers either way, and both round the epilogue op by op in
the same order, so kernel and plain version agree bit for bit.

Two routes on the card, chosen by ``tensor_core_route`` from dtype, shape
and alignment alone: the int8 tensor-core kernel (``wgmma`` s8, on
``csrc/wgmma_tile.cuh``) for contiguous int8 rows with F % 16 == 0, F <=
1,024 and 16-byte-aligned bases, else the SIMT kernel (``__dp4a``), which
stays as the witness of the int32 sums.  On either, a list is narrow (in
shared memory) or, past what shared memory holds (``wide_lists``), wide:
its survivors staged, sorted and merged into partial lists in device
memory (``csrc/knn_wide.cuh``'s keys and merge).  A failed build or
launch raises; nothing falls back to the other route or to the plain
version.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as nnf

from ... import _build
from ..quantize import quantize_rows
from .scan_topk import fit_scratch, scratch_words, sm_count

# Queries per block and corpus items per tile: of the SIMT kernel, and of
# the tensor-core kernel.
_TILE = 64
_TC_TILE = 128
# The tensor-core kernel keeps its block's 128 query rows in shared memory.
TC_MAX_F = 1024
# A narrow list holds up to 256 entries.  The tensor-core kernel keeps its
# 128 narrow lists in shared memory beside the queries' stages (16 KB a
# 128 features), two ring stages (16 KB each), the warps' survivor buffers
# (16 KB) and its barriers, within a block's 232,448 bytes; a wide list's
# query stages _SROW keys (csrc/scan_int8.cu SROW).
_NARROW_MAX = 256
_TC_STAGE_BYTES = 16_384
_TC_SMEM = 232_448
_SROW = 512

# Kernel launches since import (or since the caller last reset it): all
# of them, those of the tensor-core route, and those with wide lists.
LAUNCHES = 0
TC_LAUNCHES = 0
WIDE_LAUNCHES = 0

# The unfilled slot's score (its id is -1).
NEG_SCORE = -3.0e38

# Plain version: queries per chunk keep the [queries, N] score block near
# this many elements.
_PLAIN_CHUNK_ELEMS = 1 << 26


def wide_lists(k: int, f: int, tensor_core: bool) -> bool:
    """Whether K7 keeps lists of k wide: past 256 entries, or, on the
    tensor-core route at F features, when 128 narrow lists do not fit its
    shared memory beside two ring stages (F 384: past 130; F 768: past
    82).  csrc/scan_int8.cu decides so too (scan_int8_tc_wide)."""
    if k > _NARROW_MAX:
        return True
    if not tensor_core:
        return False
    nk = -(-f // 128)
    used = (nk + 3) * _TC_STAGE_BYTES + 128 * k * 8 + 5 * 8
    return used > _TC_SMEM


def plan_splits(n: int, q: int, k: int, device, tensor_core: bool = False,
                wide: bool = False) -> tuple[int, int]:
    """K7's (splits, queries a launch), then ``scan_topk.fit_scratch`` (a
    wide list's staging rows count with its partial lists).  SIMT route:
    at least about two 64-query blocks per SM, every split holding at
    least one 64-item tile.  Tensor-core route (one block an SM): the
    fewest corpus splits whose grid of 128-query blocks fills its last
    wave to 90% or more, as K2 plans."""
    sms = sm_count(device.index or 0)
    per_query = k + (_SROW if wide else 0)
    if tensor_core:
        n_tiles, n_qblocks = -(-n // _TC_TILE), -(-q // _TC_TILE)
        want = next((s for s in range(1, n_tiles + 1)
                     if 10 * n_qblocks * s
                     >= 9 * sms * -(-n_qblocks * s // sms)), n_tiles)
        return fit_scratch(n_tiles, want, q, per_query)
    n_tiles, n_qblocks = -(-n // _TILE), -(-q // _TILE)
    want = min(n_tiles, max(1, -(-2 * sms // n_qblocks)))
    return fit_scratch(n_tiles, want, q, per_query)


def tensor_core_route(xq: torch.Tensor, qq: torch.Tensor) -> bool:
    """Whether K7 runs its int8 tensor-core kernel on the corpus xq [N, F]
    and queries qq [Q, F]: both contiguous int8, F a positive multiple of
    16 (16-byte rows, TMA's stride rule) up to TC_MAX_F, and both base
    addresses 16-byte aligned.  Otherwise it runs its SIMT kernel."""
    f = xq.shape[-1]
    return (xq.dtype == torch.int8 and qq.dtype == torch.int8
            and 0 < f <= TC_MAX_F and f % 16 == 0
            and xq.is_contiguous() and qq.is_contiguous()
            and xq.data_ptr() % 16 == 0 and qq.data_ptr() % 16 == 0)


def route_name(xq: torch.Tensor, qq: torch.Tensor) -> str:
    """"tensor-core" or "simt": the route tensor_core_route picks."""
    return "tensor-core" if tensor_core_route(xq, qq) else "simt"


def lists_name(xq: torch.Tensor, qq: torch.Tensor, k: int) -> str:
    """The lists of a launch with lists of k: "narrow" or "wide", and
    "/S<splits>"."""
    tc = tensor_core_route(xq, qq)
    wide = wide_lists(k, xq.shape[-1], tc)
    splits = plan_splits(xq.shape[0], qq.shape[0], k, xq.device, tc,
                         wide)[0]
    return f"{'wide' if wide else 'narrow'}/S{splits}"


def scan_int8_plain(xq: torch.Tensor, srow: torch.Tensor, lam: torch.Tensor,
                    qq: torch.Tensor, qscale: torch.Tensor,
                    lamq: torch.Tensor, tau, k: int):
    """The int8 products in float64 (exact: |acc| <= 16,129 F < 2^53),
    converted to int32, then the float32 epilogue and a stable descending
    sort of the scores above -3e38.  Returns (idx [Q, k] int32, scores
    [Q, k] float32)."""
    f32 = torch.float32
    n = xq.shape[0]
    xt = xq.to(torch.float64).T
    srow32, lam32 = srow.to(f32), lam.to(f32)
    tau_t = torch.as_tensor(tau, dtype=f32, device=xq.device)
    neg = torch.tensor(NEG_SCORE, dtype=f32, device=xq.device)
    step = max(1, _PLAIN_CHUNK_ELEMS // max(n, 1))
    out_i, out_s = [], []
    for s in range(0, qq.shape[0], step):
        acc = (qq[s:s + step].to(torch.float64) @ xt).to(torch.int32)
        cos = acc.to(f32) * qscale[s:s + step].to(f32)[:, None] \
            * srow32[None, :]
        prox = 1.0 / (1.0 + torch.abs(lam32[None, :]
                                      - lamq[s:s + step].to(f32)[:, None]))
        score = tau_t * cos + (1.0 - tau_t) * prox
        # As in both kernels, a score enters a list only if it beats the
        # unfilled slot (-3e38, -1): a NaN (an inf - inf lambda gap) or a
        # score at or below -3e38 never does, and a list short of k such
        # scores ends in (-3e38, -1).
        score = torch.where(score > neg, score, neg)
        vals, order = torch.sort(score, dim=1, descending=True, stable=True)
        vals = vals[:, :k]
        out_i.append(torch.where(vals > neg, order[:, :k], -1)
                     .to(torch.int32))
        out_s.append(vals)
    if not out_i:
        return (torch.empty((0, k), dtype=torch.int32, device=xq.device),
                torch.empty((0, k), dtype=f32, device=xq.device))
    return torch.cat(out_i), torch.cat(out_s)


def _lib():
    lib = _build.load("scan_int8")
    lib.scan_int8_launch.restype = ctypes.c_int
    lib.scan_int8_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p]
    lib.scan_int8_tc_launch.restype = ctypes.c_int
    lib.scan_int8_tc_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.scan_int8_tc_wide.restype = ctypes.c_int
    lib.scan_int8_tc_wide.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


def _item_pairs(srow: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """The tensor-core kernel's per-item operands: (srow, lam) of every
    item, [N_pad, 2] float32 with N_pad a multiple of its tile, zeros past
    N, so that a thread reads an item pair's four values as one float4."""
    n = srow.shape[0]
    out = torch.zeros((-(-n // _TC_TILE) * _TC_TILE, 2), dtype=torch.float32,
                      device=srow.device)
    out[:n, 0] = srow
    out[:n, 1] = lam
    return out


def _words(x: torch.Tensor) -> torch.Tensor:
    """int8 rows padded with zeros to a multiple of 4 features, contiguous
    and 4-byte aligned, viewed as int32 words."""
    pad = (-x.shape[1]) % 4
    if pad:
        x = nnf.pad(x, (0, pad))
    if not x.is_contiguous() or x.data_ptr() % 4:
        x = x.contiguous().clone()
    return x.view(torch.int32)


def scan_int8(xq: torch.Tensor, srow: torch.Tensor, lam: torch.Tensor,
              qq: torch.Tensor, qscale: torch.Tensor, lamq: torch.Tensor,
              tau, k: int):
    """(idx [Q, k] int32, scores [Q, k] float32) of the quantized queries
    qq [Q, F] int8 with scales qscale [Q] and lambdas lamq [Q] over the
    corpus xq [N, F] int8 with row scales srow [N] and lambdas lam [N];
    1 <= k <= N."""
    global LAUNCHES, TC_LAUNCHES, WIDE_LAUNCHES
    if xq.dim() != 2 or qq.dim() != 2 or qq.shape[1] != xq.shape[1]:
        raise ValueError(f"shapes xq {tuple(xq.shape)} / qq "
                         f"{tuple(qq.shape)} do not match")
    n, f = xq.shape
    q = qq.shape[0]
    if (srow.shape != (n,) or lam.shape != (n,) or qscale.shape != (q,)
            or lamq.shape != (q,)):
        raise ValueError(f"scales / lambdas must be [{n}] and [{q}]")
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must be in [1, {n}]")
    tensors = (xq, srow, lam, qq, qscale, lamq)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    device = xq.device
    if device.type == "cpu":
        return scan_int8_plain(xq, srow, lam, qq, qscale, lamq, tau, k)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    for name, t, dtype in (("xq", xq, torch.int8), ("qq", qq, torch.int8),
                           ("srow", srow, torch.float32),
                           ("lam", lam, torch.float32),
                           ("qscale", qscale, torch.float32),
                           ("lamq", lamq, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"the int8 scan kernel takes {dtype} {name}, "
                            f"got {t.dtype}")
    for name, t in (("srow", srow), ("lam", lam), ("qscale", qscale),
                    ("lamq", lamq)):
        if not t.is_contiguous():
            raise ValueError(f"the int8 scan kernel takes a contiguous "
                             f"{name}")
    if n >= 2 ** 31 // f or q >= 2 ** 31 // max(f, k):
        raise ValueError(f"unsupported shapes N={n}, Q={q}, F={f}")
    out_i = torch.empty((q, k), dtype=torch.int32, device=device)
    out_s = torch.empty((q, k), dtype=torch.float32, device=device)
    if q == 0:
        return out_i, out_s
    tc = tensor_core_route(xq, qq)
    if tc:
        xa, qa, fa = xq, qq, f
        cols = _item_pairs(srow, lam)
    else:
        xa, qa = _words(xq), _words(qq)
        fa = xa.shape[1]
    wide = wide_lists(k, fa, tc)
    lib = _lib()
    if tc and bool(lib.scan_int8_tc_wide(fa, k)) != wide:
        raise RuntimeError(f"the int8 scan kernel's lists at F={fa}, k={k} "
                           f"are not wide={wide}, as wide_lists says")
    splits, q_chunk = plan_splits(n, q, k, device, tc, wide)
    part = torch.empty((scratch_words(splits, min(q, q_chunk), k,
                                      _SROW if wide else 0), 2),
                       dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    for s in range(0, q, q_chunk):
        qc = min(q_chunk, q - s)
        if tc:
            err = lib.scan_int8_tc_launch(
                xa.data_ptr(), cols.data_ptr(), n, fa, qa[s:].data_ptr(),
                qscale[s:].data_ptr(), lamq[s:].data_ptr(), qc, float(tau),
                k, splits, part.data_ptr(), out_s[s:].data_ptr(),
                out_i[s:].data_ptr(), device.index or 0, stream)
        else:
            err = lib.scan_int8_launch(
                xa.data_ptr(), srow.data_ptr(), lam.data_ptr(), n, fa,
                qa[s:].data_ptr(), qscale[s:].data_ptr(),
                lamq[s:].data_ptr(), qc, float(tau), k, splits,
                part.data_ptr(), out_s[s:].data_ptr(), out_i[s:].data_ptr(),
                device.index or 0, stream)
        _build.check(lib, "scan_int8", err)
        LAUNCHES += 1
        TC_LAUNCHES += tc
        WIDE_LAUNCHES += wide
    return out_i, out_s


def lambda_search_quantized(xq: torch.Tensor, scales: torch.Tensor,
                            lambdas: torch.Tensor, qn: torch.Tensor,
                            lam_q: torch.Tensor, tau, cand_k: int):
    """Quantized candidate scan: the int8 corpus (xq [N, F] + scales [N]),
    float32 unit queries qn [Q, F] quantized here, lam_q [Q] -> a pool per
    query (idx [Q, k] int32, approximate scores [Q, k] float32) with
    k = max(1, min(cand_k, N)), for ops/search.rescore_candidates."""
    k = max(1, min(int(cand_k), xq.shape[0]))
    qq, qscale = quantize_rows(qn)
    return scan_int8(xq, scales.to(torch.float32).contiguous(),
                     lambdas.to(torch.float32).contiguous(), qq, qscale,
                     lam_q.to(torch.float32).contiguous(), tau, k)
