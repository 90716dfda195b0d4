"""K7: the int8 candidate scan of ``search_batch(mode="int8")`` — the CUDA
kernel's wrapper and its plain PyTorch version.

``lambda_search_quantized`` is the port of the JAX package's
``lambda_search_quantized`` (ops/pallas/scan_topk.py:257).  It quantizes
the float32 unit queries on their device (ops/quantize.quantize_rows) and
keeps, per query, the k = max(1, min(cand_k, N)) largest

    cos   = (float(qq . xq_i) * qscale_q) * srow_i
    score = tau * cos + (1 - tau) / (1 + |lam_i - lam_q|)

in (score desc, id asc) order.  On CPU tensors it runs ``scan_int8_plain``;
on CUDA tensors it launches ``csrc/scan_int8.cu`` (built at first use) or
raises.  The int8 products are exact integers either way, and both round
the epilogue op by op in the same order, so kernel and plain version agree
bit for bit.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as nnf

from ... import _build
from ..quantize import quantize_rows
from .scan_topk import plan_splits

# Kernel launches since import (or since the caller last reset it).
LAUNCHES = 0

# Plain version: queries per chunk keep the [queries, N] score block near
# this many elements.
_PLAIN_CHUNK_ELEMS = 1 << 26


def scan_int8_plain(xq: torch.Tensor, srow: torch.Tensor, lam: torch.Tensor,
                    qq: torch.Tensor, qscale: torch.Tensor,
                    lamq: torch.Tensor, tau, k: int):
    """The int8 products in float64 (exact: |acc| <= 16,129 F < 2^53),
    converted to int32, then the float32 epilogue and a stable descending
    sort.  Returns (idx [Q, k] int32, scores [Q, k] float32)."""
    f32 = torch.float32
    n = xq.shape[0]
    xt = xq.to(torch.float64).T
    srow32, lam32 = srow.to(f32), lam.to(f32)
    tau_t = torch.as_tensor(tau, dtype=f32, device=xq.device)
    step = max(1, _PLAIN_CHUNK_ELEMS // max(n, 1))
    out_i, out_s = [], []
    for s in range(0, qq.shape[0], step):
        acc = (qq[s:s + step].to(torch.float64) @ xt).to(torch.int32)
        cos = acc.to(f32) * qscale[s:s + step].to(f32)[:, None] \
            * srow32[None, :]
        prox = 1.0 / (1.0 + torch.abs(lam32[None, :]
                                      - lamq[s:s + step].to(f32)[:, None]))
        score = tau_t * cos + (1.0 - tau_t) * prox
        vals, order = torch.sort(score, dim=1, descending=True, stable=True)
        out_i.append(order[:, :k].to(torch.int32))
        out_s.append(vals[:, :k])
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
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p]
    return lib


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
    global LAUNCHES
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
    xw, qw = _words(xq), _words(qq)
    fw = xw.shape[1]
    out_i = torch.empty((q, k), dtype=torch.int32, device=device)
    out_s = torch.empty((q, k), dtype=torch.float32, device=device)
    if q == 0:
        return out_i, out_s
    splits, q_chunk = plan_splits(n, q, k, device)
    part_s = torch.empty((splits, min(q, q_chunk), k), dtype=torch.float32,
                         device=device)
    part_i = torch.empty_like(part_s, dtype=torch.int32)
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    for s in range(0, q, q_chunk):
        qc = min(q_chunk, q - s)
        err = lib.scan_int8_launch(
            xw.data_ptr(), srow.data_ptr(), lam.data_ptr(), n, fw,
            qw[s:].data_ptr(), qscale[s:].data_ptr(), lamq[s:].data_ptr(),
            qc, float(tau), k, splits, part_s.data_ptr(), part_i.data_ptr(),
            out_s[s:].data_ptr(), out_i[s:].data_ptr(), device.index or 0,
            stream)
        _build.check(lib, "scan_int8", err)
        LAUNCHES += 1
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
