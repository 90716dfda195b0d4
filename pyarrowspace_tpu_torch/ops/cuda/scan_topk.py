"""K2: the blended cosine + lambda-proximity scan with a running top-k — the
CUDA kernel's wrapper and its plain PyTorch version.

``lambda_search`` is the entry point (the port of
``lambda_search_pallas``).  On CPU tensors it runs ``scan_plain``; on CUDA
tensors it launches ``csrc/scan_topk.cu`` (built at first use) or raises.
Both return, per query, the k largest
``tau * (qn . xu_i) + (1 - tau) / (1 + |lam_i - lam_q|)``, descending,
ties to the smallest id.

A bfloat16 corpus (the ``as_serving`` view) is scanned with the queries
rounded to bfloat16 first and the products summed in float32, as the JAX
package's XLA path does (``ops/search.py:52-54``).  The scores stay
float32: the XLA path's, not the TPU path's ``vals.astype(xu.dtype)``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ... import _build

_Q_BLOCK = 64      # queries per block of the kernel
_TILE = 64         # corpus items per tile of the kernel
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Partial lists of the split scans (K2, K7): [splits, Q, k] scores and ids
# are held to this many bytes; fewer splits, then query chunks, keep them
# there.
SCRATCH_BYTES = 1 << 30

# Kernel launches since import (or since the caller last reset it).
LAUNCHES = 0

# Plain version: queries per chunk keep the [queries, N] score block near
# this many elements.
_PLAIN_CHUNK_ELEMS = 1 << 26


def scan_plain(xu: torch.Tensor, lam: torch.Tensor, qn: torch.Tensor,
               lam_q: torch.Tensor, tau, k: int, queries=None):
    """Matmul + blend + stable sort.  ``queries`` selects the queries to
    answer (a slice or an index tensor; default all).  A bfloat16 corpus
    scores ``qn.bfloat16().float() @ xu.float().T``.  Returns
    (idx [Q, k] int32, scores [Q, k])."""
    if queries is not None:
        qn, lam_q = qn[queries], lam_q[queries]
    n = xu.shape[0]
    low = xu.dtype in (torch.bfloat16, torch.float16)
    xt = xu.float().T if low else xu.T
    step = max(1, _PLAIN_CHUNK_ELEMS // max(n, 1))
    out_i, out_s = [], []
    for s in range(0, qn.shape[0], step):
        qc = qn[s:s + step]
        cos = (qc.to(xu.dtype).float() if low else qc) @ xt
        tau_t = torch.as_tensor(tau, dtype=cos.dtype, device=cos.device)
        lamq_c = lam_q[s:s + step].to(cos.dtype)
        prox = 1.0 / (1.0 + torch.abs(lam.to(cos.dtype)[None, :]
                                      - lamq_c[:, None]))
        score = tau_t * cos + (1.0 - tau_t) * prox
        vals, order = torch.sort(score, dim=1, descending=True, stable=True)
        out_i.append(order[:, :k].to(torch.int32))
        out_s.append(vals[:, :k])
    if not out_i:
        return (torch.empty((0, k), dtype=torch.int32, device=xu.device),
                torch.empty((0, k), dtype=xt.dtype, device=xu.device))
    return torch.cat(out_i), torch.cat(out_s)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _splits(n: int, q: int, sm_count: int) -> int:
    """Corpus splits for the kernel: at least about two blocks per SM,
    every split holding at least one tile."""
    n_tiles = -(-n // _TILE)
    n_qblocks = -(-q // _Q_BLOCK)
    want = min(n_tiles, max(1, -(-2 * sm_count // n_qblocks)))
    per_split = -(-n_tiles // want)
    return -(-n_tiles // per_split)


def plan_splits(n: int, q: int, k: int, device) -> tuple[int, int]:
    """(splits, queries a launch) of a split scan over n items for q
    queries with lists of k: the splits of ``_splits``, cut so that the
    partial lists [splits, queries, k] stay within SCRATCH_BYTES; when one
    split over all queries does not fit, the queries go in chunks.  Every
    split stays non-empty (fewer splits only widen each)."""
    splits = _splits(n, q, _sm_count(device.index or 0))
    per_query = 8 * k
    if splits * q * per_query > SCRATCH_BYTES:
        n_tiles = -(-n // _TILE)
        per_split = -(-n_tiles // max(1, SCRATCH_BYTES // (q * per_query)))
        splits = -(-n_tiles // per_split)
    q_chunk = q if splits * q * per_query <= SCRATCH_BYTES else max(
        1, SCRATCH_BYTES // (splits * per_query))
    return splits, q_chunk


def _lib():
    lib = _build.load("scan_topk")
    lib.scan_topk_launch.restype = ctypes.c_int
    lib.scan_topk_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p]
    return lib


def lambda_search(xu: torch.Tensor, lam: torch.Tensor, qn: torch.Tensor,
                  lam_q: torch.Tensor, tau, topk: int):
    """Batched lambda-aware top-k: xu [N, F] unit rows (float32 or
    bfloat16), lam [N], qn [Q, F] unit queries, lam_q [Q] -> (idx [Q, k]
    int32, scores [Q, k]) with k = min(topk, N)."""
    global LAUNCHES
    if xu.dim() != 2 or qn.dim() != 2 or qn.shape[1] != xu.shape[1]:
        raise ValueError(f"shapes xu {tuple(xu.shape)} / qn "
                         f"{tuple(qn.shape)} do not match")
    n, f = xu.shape
    q = qn.shape[0]
    if lam.shape != (n,) or lam_q.shape != (q,):
        raise ValueError(f"lambdas {tuple(lam.shape)} / {tuple(lam_q.shape)}"
                         f" must be [{n}] / [{q}]")
    k = max(1, min(int(topk), n))
    devices = {t.device for t in (xu, lam, qn, lam_q)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    device = xu.device
    if device.type == "cpu":
        return scan_plain(xu, lam, qn, lam_q, tau, k)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if xu.dtype not in _DTYPE_CODES:
        raise TypeError(f"the scan kernel takes a float32 or bfloat16 "
                        f"corpus, got {xu.dtype}")
    for name, t in (("lam", lam), ("qn", qn), ("lam_q", lam_q)):
        if t.dtype != torch.float32:
            raise TypeError(f"the scan kernel takes float32 {name}, "
                            f"got {t.dtype}")
    for name, t in (("xu", xu), ("lam", lam), ("qn", qn), ("lam_q", lam_q)):
        if not t.is_contiguous():
            raise ValueError(f"the scan kernel takes a contiguous {name}")
    if n >= 2 ** 31 // f or q >= 2 ** 31 // f:
        raise ValueError(f"unsupported shapes N={n}, Q={q}, F={f}")
    qs = qn.to(xu.dtype).contiguous()
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
        err = lib.scan_topk_launch(
            xu.data_ptr(), _DTYPE_CODES[xu.dtype], lam.data_ptr(), n, f,
            qs[s:].data_ptr(), lam_q[s:].data_ptr(), qc, float(tau), k,
            splits, part_s.data_ptr(), part_i.data_ptr(),
            out_s[s:].data_ptr(), out_i[s:].data_ptr(), device.index or 0,
            stream)
        _build.check(lib, "scan_topk", err)
        LAUNCHES += 1
    return out_i, out_s
