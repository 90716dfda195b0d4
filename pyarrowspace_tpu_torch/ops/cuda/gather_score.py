"""K5: the gather and score of the selected subtiles (phase b of subtile
serving) — the CUDA kernel's wrapper and its plain PyTorch version.

``gather_score`` returns, for every query, its dot with each row of its S
selected 64-row subtiles: ``cos [Q, S * 64]``, the subtiles in ``sel``'s
order.  The lambda blend stays with the caller.  On CPU tensors it runs
``gather_score_plain``; on CUDA tensors it launches
``csrc/gather_score.cu`` (built at first use) or raises.

On the card it takes K3's route (``tensor_core_route``, K3's predicate): the
bf16 tensor-core kernel, a read-once grouped product over the buckets of
``sel`` (``buckets``: each subtile's selecting (query, slot) pairs, taken
in chunks of ``CHUNK``), with K3's product bit for bit; or the per-query SIMT
kernel, with K3's SIMT product.  A failed build or launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from .subtile_max import tensor_core_route

SUBTILE = 64
# Queries a chunk of a bucket: the N of the tensor-core tile (wgmma_tile.cuh).
CHUNK = 256

# Kernel launches since import (or since the caller last reset it): all
# of them, and those of the tensor-core route.
LAUNCHES = 0
TC_LAUNCHES = 0

# Plain version: queries per chunk keep the gathered [queries, S * 64, F]
# rows near this many elements.
_PLAIN_CHUNK_ELEMS = 1 << 26


def gather_score_plain(xu: torch.Tensor, qn: torch.Tensor,
                       sel: torch.Tensor) -> torch.Tensor:
    """Gather the selected rows, upcast to float32, batched matvec."""
    q, s_keep = sel.shape
    f = xu.shape[1]
    rows = (sel.to(torch.int64)[:, :, None] * SUBTILE
            + torch.arange(SUBTILE, device=xu.device)).reshape(q, -1)
    out = torch.empty((q, s_keep * SUBTILE), dtype=torch.float32,
                      device=xu.device)
    step = max(1, _PLAIN_CHUNK_ELEMS // max(s_keep * SUBTILE * f, 1))
    for s in range(0, q, step):
        x = xu[rows[s:s + step]].to(torch.float32)       # [qc, S*64, F]
        qc = qn[s:s + step].to(torch.float32)[:, :, None]
        out[s:s + step] = torch.bmm(x, qc)[:, :, 0]
    return out


def buckets(sel: torch.Tensor, n_sub: int):
    """The selection sel [Q, S] int32 inverted: for each subtile the (query,
    slot) pairs that selected it.  Returns (order [Q * S] int64, edges
    [n_sub + 1] int64): subtile s's bucket is the pair ids
    order[edges[s]:edges[s + 1]] (pair id q * S + slot, ascending), empty
    when the two edges are equal.  The tensor-core kernel reads its buckets
    from these two arrays and takes each in chunks of at most CHUNK pairs.
    No device-to-host sync."""
    sorted_sub, order = torch.sort(sel.reshape(-1), stable=True)
    edges = torch.searchsorted(
        sorted_sub, torch.arange(n_sub + 1, dtype=sorted_sub.dtype,
                                 device=sel.device))
    return order, edges


def gather_score_buckets_plain(xu: torch.Tensor, qn: torch.Tensor,
                               sel: torch.Tensor,
                               chunk: int = CHUNK) -> torch.Tensor:
    """gather_score computed as the tensor-core kernel walks it: for each
    subtile's bucket, chunk by chunk, the subtile's 64 rows against the
    chunk's queries (float32), scattered to out[q, 64 * slot + r]."""
    q, s_keep = sel.shape
    n_sub = xu.shape[0] // SUBTILE
    order, edges = buckets(sel, n_sub)
    order, edges = order.tolist(), edges.tolist()
    out = torch.empty((q, s_keep * SUBTILE), dtype=torch.float32,
                      device=xu.device)
    view = out.view(q, s_keep, SUBTILE)
    for s in range(n_sub):
        for c0 in range(edges[s], edges[s + 1], chunk):
            pair = torch.tensor(order[c0:min(c0 + chunk, edges[s + 1])],
                                device=xu.device)
            qs, slot = pair // s_keep, pair % s_keep
            a = xu[s * SUBTILE:(s + 1) * SUBTILE].to(torch.float32)
            view[qs, slot] = (a @ qn[qs].to(torch.float32).T).T
    return out


def _lib():
    lib = _build.load("gather_score")
    lib.gather_score_launch.restype = ctypes.c_int
    lib.gather_score_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p]
    lib.gather_score_tc_launch.restype = ctypes.c_int
    lib.gather_score_tc_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p]
    return lib


def gather_score(xu: torch.Tensor, qn: torch.Tensor,
                 sel: torch.Tensor) -> torch.Tensor:
    """cos [Q, S * 64] float32: xu [N_pad, F] (float32 or bfloat16, N_pad a
    multiple of 64), queries qn [Q, F] of xu's dtype, sel [Q, S] int32
    subtile numbers in [0, N_pad / 64)."""
    global LAUNCHES, TC_LAUNCHES
    if (xu.dim() != 2 or qn.dim() != 2 or sel.dim() != 2
            or qn.shape[1] != xu.shape[1] or sel.shape[0] != qn.shape[0]):
        raise ValueError(f"shapes xu {tuple(xu.shape)} / qn "
                         f"{tuple(qn.shape)} / sel {tuple(sel.shape)} do "
                         f"not match")
    n_pad, f = xu.shape
    q, s_keep = sel.shape
    if n_pad % SUBTILE:
        raise ValueError(f"xu rows {n_pad} must be a multiple of {SUBTILE}")
    devices = {t.device for t in (xu, qn, sel)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    device = xu.device
    if device.type == "cpu":
        return gather_score_plain(xu, qn, sel)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if xu.dtype not in (torch.float32, torch.bfloat16) or qn.dtype != xu.dtype:
        raise TypeError(f"the gather-score kernel takes a float32 or bfloat16 "
                        f"corpus and queries of its type, got {xu.dtype} / "
                        f"{qn.dtype}")
    if sel.dtype != torch.int32:
        raise TypeError(f"the gather-score kernel takes int32 sel, got "
                        f"{sel.dtype}")
    for name, t in (("xu", xu), ("qn", qn), ("sel", sel)):
        if not t.is_contiguous():
            raise ValueError(f"the gather-score kernel takes a contiguous "
                             f"{name}")
    if q * s_keep * SUBTILE >= 2 ** 31 or q >= 2 ** 31 // max(f, 1):
        raise ValueError(f"unsupported shapes Q={q}, S={s_keep}, F={f}")
    out = torch.empty((q, s_keep * SUBTILE), dtype=torch.float32,
                      device=device)
    if q == 0 or s_keep == 0:
        return out
    tc = tensor_core_route(xu, qn)
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    if tc:
        order, edges = buckets(sel, n_pad // SUBTILE)
        err = lib.gather_score_tc_launch(
            xu.data_ptr(), f, qn.data_ptr(), s_keep, n_pad // SUBTILE,
            edges.data_ptr(), order.data_ptr(), out.data_ptr(),
            device.index or 0, stream)
    else:
        err = lib.gather_score_launch(
            xu.data_ptr(), f, qn.data_ptr(), sel.data_ptr(), q, s_keep,
            int(xu.dtype == torch.bfloat16), out.data_ptr(),
            device.index or 0, stream)
    _build.check(lib, "gather_score", err)
    LAUNCHES += 1
    TC_LAUNCHES += tc
    return out
