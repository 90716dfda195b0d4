"""K1t: the exact eps/k-NN scan with a transposed, thread-owned merge — the
CUDA kernel's wrapper.

``knn_scan_t`` computes K1's function (ops/cuda/knn.py), so its plain
version is K1's, ``knn_plain``: a CPU tensor runs it, a CUDA tensor
launches ``csrc/knn_t.cu`` (built at first use) or raises.  The kernel
writes [k, R] slot-major lists; the wrapper transposes them once.  Lists
past ``knn.WIDE_K`` take K1's wide route (csrc/knn_wide.cuh), split and
chunked as K1's are (``knn.plan_splits``).
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from .knn import INF_DIST, WIDE_K, check_corpus, knn_plain, scratch
from .knn import route_name as _k1_route

# Lists of up to this many entries have two owners a row in the kernel, up
# to WIDE_K one.
HALVES_MAX_K = 64

# Kernel launches since import (or since the caller last reset it), and the
# wide-route launches among them whose column walk was split.
LAUNCHES = 0
SPLIT_LAUNCHES = 0


def _lib():
    lib = _build.load("knn_t")
    lib.knn_t_launch.restype = ctypes.c_int
    lib.knn_t_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    return lib


def route_name(row_count: int, n: int, k: int, device) -> str:
    """The kernel's route for row_count rows of an [n, F] corpus: "owners2"
    (k <= 64), "owners1" (k <= 128) or K1's "wide/S<splits>"."""
    if k > WIDE_K:
        return _k1_route(row_count, n, k, device, narrow=False)
    return "owners2" if k <= HALVES_MAX_K else "owners1"


def knn_scan_t(xu: torch.Tensor, k: int, eps: float, row_start: int = 0,
               row_count: int | None = None):
    """(dist [R, k], idx [R, k] int32) for rows [row_start, row_start + R)
    of the unit corpus ``xu`` [N, F] against all N columns."""
    global LAUNCHES, SPLIT_LAUNCHES
    row_count = check_corpus(xu, k, row_start, row_count, "K1t")
    if xu.device.type == "cpu":
        return knn_plain(xu, k, eps, slice(row_start, row_start + row_count))
    shape = (k, row_count)
    if k > WIDE_K:    # the wide route merges into (2.0, -1) entries
        out_d = torch.full(shape, INF_DIST, dtype=torch.float32,
                           device=xu.device)
        out_i = torch.full(shape, -1, dtype=torch.int32, device=xu.device)
    else:
        out_d = torch.empty(shape, dtype=torch.float32, device=xu.device)
        out_i = torch.empty(shape, dtype=torch.int32, device=xu.device)
    if row_count == 0:
        return out_d.T, out_i.T
    splits, chunk, part = scratch(row_count, xu.shape[0], k, xu.device,
                                  narrow=False)
    lib = _lib()
    stream = torch.cuda.current_stream(xu.device).cuda_stream
    for s in range(0, row_count, chunk):
        err = lib.knn_t_launch(
            xu.data_ptr(), xu.shape[0], xu.shape[1], row_start + s,
            min(chunk, row_count - s), float(eps), k, splits,
            part.data_ptr() if part is not None else None,
            out_d[:, s:].data_ptr(), out_i[:, s:].data_ptr(), row_count,
            xu.device.index or 0, stream)
        _build.check(lib, "knn_t", err)
        LAUNCHES += 1
        SPLIT_LAUNCHES += splits > 1
    return out_d.T.contiguous(), out_i.T.contiguous()
