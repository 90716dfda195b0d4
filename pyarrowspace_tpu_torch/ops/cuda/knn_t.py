"""K1t: the exact eps/k-NN scan with a transposed, thread-owned merge — the
CUDA kernel's wrapper.

``knn_scan_t`` computes K1's function (ops/cuda/knn.py), so its plain
version is K1's, ``knn_plain``: a CPU tensor runs it, a CUDA tensor
launches ``csrc/knn_t.cu`` (built at first use) or raises.  The kernel
writes [k, R] slot-major lists; the wrapper transposes them once.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from .knn import check_corpus, knn_plain

# Kernel launches since import (or since the caller last reset it).
LAUNCHES = 0


def _lib():
    lib = _build.load("knn_t")
    lib.knn_t_launch.restype = ctypes.c_int
    lib.knn_t_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return lib


def knn_scan_t(xu: torch.Tensor, k: int, eps: float, row_start: int = 0,
               row_count: int | None = None):
    """(dist [R, k], idx [R, k] int32) for rows [row_start, row_start + R)
    of the unit corpus ``xu`` [N, F] against all N columns."""
    global LAUNCHES
    row_count = check_corpus(xu, k, row_start, row_count, "K1t")
    if xu.device.type == "cpu":
        return knn_plain(xu, k, eps, slice(row_start, row_start + row_count))
    out_d = torch.empty((k, row_count), dtype=torch.float32,
                        device=xu.device)
    out_i = torch.empty((k, row_count), dtype=torch.int32, device=xu.device)
    if row_count == 0:
        return out_d.T, out_i.T
    lib = _lib()
    stream = torch.cuda.current_stream(xu.device).cuda_stream
    err = lib.knn_t_launch(xu.data_ptr(), xu.shape[0], xu.shape[1],
                           row_start, row_count, float(eps), k,
                           out_d.data_ptr(), out_i.data_ptr(),
                           xu.device.index or 0, stream)
    _build.check(lib, "knn_t", err)
    LAUNCHES += 1
    return out_d.T.contiguous(), out_i.T.contiguous()
