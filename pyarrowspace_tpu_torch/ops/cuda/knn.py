"""K1: the exact eps/k-NN scan — the CUDA kernel's wrapper and its plain
PyTorch version.

``knn_scan`` is the entry point.  On a CPU tensor it runs ``knn_plain``;
on a CUDA tensor it launches ``csrc/knn.cu`` (built at first use) or
raises.  Both return, for each row of a row range, the k smallest
rectified-cosine distances d = 1 - max(0, x_i . x_j) over all columns with
self and d > eps masked, ascending by (distance, id); missing entries are
(2.0, -1).
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build

INF_DIST = 2.0
# The kernel's running lists: up to 256 entries in shared memory, longer
# ones in place in the output rows.

# Kernel launches since import (or since the caller last reset it).
LAUNCHES = 0

# Plain version: rows per chunk keep the [rows, N] distance block near
# this many elements.
_PLAIN_CHUNK_ELEMS = 1 << 25


def knn_plain(xu: torch.Tensor, k: int, eps: float, rows=None):
    """Chunked matmul + mask + stable sort.  ``rows`` selects the rows to
    answer (a slice or an index tensor; default all).  Returns
    (dist [R, k] in xu's dtype, idx [R, k] int32)."""
    n = xu.shape[0]
    row_ids = torch.arange(n, device=xu.device)
    if rows is not None:
        row_ids = row_ids[rows]
    eps_t = torch.as_tensor(eps, dtype=xu.dtype)
    cols = torch.arange(n, device=xu.device)
    step = max(1, _PLAIN_CHUNK_ELEMS // max(n, 1))
    out_d, out_i = [], []
    for s in range(0, row_ids.shape[0], step):
        r = row_ids[s:s + step]
        d = 1.0 - torch.clamp_min(xu[r] @ xu.T, 0.0)
        d = d.masked_fill((cols[None, :] == r[:, None]) | (d > eps_t),
                          INF_DIST)
        d, order = torch.sort(d, dim=1, stable=True)
        d, order = d[:, :k], order[:, :k]
        out_d.append(d)
        out_i.append(torch.where(d < INF_DIST, order, -1).to(torch.int32))
    if not out_d:
        return (xu.new_empty((0, k)),
                torch.empty((0, k), dtype=torch.int32, device=xu.device))
    return torch.cat(out_d), torch.cat(out_i)


def _lib():
    lib = _build.load("knn")
    lib.knn_launch.restype = ctypes.c_int
    lib.knn_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return lib


def knn_scan(xu: torch.Tensor, k: int, eps: float, row_start: int = 0,
             row_count: int | None = None):
    """(dist [R, k], idx [R, k] int32) for rows [row_start, row_start + R)
    of the unit corpus ``xu`` [N, F] against all N columns."""
    global LAUNCHES
    if xu.dim() != 2:
        raise ValueError(f"xu must be [N, F], got shape {tuple(xu.shape)}")
    n, f = xu.shape
    if row_count is None:
        row_count = n - row_start
    if not (0 <= row_start and row_count >= 0 and row_start + row_count <= n):
        raise ValueError(f"row range [{row_start}, {row_start + row_count}) "
                         f"outside [0, {n})")
    if xu.device.type == "cpu":
        return knn_plain(xu, k, eps, slice(row_start, row_start + row_count))
    if xu.device.type != "cuda":
        raise ValueError(f"unsupported device {xu.device}")
    if xu.dtype != torch.float32:
        raise TypeError(f"the k-NN kernel takes float32, got {xu.dtype}")
    if not xu.is_contiguous():
        raise ValueError("the k-NN kernel takes a contiguous corpus")
    if k < 1:
        raise ValueError(f"the k-NN kernel takes k >= 1, got {k}")
    if (n == 0 or f == 0 or n >= 2 ** 31 // max(f, 1)
            or row_count >= 2 ** 31 // k):
        raise ValueError(f"unsupported corpus shape {tuple(xu.shape)}")
    out_d = torch.empty((row_count, k), dtype=torch.float32, device=xu.device)
    out_i = torch.empty((row_count, k), dtype=torch.int32, device=xu.device)
    if row_count == 0:
        return out_d, out_i
    lib = _lib()
    stream = torch.cuda.current_stream(xu.device).cuda_stream
    err = lib.knn_launch(xu.data_ptr(), n, f, row_start, row_count,
                         float(eps), k, out_d.data_ptr(), out_i.data_ptr(),
                         xu.device.index or 0, stream)
    _build.check(lib, "knn", err)
    LAUNCHES += 1
    return out_d, out_i
