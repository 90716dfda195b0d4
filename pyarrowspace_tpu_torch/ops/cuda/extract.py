"""K4a and K4b: per-row top-m extraction of subtile serving — the CUDA
kernels' wrappers and their plain PyTorch versions.

``extract_ids`` (K4b, the one-level top-S subtile select) returns, per row
of a score matrix, the columns of its m largest values; ``extract_pool``
(K4a, the pool cut and the two-level select) returns the ids of a cand
matrix at the row's m largest values.  Both order a row by (value desc,
id asc): the sequential extraction of the TPU kernels, whose contract
(distinct ids in a row, every value above -3e38) makes it that top-m.
On CPU tensors they run the plain versions; on CUDA tensors they launch
``csrc/extract_topm.cu`` (built at first use) or raise.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build

# The kernels' running lists: up to 256 entries in shared memory, longer
# ones in place in the output row and a scratch row of values.
_MAX_NARROW = 256

# Kernel launches since import (or since the caller last reset them).
IDS_LAUNCHES = 0
POOL_LAUNCHES = 0


def extract_ids_plain(score: torch.Tensor, m: int) -> torch.Tensor:
    """Stable descending sort: ties keep the smaller column first."""
    order = torch.sort(score, dim=1, descending=True, stable=True).indices
    return order[:, :m].to(torch.int32)


def extract_pool_plain(score: torch.Tensor, cand: torch.Tensor,
                       m: int) -> torch.Tensor:
    """Lexicographic sort on (-score, cand): by cand first, then a stable
    descending sort by score."""
    by_id = torch.sort(cand, dim=1, stable=True).indices
    s1 = torch.gather(score, 1, by_id)
    c1 = torch.gather(cand, 1, by_id)
    order = torch.sort(s1, dim=1, descending=True, stable=True).indices
    return torch.gather(c1, 1, order[:, :m]).to(torch.int32)


def _lib():
    lib = _build.load("extract_topm")
    lib.extract_ids_launch.restype = ctypes.c_int
    lib.extract_ids_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.extract_pool_launch.restype = ctypes.c_int
    lib.extract_pool_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p]
    return lib


def _scratch(rows: int, m: int, device) -> torch.Tensor | None:
    """The values of wide lists (m > 256); narrow lists need none."""
    if m <= _MAX_NARROW:
        return None
    return torch.empty((rows, m), dtype=torch.float32, device=device)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _check(score: torch.Tensor, m: int, cand=None) -> None:
    if score.dim() != 2:
        raise ValueError(f"score must be [rows, M], got {tuple(score.shape)}")
    if cand is not None and cand.shape != score.shape:
        raise ValueError(f"cand {tuple(cand.shape)} must match score "
                         f"{tuple(score.shape)}")
    if not 1 <= m <= score.shape[1]:
        raise ValueError(f"m={m} must be in [1, {score.shape[1]}]")
    if score.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {score.device}")
    if score.device.type == "cpu":
        return
    if cand is not None and cand.device != score.device:
        raise ValueError(f"score on {score.device}, cand on {cand.device}")
    if score.dtype != torch.float32:
        raise TypeError(f"the extract kernel takes float32 scores, got "
                        f"{score.dtype}")
    if cand is not None and cand.dtype != torch.int32:
        raise TypeError(f"the extract kernel takes int32 ids, got "
                        f"{cand.dtype}")
    if not score.is_contiguous() or (cand is not None
                                     and not cand.is_contiguous()):
        raise ValueError("the extract kernel takes contiguous rows")
    if score.numel() >= 2 ** 31:
        raise ValueError(f"unsupported shape {tuple(score.shape)}")


def extract_ids(score: torch.Tensor, m: int) -> torch.Tensor:
    """K4b: [rows, m] int32 columns of each row's m largest values of
    ``score`` [rows, M], ties to the smaller column."""
    global IDS_LAUNCHES
    _check(score, m)
    if score.device.type == "cpu":
        return extract_ids_plain(score, m)
    rows, length = score.shape
    out = torch.empty((rows, m), dtype=torch.int32, device=score.device)
    if rows == 0:
        return out
    scratch = _scratch(rows, m, score.device)
    lib = _lib()
    stream = torch.cuda.current_stream(score.device).cuda_stream
    err = lib.extract_ids_launch(score.data_ptr(), rows, length, m,
                                 _ptr(scratch), out.data_ptr(),
                                 score.device.index or 0, stream)
    _build.check(lib, "extract_topm", err)
    IDS_LAUNCHES += 1
    return out


def extract_pool(score: torch.Tensor, cand: torch.Tensor,
                 m: int) -> torch.Tensor:
    """K4a: [rows, m] int32 ids from ``cand`` at each row's m largest
    values of ``score`` (both [rows, M], ids distinct within a row), ties
    to the smaller id."""
    global POOL_LAUNCHES
    _check(score, m, cand)
    if score.device.type == "cpu":
        return extract_pool_plain(score, cand, m)
    rows, length = score.shape
    out = torch.empty((rows, m), dtype=torch.int32, device=score.device)
    if rows == 0:
        return out
    scratch = _scratch(rows, m, score.device)
    lib = _lib()
    stream = torch.cuda.current_stream(score.device).cuda_stream
    err = lib.extract_pool_launch(score.data_ptr(), cand.data_ptr(), rows,
                                  length, m, _ptr(scratch), out.data_ptr(),
                                  score.device.index or 0, stream)
    _build.check(lib, "extract_topm", err)
    POOL_LAUNCHES += 1
    return out
