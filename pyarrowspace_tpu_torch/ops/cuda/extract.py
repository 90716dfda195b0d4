"""K4a and K4b: per-row top-m extraction of subtile serving — the CUDA
kernels' wrappers and their plain PyTorch versions.

``extract_ids`` (K4b, the one-level top-S subtile select) returns, per row
of a score matrix, the columns of its m greatest values; ``extract_pool``
(K4a, the pool cut and the two-level select) returns the ids of a cand
matrix at the row's m greatest values.  Both order a row by (value desc,
id asc), ids compared as signed int32, over a total order of the values:
-0.0 equals +0.0, -inf and +inf are ordinary values, and NaN ranks below
every number (NaNs tie, by id).  On the TPU kernels' contract (distinct
ids in a row, every value a number above -3e38) that is the top-m their
sequential extraction takes.  On CPU tensors they run the plain versions;
on CUDA tensors they launch ``csrc/extract_topm.cu`` (built at first use)
or raise.

The kernels' routes (``route_name``, the one predicate, which the C
launchers check): "narrow" (the row in shared memory, m <= 64: a
group-maximum threshold and a sort of the candidates), "radix" (the row in
shared memory, a radix select) and "device" (a row and buffer too large for
shared memory, through device memory).  A row in shared memory arrives by
one bulk copy when it is 16-byte aligned and a multiple of 16 bytes long
(``load_name``), else by 4-byte loads.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build

# csrc/select.cuh's NARROW_MAX and NARROW_CAP, and extract_topm.cu's
# MAX_DYNAMIC: the shared memory a block of the shared-memory routes takes.
NARROW_MAX = 64
_NARROW_CAP = 256
_MAX_DYNAMIC = 232448 - 4096
ROUTES = ("narrow", "radix", "device")
# The device route's buffers [rows, pow2(m)] of 64-bit words are held to
# this many bytes a launch; rows go in chunks past it.
SCRATCH_BYTES = 1 << 30

# Kernel launches since import (or since the caller last reset them): by
# kernel, and both kernels' by route.
IDS_LAUNCHES = 0
POOL_LAUNCHES = 0
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)


def order_keys(score: torch.Tensor) -> torch.Tensor:
    """Signed integer keys of a float tensor (int32 for float32) whose
    order is the kernels' order of the values: -0.0 and +0.0 one key, NaN
    the least key (below -inf's), each number's key its bits with the
    magnitude bits flipped when negative."""
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
        score.element_size()]
    info = torch.iinfo(ints)
    bits = torch.where(score == 0, torch.zeros_like(score), score)
    bits = bits.contiguous().view(ints)
    keys = torch.where(bits < 0, bits ^ info.max, bits)
    return torch.where(score.isnan(), info.min, keys)


def extract_ids_plain(score: torch.Tensor, m: int) -> torch.Tensor:
    """Stable descending sort of the order keys: ties keep the smaller
    column first."""
    order = torch.sort(order_keys(score), dim=1, descending=True,
                       stable=True).indices
    return order[:, :m].to(torch.int32)


def extract_pool_plain(score: torch.Tensor, cand: torch.Tensor,
                       m: int) -> torch.Tensor:
    """Lexicographic sort on (order key desc, cand asc): by cand first,
    then a stable descending sort by key."""
    by_id = torch.sort(cand, dim=1, stable=True).indices
    k1 = torch.gather(order_keys(score), 1, by_id)
    c1 = torch.gather(cand, 1, by_id)
    order = torch.sort(k1, dim=1, descending=True, stable=True).indices
    return torch.gather(c1, 1, order[:, :m]).to(torch.int32)


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def route_name(length: int, m: int) -> str:
    """The route of rows of ``length`` entries and lists of m:
    extract_topm.cu's route_of (row keys and a buffer of pow2(m) entries,
    at least 256 for narrow m, within shared memory, else "device")."""
    narrow = m <= NARROW_MAX
    entries = max(_pow2(m), _NARROW_CAP if narrow else 0)
    smem = 4 * (-(-length // 4) * 4) + 8 * entries
    if smem > _MAX_DYNAMIC:
        return "device"
    return "narrow" if narrow else "radix"


def load_name(score: torch.Tensor) -> str:
    """How a shared-memory route brings a row in: "bulk" (one 1-D bulk
    copy) or "scalar" (4-byte loads)."""
    aligned = score.shape[1] % 4 == 0 and score.data_ptr() % 16 == 0
    return "bulk" if aligned else "scalar"


def _lib():
    lib = _build.load("extract_topm")
    lib.extract_ids_launch.restype = ctypes.c_int
    lib.extract_ids_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p]
    lib.extract_pool_launch.restype = ctypes.c_int
    lib.extract_pool_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p]
    return lib


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


def _launch(score: torch.Tensor, cand, m: int) -> torch.Tensor:
    """One launch a chunk of rows (one chunk but on the device route),
    K4a with cand, K4b without; counts each launch by kernel and route."""
    global IDS_LAUNCHES, POOL_LAUNCHES
    rows, length = score.shape
    out = torch.empty((rows, m), dtype=torch.int32, device=score.device)
    if rows == 0:
        return out
    route = route_name(length, m)
    code = ROUTES.index(route)
    lib = _lib()
    chunk = rows
    if route == "device":
        chunk = max(1, min(rows, SCRATCH_BYTES // (8 * _pow2(m))))
    scratch = None
    if route == "device":
        scratch = torch.empty((chunk, _pow2(m)), dtype=torch.int64,
                              device=score.device)
    stream = torch.cuda.current_stream(score.device).cuda_stream
    dev = score.device.index or 0
    scratch_ptr = None if scratch is None else scratch.data_ptr()
    for r0 in range(0, rows, chunk):
        n = min(chunk, rows - r0)
        s_ptr = score[r0].data_ptr()
        o_ptr = out[r0].data_ptr()
        if cand is None:
            err = lib.extract_ids_launch(s_ptr, n, length, m, code,
                                         scratch_ptr, o_ptr, dev, stream)
        else:
            err = lib.extract_pool_launch(s_ptr, cand[r0].data_ptr(), n,
                                          length, m, code, scratch_ptr,
                                          o_ptr, dev, stream)
        _build.check(lib, "extract_topm", err)
        if cand is None:
            IDS_LAUNCHES += 1
        else:
            POOL_LAUNCHES += 1
        ROUTE_LAUNCHES[route] += 1
    return out


def extract_ids(score: torch.Tensor, m: int) -> torch.Tensor:
    """K4b: [rows, m] int32 columns of each row's m greatest values of
    ``score`` [rows, M], in (value desc, column asc) order."""
    _check(score, m)
    if score.device.type == "cpu":
        return extract_ids_plain(score, m)
    return _launch(score, None, m)


def extract_pool(score: torch.Tensor, cand: torch.Tensor,
                 m: int) -> torch.Tensor:
    """K4a: [rows, m] int32 ids from ``cand`` at each row's m greatest
    values of ``score`` (both [rows, M], ids distinct within a row), in
    (value desc, id asc) order."""
    _check(score, m, cand)
    if score.device.type == "cpu":
        return extract_pool_plain(score, cand, m)
    return _launch(score, cand, m)
