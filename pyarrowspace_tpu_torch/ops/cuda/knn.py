"""K1: the exact eps/k-NN scan — the CUDA kernel's wrapper and its plain
PyTorch version.

``knn_scan`` is the entry point.  On a CPU tensor it runs ``knn_plain``;
on a CUDA tensor it launches ``csrc/knn.cu`` (built at first use) or
raises.  Both return, for each row of a row range, the k smallest
rectified-cosine distances d = 1 - max(0, x_i . x_j) over the columns
[col_start, N) with self and d > eps masked, ascending by (distance, id);
missing entries are (2.0, -1).  The options of the kernel: ``seed`` (start
each row from a sorted list), ``diag_start`` (a rotated column walk) and
``perm`` (a corpus sorted for locality); every one returns the default
scan's result bit for bit.  Lists past ``WIDE_K`` entries take the
kernel's wide route (csrc/knn_wide.cuh); ``plan_splits`` splits the column
walk across blocks when the row blocks leave SMs idle.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from .scan_topk import fit_scratch, scratch_words, sm_count, wave_splits

INF_DIST = 2.0
# The kernel's running lists: up to WIDE_K entries in shared memory; longer
# ones take the wide route.  A walk split across blocks writes partial lists
# of 8-byte entries ([splits, rows, k], with a wide list's staging rows held
# to scan_topk.SCRATCH_BYTES), merged by a second launch; the wide route
# always does.
WIDE_K = 128
_TILE = 128      # rows per block and columns per tile
# Keys a wide-route row stages in device memory before they are merged into
# its partial list (csrc/knn_wide.cuh STAGE).
_STAGE = 896

# Kernel launches since import (or since the caller last reset it), the
# launches among them that used each option, and the launches whose column
# walk was split.
LAUNCHES = 0
SEEDED_LAUNCHES = 0
DIAG_START_LAUNCHES = 0
PERM_LAUNCHES = 0
SPLIT_LAUNCHES = 0

# The plain version's products: every distance comes from a product
# [_ROW_BLOCK, F] x [F, W], zero padded, with W = N rounded up to a multiple
# of _ROW_BLOCK and at most _COL_TILE.  A CPU matmul rounds an element
# differently by the shape of the product: a one-row product is a
# matrix-vector call, and at a wide F a product narrower than 256 columns
# sums in another order.  So the extend's bit-for-bit equality with a
# rebuild on the CPU rests on a property of the BLAS: at _ROW_BLOCK rows
# and a given F, an element's bits depend neither on where its two rows
# sit in the product nor on a width W >= 256, with any number of threads.
# tests/test_torch_extend.py holds it to that.
_ROW_BLOCK, _COL_TILE = 256, 4096


def _padded_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    if x.shape[0] == rows:
        return x
    return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[0]))


def _cosines(rows: torch.Tensor, cols: torch.Tensor, c0: int,
             tile: int) -> torch.Tensor:
    """rows [R <= _ROW_BLOCK, F] against cols[c0:] -> [R, N - c0], in
    products [_ROW_BLOCK, F] x [F, tile]."""
    r, n = rows.shape[0], cols.shape[0]
    a = _padded_rows(rows, _ROW_BLOCK)
    out = [(a @ _padded_rows(cols[t0:t0 + tile], tile).T)[:r, :n - t0]
           for t0 in range(c0, n, tile)]
    return torch.cat(out, dim=1) if out else a.new_empty((r, 0))


def knn_plain(xu: torch.Tensor, k: int, eps: float, rows=None,
              col_start: int = 0, seed=None, perm=None):
    """Fixed-shape products + mask + stable sort, _ROW_BLOCK rows at a time.

    ``rows`` selects the rows to answer (a slice or an index tensor;
    default all), ``col_start`` the first column.  ``seed`` = (d, i)
    [R, k'] sorted lists holding ids below col_start only: each row's list
    is the stable sort of its seed list followed by the new columns, so
    equal distances keep the smaller ids.  ``perm``: xu is a corpus
    permuted by it; the columns are taken back to their original ids before
    the sort and the lists come out indexed by original row ([N, k], rows
    outside ``rows`` left (2.0, -1)).  Returns (dist [R, k] in xu's dtype,
    idx [R, k] int32)."""
    n = xu.shape[0]
    dev = xu.device
    row_ids = torch.arange(n, device=dev)
    if rows is not None:
        row_ids = row_ids[rows]
    eps_t = torch.as_tensor(eps, dtype=xu.dtype)
    col_ids = torch.arange(col_start, n, device=dev)
    if perm is not None:
        perm = perm.to(device=dev, dtype=torch.int64)
        inv = torch.argsort(perm)       # original id -> permuted column
    tile = min(_COL_TILE, -(-max(n, 1) // _ROW_BLOCK) * _ROW_BLOCK)
    out_d, out_i = [], []
    for s in range(0, row_ids.shape[0], _ROW_BLOCK):
        r = row_ids[s:s + _ROW_BLOCK]
        d = 1.0 - torch.clamp_min(_cosines(xu[r], xu, col_start, tile), 0.0)
        self_ids = r
        if perm is not None:
            d, self_ids = d[:, inv], perm[r]
        d = d.masked_fill((col_ids[None, :] == self_ids[:, None])
                          | (d > eps_t), INF_DIST)
        ids = col_ids.expand(d.shape[0], -1)
        if seed is not None:
            d = torch.cat([seed[0][s:s + _ROW_BLOCK].to(d.dtype), d], dim=1)
            ids = torch.cat([seed[1][s:s + _ROW_BLOCK].to(ids.dtype), ids],
                            dim=1)
        if d.shape[1] < k:
            d = torch.nn.functional.pad(d, (0, k - d.shape[1]),
                                        value=INF_DIST)
            ids = torch.nn.functional.pad(ids, (0, k - ids.shape[1]),
                                          value=-1)
        d, order = torch.sort(d, dim=1, stable=True)
        d = d[:, :k]
        i = torch.gather(ids, 1, order[:, :k])
        out_d.append(d)
        out_i.append(torch.where(d < INF_DIST, i, -1).to(torch.int32))
    d = torch.cat(out_d) if out_d else xu.new_empty((0, k))
    i = (torch.cat(out_i) if out_i
         else torch.empty((0, k), dtype=torch.int32, device=dev))
    if perm is None:
        return d, i
    full_d = torch.full((n, k), INF_DIST, dtype=xu.dtype, device=dev)
    full_i = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    full_d[perm[row_ids]] = d
    full_i[perm[row_ids]] = i
    return full_d, full_i


def knn_plain_reordered(xu: torch.Tensor, k: int, eps: float,
                        perm: torch.Tensor):
    """The reorder variant's plain version: permute the corpus by ``perm``,
    scan it, map the columns to their original ids, sort each row by
    (distance, original id) and un-permute the rows: the default scan's
    result on any data, ties included."""
    return knn_plain(xu[perm.to(device=xu.device, dtype=torch.int64)], k,
                     eps, perm=perm)


def plan_splits(row_count: int, n_cols: int, k: int, device,
                narrow: bool = True) -> tuple[int, int]:
    """(splits, rows a launch) for row_count rows against n_cols columns:
    the fewest column splits whose grid of 128-row blocks fills its last
    wave of SMs to 90% (one split once the row blocks do), then the partial
    lists [splits, rows, k] held to the scratch cap by fewer splits and then
    row chunks (scan_topk.fit_scratch; a wide list's staging rows count
    with its partial lists).  A list of up to WIDE_K entries
    splits only if ``narrow`` (K1's narrow kernel takes splits, K1t's does
    not)."""
    if k <= WIDE_K and not narrow:
        return 1, row_count
    n_tiles = -(-n_cols // _TILE)
    want = wave_splits(n_tiles, -(-row_count // _TILE),
                       sm_count(device.index or 0))
    return fit_scratch(n_tiles, want, row_count,
                       k + (_STAGE if k > WIDE_K else 0))


def route_name(row_count: int, n_cols: int, k: int, device,
               narrow: bool = True) -> str:
    """The route of such a launch: "narrow" or "wide", and "/S<splits>"."""
    splits = plan_splits(row_count, n_cols, k, device, narrow)[0]
    return f"{'narrow' if k <= WIDE_K else 'wide'}/S{splits}"


def scratch(row_count: int, n_cols: int, k: int, device,
            narrow: bool = True):
    """(splits, rows a launch, scratch) of a scan: with several splits or a
    wide list, in 8-byte words, the partial lists [splits, rows, k], each
    row's bound shared by its splits and, for a wide list, the staging rows
    [splits, rows, _STAGE]; else None."""
    splits, chunk = plan_splits(row_count, n_cols, k, device, narrow)
    part = None
    if splits > 1 or k > WIDE_K:
        words = scratch_words(splits, min(chunk, row_count), k,
                              _STAGE if k > WIDE_K else 0)
        part = torch.empty((words, 2), dtype=torch.int32, device=device)
    return splits, chunk, part


def _lib():
    lib = _build.load("knn")
    lib.knn_launch.restype = ctypes.c_int
    lib.knn_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p]
    return lib


def check_corpus(xu: torch.Tensor, k: int, row_start: int,
                 row_count: int | None, kernel: str = "k-NN") -> int:
    """Validate a scan's corpus and row range; returns the row count.  On
    a CUDA tensor also the kernels' type, layout and size limits."""
    if xu.dim() != 2:
        raise ValueError(f"xu must be [N, F], got shape {tuple(xu.shape)}")
    n, f = xu.shape
    if row_count is None:
        row_count = n - row_start
    if not (0 <= row_start and row_count >= 0 and row_start + row_count <= n):
        raise ValueError(f"row range [{row_start}, {row_start + row_count}) "
                         f"outside [0, {n})")
    if xu.device.type == "cpu":
        return row_count
    if xu.device.type != "cuda":
        raise ValueError(f"unsupported device {xu.device}")
    if xu.dtype != torch.float32:
        raise TypeError(f"the {kernel} kernel takes float32, got {xu.dtype}")
    if not xu.is_contiguous():
        raise ValueError(f"the {kernel} kernel takes a contiguous corpus")
    if k < 1:
        raise ValueError(f"the {kernel} kernel takes k >= 1, got {k}")
    if (n == 0 or f == 0 or n >= 2 ** 31 // max(f, 1)
            or row_count >= 2 ** 31 // k):
        raise ValueError(f"unsupported corpus shape {tuple(xu.shape)}")
    return row_count


def knn_scan(xu: torch.Tensor, k: int, eps: float, row_start: int = 0,
             row_count: int | None = None, *, col_start: int = 0, seed=None,
             diag_start: bool = False, perm: torch.Tensor | None = None):
    """(dist [R, k], idx [R, k] int32) for rows [row_start, row_start + R)
    of the unit corpus ``xu`` [N, F] against the columns [col_start, N).

    ``seed`` = (d, i) [R, k] sorted lists whose ids are all below
    col_start (the stored lists of the rows, for the extend).
    ``diag_start`` walks each row block's columns from its own tile.
    ``perm``: xu is the corpus permuted by it (int32 or int64, on xu's
    device); the result is then [N, k] indexed by original row, with the
    rows outside perm[row_start:row_start + R] left (2.0, -1)."""
    n = xu.shape[0] if xu.dim() == 2 else 0
    row_count = check_corpus(xu, k, row_start, row_count)
    if not 0 <= col_start <= n:
        raise ValueError(f"col_start {col_start} outside [0, {n}]")
    if seed is not None and (perm is not None or seed[0].shape[0] != row_count
                             or seed[0].shape != seed[1].shape):
        raise ValueError("seed lists must be [R, k] pairs, without perm")
    if perm is not None and (perm.shape != (n,) or col_start != 0):
        raise ValueError("perm must be [N] with col_start 0")
    if seed is not None and seed[0].shape[1] != k:
        raise ValueError(f"seed lists must be {k} wide, got "
                         f"{seed[0].shape[1]}")
    rows = slice(row_start, row_start + row_count)
    if xu.device.type == "cpu":
        return knn_plain(xu, k, eps, rows, col_start, seed, perm)
    shape = (n if perm is not None else row_count, k)
    out_d = torch.full(shape, INF_DIST, dtype=torch.float32, device=xu.device)
    out_i = torch.full(shape, -1, dtype=torch.int32, device=xu.device)
    if seed is not None:
        out_d.copy_(seed[0])
        out_i.copy_(seed[1])
    if row_count == 0 or col_start == n:
        return out_d, out_i
    perm32 = None
    if perm is not None:
        perm32 = perm.to(device=xu.device, dtype=torch.int32).contiguous()
    _launch(xu.data_ptr(), n, xu.shape[1], row_start, row_count, eps, k,
            col_start, diag_start, perm32, seed is not None, out_d, out_i,
            xu.device)
    return out_d, out_i


def _launch(base: int, n: int, f: int, row_start: int, row_count: int,
            eps: float, k: int, col_start: int, diag_start: bool, perm32,
            seeded: bool, out_d: torch.Tensor, out_i: torch.Tensor,
            device: torch.device) -> None:
    """K1's launches for rows [row_start, row_start + row_count) of the
    float32 rows at address ``base`` ([n, f]) against the columns
    [col_start, n), in row chunks when the scratch asks for them."""
    global LAUNCHES, SEEDED_LAUNCHES, DIAG_START_LAUNCHES, PERM_LAUNCHES
    global SPLIT_LAUNCHES
    splits, chunk, part = scratch(row_count, n - col_start, k, device)
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    for s in range(0, row_count, chunk):
        rc = min(chunk, row_count - s)
        at = 0 if perm32 is not None else s   # the chunk's first output row
        err = lib.knn_launch(
            base, n, f, row_start + s, rc, float(eps), k, col_start,
            int(diag_start),
            perm32.data_ptr() if perm32 is not None else None,
            int(seeded), splits,
            part.data_ptr() if part is not None else None,
            out_d[at:].data_ptr(), out_i[at:].data_ptr(),
            device.index or 0, stream)
        _build.check(lib, "knn", err)
        LAUNCHES += 1
        SEEDED_LAUNCHES += seeded
        DIAG_START_LAUNCHES += bool(diag_start)
        PERM_LAUNCHES += perm32 is not None
        SPLIT_LAUNCHES += splits > 1


def visit_plain(buf: torch.Tensor, n_loc: int, row_count: int,
                col_count: int, k: int, eps: float, *, row_id0: int,
                col_id0: int, seed=None):
    """The plain version of ``knn_visit``: the products in K1's plain
    shapes (``_cosines``), the mask, and each row's lexicographic
    (distance, id) top-k of its seed list and the block's columns."""
    rows = buf[:row_count]
    cols = buf[:col_count] if buf.shape[0] == n_loc else \
        buf[n_loc:n_loc + col_count]
    dev = buf.device
    eps_t = torch.as_tensor(eps, dtype=buf.dtype)
    col_ids = col_id0 + torch.arange(col_count, device=dev)
    tile = min(_COL_TILE, -(-max(col_count, 1) // _ROW_BLOCK) * _ROW_BLOCK)
    out_d, out_i = [], []
    for s in range(0, row_count, _ROW_BLOCK):
        r_ids = row_id0 + torch.arange(s, min(s + _ROW_BLOCK, row_count),
                                       device=dev)
        d = 1.0 - torch.clamp_min(_cosines(rows[s:s + _ROW_BLOCK], cols, 0,
                                           tile), 0.0)
        d = d.masked_fill((col_ids[None, :] == r_ids[:, None]) | (d > eps_t),
                          INF_DIST)
        ids = col_ids.expand(d.shape[0], -1)
        if seed is not None:
            d = torch.cat([seed[0][s:s + _ROW_BLOCK].to(d.dtype), d], dim=1)
            ids = torch.cat([seed[1][s:s + _ROW_BLOCK].to(ids.dtype), ids],
                            dim=1)
        if d.shape[1] < k:
            d = torch.nn.functional.pad(d, (0, k - d.shape[1]),
                                        value=INF_DIST)
            ids = torch.nn.functional.pad(ids, (0, k - ids.shape[1]),
                                          value=-1)
        order = torch.sort(ids, dim=1, stable=True).indices
        d, ids = torch.gather(d, 1, order), torch.gather(ids, 1, order)
        d, order = torch.sort(d, dim=1, stable=True)
        d = d[:, :k]
        i = torch.gather(ids, 1, order[:, :k])
        out_d.append(d)
        out_i.append(torch.where(d < INF_DIST, i, -1).to(torch.int32))
    if not out_d:
        return (buf.new_empty((0, k)),
                torch.empty((0, k), dtype=torch.int32, device=dev))
    return torch.cat(out_d), torch.cat(out_i)


def knn_visit(buf: torch.Tensor, n_loc: int, row_count: int, col_count: int,
              k: int, eps: float, *, row_id0: int, col_id0: int, seed=None):
    """K1 over one block of a ring: (dist [R, k], idx [R, k] int32) of the
    rows buf[:R] (global ids row_id0 + r, R = row_count) against C =
    col_count columns with global ids col_id0 + c, merged with ``seed`` =
    (d, i) [R, k] sorted lists (any ids) into each row's lexicographic
    (distance, id) top-k, the same lists a scan of the whole corpus gives.

    ``buf`` is contiguous: either [n_loc, F], the self block (the columns
    are buf[:C] themselves, row_id0 == col_id0, self pairs masked), or
    [2 n_loc, F], a visiting block (columns buf[n_loc:n_loc + C], no
    self pair).  On a CUDA tensor the launch addresses buf so that its
    rows carry kernel ids g + n_loc (g the global id, so every id is
    positive and a visiting block lies above the rows): the rows' base
    address less (row id) * F floats, an address never read below buf.
    The kernel's columns are then [col_id0 + n_loc, col_id0 + n_loc + C),
    its seeded lists take the lexicographic merge, and the ids come back
    shifted down by n_loc."""
    two = buf.shape[0] == 2 * n_loc
    if buf.dim() != 2 or not (two or buf.shape[0] == n_loc):
        raise ValueError(f"buf must be [n_loc or 2 n_loc, F], got "
                         f"{tuple(buf.shape)} with n_loc {n_loc}")
    if not (0 <= row_count <= n_loc and 0 <= col_count <= n_loc):
        raise ValueError("row_count and col_count must lie in [0, n_loc]")
    if not two and (row_id0 != col_id0 or row_count > col_count):
        raise ValueError("a self block has row_id0 == col_id0 and its rows "
                         "among its columns")
    if seed is not None and (seed[0].shape != (row_count, k)
                             or seed[1].shape != (row_count, k)):
        raise ValueError(f"seed lists must be [{row_count}, {k}] pairs")
    if buf.device.type == "cpu":
        return visit_plain(buf, n_loc, row_count, col_count, k, eps,
                           row_id0=row_id0, col_id0=col_id0, seed=seed)
    check_corpus(buf, k, 0, row_count)
    out_d = torch.full((row_count, k), INF_DIST, dtype=torch.float32,
                       device=buf.device)
    out_i = torch.full((row_count, k), -1, dtype=torch.int32,
                       device=buf.device)
    if seed is not None:
        out_d.copy_(seed[0])
        out_i.copy_(torch.where(seed[1] >= 0, seed[1] + n_loc, -1))
    if row_count == 0 or col_count == 0:
        return out_d, seed[1].clone() if seed is not None else out_i
    f = buf.shape[1]
    col_start = col_id0 + n_loc
    row_start = col_start - (n_loc if two else 0)
    n = col_start + col_count
    if n >= 2 ** 31 // max(f, 1):
        raise ValueError(f"ring ids up to {n} x F {f} pass the kernel's "
                         "int32 offsets")
    base = buf.data_ptr() - row_start * f * buf.element_size()
    _launch(base, n, f, row_start, row_count, eps, k, col_start, False, None,
            seed is not None, out_d, out_i, buf.device)
    return out_d, torch.where(out_i >= 0, out_i - n_loc, -1)
