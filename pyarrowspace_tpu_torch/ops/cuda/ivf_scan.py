"""K6: the blocked-IVF probe scan — the CUDA kernel's wrapper and its plain
PyTorch version.

``ivf_scan`` is the port of ``_ivf_scan`` (pyarrowspace_tpu/ops/pallas/
ivf_scan.py).  Queries come sorted and padded to blocks of ``q_block``;
block b scans the slabs of the clusters in ``probe[b]`` and keeps, per
query, the k best ``tau * (qn . slab_row) + (1 - tau) / (1 + |lam_row -
lamq|)`` in lexicographic (score desc, id asc) order, padding rows (id < 0)
scored -3e38; unfilled slots are (-3e38, -1).  Slabs may be float32,
bfloat16 or float16: rows are upcast exactly and queries stay float32, the
precision the certificates assume.  On CPU tensors it runs
``ivf_scan_plain``; on CUDA tensors it launches ``csrc/ivf_scan.cu`` (built
at first use) or raises.

A padded row scores -3e38 with id -1 and so never displaces an unfilled
slot: the kernel walks, in each probed cluster, only the 64-row tiles up to
the cluster's last real row (``slab_tiles``), and its results are those of
the whole slabs.

Two routes for the running lists (``route_name``): "narrow" lists (k <=
256) live in shared memory and take each survivor by a warp-wide
insertion; "wide" ones (past 256) take csrc/knn_wide.cuh's staged, sorted
merge: each query stages its survivors' keys in a row of ``SROW`` keys
that this wrapper allocates in device memory, and a full row is sorted and
merged into the query's list in the output rows in one pass.
``WIDE_LAUNCHES`` counts the launches of the wide route.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build

NEG_INF = -3.0e38
# At most MAX_Q_BLOCK queries a block.  The kernel's running lists: up to
# _NARROW_MAX entries in shared memory (they fit beside the stages at every
# q_block, csrc/ivf_scan.cu asserts it); longer ones staged, SROW keys a
# query (csrc/knn_wide.cuh SROW), and merged into the output rows.
MAX_Q_BLOCK = 32
_CAP_MULTIPLE = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_NARROW_MAX = 256
SROW = 512

# Kernel launches since import (or since the caller last reset it): all
# of them, and those of the wide route.
LAUNCHES = 0
WIDE_LAUNCHES = 0

# Plain version: query blocks per chunk keep the gathered float32 slab rows
# near this many elements.
_PLAIN_CHUNK_ELEMS = 1 << 26


def slab_tiles(slab_ids: torch.Tensor, cap: int) -> torch.Tensor:
    """int32 [K]: for each cluster of the slab layout (ids [K x cap], -1 on
    padding), the number of 64-row tiles up to and including its last real
    row, ceil((last + 1) / 64), 0 for an empty cluster.  The last real row,
    not the count of real rows: overflow items may sit in any free slot."""
    ids2 = slab_ids.view(-1, cap)
    pos = torch.arange(1, cap + 1, dtype=torch.int32, device=ids2.device)
    last = torch.amax(torch.where(ids2 >= 0, pos, 0), dim=1)
    return torch.div(last + (_CAP_MULTIPLE - 1), _CAP_MULTIPLE,
                     rounding_mode="floor").to(torch.int32)


def route_name(k: int) -> str:
    """The kernel's route for lists of k: "narrow" (k <= 256, in shared
    memory) or "wide" (the staged, sorted merge), whatever the query block
    and F."""
    return "narrow" if k <= _NARROW_MAX else "wide"


def staging_rows(q_pad: int, k: int, device):
    """The wide route's staging rows, int64 [q_pad, SROW] (a query's keys,
    4 KB) on device; None on the narrow route."""
    if route_name(k) == "narrow":
        return None
    return torch.empty((q_pad, SROW), dtype=torch.int64, device=device)


def ivf_scan_plain(slabs, slab_lambdas, slab_ids, qn, lamq, probe, tau, *,
                   k: int, q_block: int, cap: int, tiles=None):
    """Gather each block's probed slabs, multiply in float32, blend, mask,
    and take the lexicographic top-k (a sort by id, then a stable
    descending sort by score).  With ``tiles`` (int32 [K]) only the first
    tiles[c] 64-row tiles of each probed cluster c are candidates, as in
    the kernel.  As in the kernel, a score enters a list only if it beats
    the unfilled slot (-3e38, -1): a NaN (lambdas inf - inf) never does.
    Returns (scores [Q_pad, k] float32, ids [Q_pad, k] int32)."""
    n_blocks, n_probe = probe.shape
    f = slabs.shape[1]
    f32 = torch.float32
    slabs3 = slabs.view(-1, cap, f)
    lam2 = slab_lambdas.view(-1, cap)
    ids2 = slab_ids.view(-1, cap)
    if tiles is not None:
        walked = (torch.arange(cap, device=slabs.device)[None, :]
                  < _CAP_MULTIPLE * tiles.to(torch.int64)[:, None])
        ids2 = torch.where(walked, ids2, -1)
    tau_t = torch.as_tensor(tau, dtype=f32, device=slabs.device)
    width = n_probe * cap
    step = max(1, _PLAIN_CHUNK_ELEMS // (width * f))
    out_s, out_i = [], []
    for b0 in range(0, n_blocks, step):
        pr = probe[b0:b0 + step].to(torch.int64)
        nb = pr.shape[0]
        rows = slabs3[pr].reshape(nb, width, f).to(f32)
        qs = qn[b0 * q_block:(b0 + nb) * q_block].view(nb, q_block, f)
        cos = torch.bmm(qs.to(f32), rows.transpose(1, 2))
        lam = lam2[pr].reshape(nb, 1, width).to(f32)
        ids = ids2[pr].reshape(nb, 1, width)
        lq = lamq[b0 * q_block:(b0 + nb) * q_block].view(nb, q_block, 1)
        prox = 1.0 / (1.0 + torch.abs(lam - lq.to(f32)))
        score = tau_t * cos + (1.0 - tau_t) * prox
        score = torch.where((ids >= 0) & (score > NEG_INF), score, NEG_INF)
        by_id = torch.sort(ids, dim=2, stable=True).indices
        s1 = torch.gather(score, 2, by_id.expand(-1, q_block, -1))
        i1 = torch.gather(ids, 2, by_id).expand(-1, q_block, -1)
        vals, pos = torch.sort(s1, dim=2, descending=True, stable=True)
        vals = vals[:, :, :k]
        top = torch.gather(i1, 2, pos[:, :, :k])
        out_s.append(vals.reshape(nb * q_block, k))
        out_i.append(torch.where(vals > NEG_INF, top, -1)
                     .reshape(nb * q_block, k).to(torch.int32))
    return torch.cat(out_s), torch.cat(out_i)


def _lib():
    lib = _build.load("ivf_scan")
    lib.ivf_scan_launch.restype = ctypes.c_int
    lib.ivf_scan_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p]
    lib.ivf_scan_blocks_per_sm.restype = ctypes.c_int
    lib.ivf_scan_blocks_per_sm.argtypes = [ctypes.c_int] * 4
    return lib


def blocks_per_sm(k: int, q_block: int, dtype, device) -> int:
    """Resident blocks an SM of the kernel's launch of lists of k for
    blocks of q_block over slabs of dtype on the CUDA device (its
    occupancy, from the CUDA runtime)."""
    lib = _lib()
    n = lib.ivf_scan_blocks_per_sm(q_block, k, _DTYPE_CODES[dtype],
                                   torch.device(device).index or 0)
    if n < 0:
        _build.check(lib, "ivf_scan", -n)
    return n


def ivf_scan(slabs: torch.Tensor, slab_lambdas: torch.Tensor,
             slab_ids: torch.Tensor, qn: torch.Tensor, lamq: torch.Tensor,
             probe: torch.Tensor, tau, *, k: int, q_block: int, cap: int,
             tiles: torch.Tensor, merges: torch.Tensor | None = None):
    """(scores [Q_pad, k] float32, ids [Q_pad, k] int32) of the sorted,
    padded queries qn [Q_pad, F] / lamq [Q_pad] (Q_pad = n_blocks x
    q_block) over the slabs [K x cap, F] with their lambdas and ids
    [K x cap], block b probing the clusters probe[b] ([n_blocks, n_probe],
    each in [0, K), distinct within a row, as the routing makes them: a
    repeated probe walks its cluster again and its rows enter a list once
    for each time they are probed, as in the plain version).  tiles: the
    layout's ``slab_tiles`` (``BlockedIVF.slab_tiles``), int32 [K] on the
    slabs' device.  merges (the wide route on the card only): an int32
    [Q_pad] tensor that receives each query's count of merges."""
    global LAUNCHES, WIDE_LAUNCHES
    if slabs.dim() != 2 or qn.dim() != 2 or qn.shape[1] != slabs.shape[1]:
        raise ValueError(f"shapes slabs {tuple(slabs.shape)} / qn "
                         f"{tuple(qn.shape)} do not match")
    rows, f = slabs.shape
    if probe.dim() != 2 or cap <= 0 or rows % cap:
        raise ValueError(f"probe {tuple(probe.shape)} must be [n_blocks, "
                         f"n_probe] and {rows} slab rows a multiple of cap "
                         f"{cap}")
    n_blocks, n_probe = probe.shape
    q_pad = qn.shape[0]
    if q_pad != n_blocks * q_block or lamq.shape != (q_pad,):
        raise ValueError(f"{q_pad} queries / lamq {tuple(lamq.shape)} must "
                         f"be {n_blocks} blocks of {q_block}")
    if slab_lambdas.shape != (rows,) or slab_ids.shape != (rows,):
        raise ValueError(f"slab lambdas / ids must be [{rows}]")
    if not 1 <= k <= n_probe * cap:
        raise ValueError(f"k={k} must be in [1, {n_probe * cap}]")
    tensors = (slabs, slab_lambdas, slab_ids, qn, lamq, probe)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    device = slabs.device
    if (tiles.shape != (rows // cap,) or tiles.dtype != torch.int32
            or tiles.device != device or not tiles.is_contiguous()):
        raise ValueError(f"tiles must be a contiguous int32 [{rows // cap}] "
                         f"on {device}")
    if device.type == "cpu":
        if merges is not None:
            raise ValueError("merges counts the kernel's merges: CUDA "
                             "tensors only")
        return ivf_scan_plain(slabs, slab_lambdas, slab_ids, qn, lamq, probe,
                              tau, k=k, q_block=q_block, cap=cap,
                              tiles=tiles)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if slabs.dtype not in _DTYPE_CODES:
        raise TypeError(f"the IVF scan kernel takes float32, bfloat16 or "
                        f"float16 slabs, got {slabs.dtype}")
    for name, t, dtype in (("slab_lambdas", slab_lambdas, torch.float32),
                           ("slab_ids", slab_ids, torch.int32),
                           ("qn", qn, torch.float32),
                           ("lamq", lamq, torch.float32),
                           ("probe", probe, torch.int32)):
        if t.dtype != dtype:
            raise TypeError(f"the IVF scan kernel takes {dtype} {name}, "
                            f"got {t.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the IVF scan kernel takes contiguous tensors")
    if q_block > MAX_Q_BLOCK or cap % _CAP_MULTIPLE:
        raise ValueError(f"the IVF scan kernel takes q_block <= "
                         f"{MAX_Q_BLOCK} and cap a multiple of "
                         f"{_CAP_MULTIPLE}, got {q_block} and {cap}")
    if rows >= 2 ** 31 // max(f, 1) or q_pad >= 2 ** 31 // max(f, k):
        raise ValueError(f"unsupported shapes rows={rows}, Q={q_pad}, F={f}")
    lib = _lib()
    wide = route_name(k) == "wide"
    if merges is not None and (
            not wide or merges.shape != (q_pad,)
            or merges.dtype != torch.int32 or merges.device != device
            or not merges.is_contiguous()):
        raise ValueError(f"merges must be a contiguous int32 [{q_pad}] on "
                         f"{device}, for the wide route")
    out_s = torch.empty((q_pad, k), dtype=torch.float32, device=device)
    out_i = torch.empty((q_pad, k), dtype=torch.int32, device=device)
    stage = staging_rows(q_pad, k, device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.ivf_scan_launch(
        slabs.data_ptr(), _DTYPE_CODES[slabs.dtype], slab_lambdas.data_ptr(),
        slab_ids.data_ptr(), tiles.data_ptr(), f, cap, qn.data_ptr(),
        lamq.data_ptr(), probe.data_ptr(), n_blocks, n_probe, q_block,
        float(tau), k, out_s.data_ptr(), out_i.data_ptr(),
        stage.data_ptr() if stage is not None else None,
        merges.data_ptr() if merges is not None else None,
        device.index or 0, stream)
    _build.check(lib, "ivf_scan", err)
    LAUNCHES += 1
    WIDE_LAUNCHES += wide
    return out_s, out_i
