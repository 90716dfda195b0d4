"""K3: the subtile-max scan of subtile serving — the CUDA kernel's wrapper
and its plain PyTorch version.

``subtile_max`` returns, for every query and every 64-row subtile of the
padded corpus, the largest blended score
``tau * (qn . xu_i) + (1 - tau) / (1 + |lam_i - lam_q|)`` over the
subtile's real rows (rows < n_real), and the sentinel ``-1e6 - s`` for a
subtile s with none: the routing maxima of ``subtile_search``, already
repaired for the partial last subtile.  The layout is query-major
[Q, n_sub].  On CPU tensors it runs ``subtile_max_plain``; on CUDA tensors
it launches ``csrc/subtile_max.cu`` (built at first use) or raises.

Two routes on the card, chosen by ``tensor_core_route``, the one predicate
that K5's wrapper (``gather_score.py``) calls too, so that K3 and K5 always
compute a state's products the same way and the block-max guarantee holds
bit for bit: the bf16 tensor-core kernel (``csrc/wgmma_tile.cuh``) for a
bf16 state with F % 8 == 0 and 16-byte-aligned bases, else the SIMT kernel
(the fmaf chain of ``csrc/tile_common.cuh``).  A failed build or launch
raises; nothing falls back to the other route or to the plain version.

The tensor-core kernel runs at every shape in thread-block clusters whose
blocks scan neighbouring pairs of subtiles against one query block and
share its loads; ``plan_tensor_core`` sizes the persistent grid from what
the launch can observe (the real subtiles, the query blocks) and from the
kernel's shape and the clusters the device holds at once, which the
library reports (``tc_shape``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ... import _build

SUBTILE = 64

# Kernel launches since import (or since the caller last reset it): all
# of them, those of the tensor-core route, and those that ran in clusters
# of more than one block (every tensor-core launch: see tc_shape).
LAUNCHES = 0
TC_LAUNCHES = 0
CLUSTER_LAUNCHES = 0
# The route of the last launch: "simt", or "tensor-core/cluster<n>".
LAST_ROUTE = None

# The launcher's route codes.
_SIMT_F32, _SIMT_BF16, _TENSOR_CORE = 0, 1, 2

# Plain version: queries per chunk keep the [queries, N_pad] score block
# near this many elements.
_PLAIN_CHUNK_ELEMS = 1 << 26


def sentinel(ids: torch.Tensor) -> torch.Tensor:
    """The routing value of masked candidates: -1e6 - id in float32.  It
    stays strictly above the extraction's elimination value -3e38, so a
    masked entry is never taken twice, and far below any real score."""
    return -1.0e6 - ids.to(torch.float32)


def subtile_max_plain(xu: torch.Tensor, lam: torch.Tensor, qn: torch.Tensor,
                      lam_q: torch.Tensor, tau: float, n_real: int):
    """Chunked float32 matmul + blend + masked max over each 64 rows."""
    n_pad = xu.shape[0]
    n_sub = n_pad // SUBTILE
    q = qn.shape[0]
    x32 = xu.to(torch.float32)
    tau_t = torch.tensor(tau, dtype=torch.float32, device=xu.device)
    pad_rows = torch.arange(n_pad, device=xu.device) >= n_real
    out = torch.empty((q, n_sub), dtype=torch.float32, device=xu.device)
    step = max(1, _PLAIN_CHUNK_ELEMS // max(n_pad, 1))
    for s in range(0, q, step):
        cos = qn[s:s + step].to(torch.float32) @ x32.T
        prox = 1.0 / (1.0 + torch.abs(lam[None, :] - lam_q[s:s + step, None]))
        score = tau_t * cos + (1.0 - tau_t) * prox
        score = score.masked_fill(pad_rows[None, :], float("-inf"))
        out[s:s + step] = score.view(-1, n_sub, SUBTILE).amax(dim=2)
    sub_ids = torch.arange(n_sub, device=xu.device)
    return torch.where(sub_ids[None, :] * SUBTILE < n_real, out,
                       sentinel(sub_ids)[None, :])


def tensor_core_route(xu: torch.Tensor, qn: torch.Tensor) -> bool:
    """Whether K3 and K5 run the bf16 tensor-core kernels on the corpus xu
    [N_pad, F] and queries qn [Q, F] (on the card): both bfloat16, F a
    positive multiple of 8 (16-byte rows, TMA's stride rule) and both base
    addresses 16-byte aligned.  Otherwise both run their SIMT kernels."""
    f = xu.shape[-1]
    return (xu.dtype == torch.bfloat16 and qn.dtype == torch.bfloat16
            and f > 0 and f % 8 == 0 and xu.data_ptr() % 16 == 0
            and qn.data_ptr() % 16 == 0)


def route_name(xu: torch.Tensor, qn: torch.Tensor) -> str:
    """"tensor-core" or "simt": the route tensor_core_route picks."""
    return "tensor-core" if tensor_core_route(xu, qn) else "simt"


class TensorCoreShape(NamedTuple):
    """The tensor-core kernel's shape as ``csrc/subtile_max.cu`` reports
    it, and the clusters of it that the device holds at once."""
    pair: int          # subtiles a tile, one a consumer warpgroup
    cluster: int       # blocks a cluster
    threads: int       # threads a block
    query_block: int   # queries a tile
    active: int        # clusters the device holds at once


@functools.lru_cache(maxsize=None)
def tc_shape(device_index: int) -> TensorCoreShape:
    """The tensor-core kernel's shape on a device (a property of the device
    and the kernel)."""
    lib = _lib()
    shape = (ctypes.c_int * 5)()
    _build.check(lib, "subtile_max", lib.subtile_max_tc_shape(device_index,
                                                               shape))
    return TensorCoreShape(*shape)


def plan_tensor_core(n_real: int, n_sub: int, q: int,
                     shape: TensorCoreShape) -> int:
    """Blocks of a tensor-core launch, a whole number of clusters: as many
    clusters as the device holds, or as there are cluster tiles (a column
    of ``cluster`` pairs of subtiles against a block of queries) if fewer.
    With no real subtile the blocks only write the sentinels, as many as
    that fill wants.  A device that holds no cluster gets one, and the
    launch fails."""
    real = -(-n_real // SUBTILE)
    tiles = (-(-real // (shape.pair * shape.cluster))
             * -(-q // shape.query_block))
    if tiles == 0:
        tiles = -(-q * (n_sub - real) // (shape.threads * shape.cluster))
    return shape.cluster * max(1, min(shape.active, tiles))


def walk_tensor_core(n_real: int, q: int, blocks: int,
                     shape: TensorCoreShape) -> list:
    """``csrc/subtile_max.cu``'s ``Walk`` written out, for the tests of the
    plan (edit the two together): (block, warpgroup, subtile, query block)
    for each tile a block takes, the subtiles past the real ones of a
    partial last pair or column too.  Cluster tile t is column t / n_qt
    and query block t % n_qt; cluster c takes t = c, c + n_clusters, ...;
    rank r of the cluster takes pair column * cluster + r of each."""
    real = -(-n_real // SUBTILE)
    pairs = -(-real // shape.pair)
    n_qt = -(-q // shape.query_block)
    n_clusters = blocks // shape.cluster
    n_ct = -(-pairs // shape.cluster) * n_qt
    visits = []
    for b in range(blocks):
        c, rank = divmod(b, shape.cluster)
        tiles = (n_ct - 1 - c) // n_clusters + 1 if c < n_ct else 0
        for i in range(tiles):
            column, j = divmod(c + i * n_clusters, n_qt)
            for g in range(shape.pair):
                s = shape.pair * (column * shape.cluster + rank) + g
                visits.append((b, g, s, j))
    return visits


def _lib():
    lib = _build.load("subtile_max")
    lib.subtile_max_launch.restype = ctypes.c_int
    lib.subtile_max_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p]
    lib.subtile_max_tc_shape.restype = ctypes.c_int
    lib.subtile_max_tc_shape.argtypes = [ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_int)]
    return lib


def subtile_max(xu: torch.Tensor, lam: torch.Tensor, qn: torch.Tensor,
                lam_q: torch.Tensor, tau: float, n_real: int):
    """[Q, N_pad / 64] float32 routing maxima: xu [N_pad, F] (float32 or
    bfloat16, N_pad a multiple of 64) with lambdas lam [N_pad] float32,
    queries qn [Q, F] of xu's dtype with lambdas lam_q [Q] float32."""
    global LAUNCHES, TC_LAUNCHES, CLUSTER_LAUNCHES, LAST_ROUTE
    if xu.dim() != 2 or qn.dim() != 2 or qn.shape[1] != xu.shape[1]:
        raise ValueError(f"shapes xu {tuple(xu.shape)} / qn "
                         f"{tuple(qn.shape)} do not match")
    n_pad, f = xu.shape
    q = qn.shape[0]
    if n_pad % SUBTILE or lam.shape != (n_pad,) or lam_q.shape != (q,):
        raise ValueError(f"xu rows {n_pad} must be a multiple of {SUBTILE} "
                         f"and lambdas {tuple(lam.shape)} / "
                         f"{tuple(lam_q.shape)} must be [{n_pad}] / [{q}]")
    if not 0 <= n_real <= n_pad:
        raise ValueError(f"n_real={n_real} outside [0, {n_pad}]")
    devices = {t.device for t in (xu, lam, qn, lam_q)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    device = xu.device
    if device.type == "cpu":
        return subtile_max_plain(xu, lam, qn, lam_q, tau, n_real)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if xu.dtype not in (torch.float32, torch.bfloat16) or qn.dtype != xu.dtype:
        raise TypeError(f"the subtile-max kernel takes a float32 or bfloat16 "
                        f"corpus and queries of its type, got {xu.dtype} / "
                        f"{qn.dtype}")
    for name, t in (("xu", xu), ("lam", lam), ("qn", qn), ("lam_q", lam_q)):
        if name.startswith("lam") and t.dtype != torch.float32:
            raise TypeError(f"the subtile-max kernel takes float32 {name}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the subtile-max kernel takes a contiguous "
                             f"{name}")
    n_sub = n_pad // SUBTILE
    if n_pad * f >= 2 ** 31 or q * max(f, n_sub) >= 2 ** 31:
        raise ValueError(f"unsupported shapes N_pad={n_pad}, Q={q}, F={f}")
    out = torch.empty((q, n_sub), dtype=torch.float32, device=device)
    if q == 0:
        return out
    tc = tensor_core_route(xu, qn)
    route = (_TENSOR_CORE if tc else
             _SIMT_BF16 if xu.dtype == torch.bfloat16 else _SIMT_F32)
    lib = _lib()
    index = device.index or 0
    cluster = blocks = 1            # the SIMT routes ignore blocks
    if tc:
        shape = tc_shape(index)
        cluster = shape.cluster
        blocks = plan_tensor_core(int(n_real), n_sub, q, shape)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.subtile_max_launch(
        xu.data_ptr(), lam.data_ptr(), n_sub, f, int(n_real), qn.data_ptr(),
        lam_q.data_ptr(), q, float(tau), route, blocks, out.data_ptr(),
        index, stream)
    _build.check(lib, "subtile_max", err)
    LAUNCHES += 1
    TC_LAUNCHES += tc
    CLUSTER_LAUNCHES += tc and cluster > 1
    LAST_ROUTE = f"tensor-core/cluster{cluster}" if tc else "simt"
    return out
