"""K8: the energy scan of the energy searches, routed by a per-query bitmap —
the CUDA kernel's wrapper and its plain PyTorch version.

``energy_scan`` keeps, per query, the k = min(topk, N) largest

    D     = max(e_q + e_i - 2 qL_q . x_i, 0),   D' = D / (D + max(tau*, 1e-10))
    score = w_l / (1 + |lam_i - lam_q|) + w_d / (1 + D')

over the items the query's route admits (``keys`` and ``bitmap``: item i
is admitted where bit keys[i] of the query's bitmap is set; no keys, every
item), descending, ties to the smallest id; a slot no admitted item fills
is (-1, -inf), and a NaN score is never admitted.  qL = q L_f is the
query's row of the feature Laplacian product, e the RAW energies.  On CPU
tensors it runs ``energy_plain``; on CUDA tensors it launches
``csrc/scan_energy.cu`` (built at first use) or raises: K2's SIMT scan
(``csrc/scan_narrow.cuh`` over ``csrc/ffma_tile.cuh``'s product, TMA-fed
where ``ffma_tile.loader_name`` allows) with the energy epilogue, K2's split
plan (``scan_topk.plan_splits``), lists past 128 on ``csrc/knn_wide.cuh``.
Nothing falls back to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from . import scan_topk
from .ffma_tile import loader_name

# Kernel launches since import (or since the caller last reset it), and the
# route of the last launch: "routed/" (a bitmap) or "exact/", then
# scan_topk.route_name's list width, splits and loader ("narrow/S4/tma").
LAUNCHES = 0
LAST_ROUTE = None


def bitmap_bytes(n_keys: int) -> int:
    """Bytes of a query's bitmap over keys 0 .. n_keys - 1."""
    return max(1, -(-n_keys // 8))


def admitted(keys: torch.Tensor, bitmap: torch.Tensor) -> torch.Tensor:
    """[Q, N] bool: bit keys[i] of query q's bitmap."""
    k64 = keys.to(torch.int64)
    return ((bitmap[:, k64 >> 3].to(torch.int32)
             >> (k64 & 7).to(torch.int32)[None, :]) & 1).bool()


def energy_plain(x, lam, e, ql, lam_q, e_q, tau_star, w_l, w_d, k: int,
                 keys=None, bitmap=None):
    """Matmul + the energy formula + the route mask + a stable sort, in
    the inputs' dtype, queries in chunks as scan_topk.scan_plain takes
    them.  Returns (idx [Q, k] int32, vals [Q, k])."""
    n = x.shape[0]
    ts = torch.clamp_min(tau_star, 1e-10)
    step = max(1, scan_topk._PLAIN_CHUNK_ELEMS // max(n, 1))
    out_i, out_s = [], []
    for s in range(0, ql.shape[0], step):
        cross = ql[s:s + step] @ x.T
        d = torch.clamp_min(e_q[s:s + step, None] + e[None, :]
                            - 2.0 * cross, 0.0)
        db = d / (d + ts)
        prox = 1.0 / (1.0 + torch.abs(lam[None, :]
                                      - lam_q[s:s + step, None]))
        score = w_l * prox + w_d / (1.0 + db)
        ok = ~torch.isnan(score)
        if keys is not None:
            ok &= admitted(keys, bitmap[s:s + step])
        score = torch.where(ok, score, -torch.inf)
        vals, order = torch.sort(score, dim=1, descending=True, stable=True)
        vals = vals[:, :k]
        out_i.append(torch.where(vals > -torch.inf, order[:, :k], -1)
                     .to(torch.int32))
        out_s.append(vals)
    if not out_i:
        return (torch.empty((0, k), dtype=torch.int32, device=x.device),
                torch.empty((0, k), dtype=x.dtype, device=x.device))
    return torch.cat(out_i), torch.cat(out_s)


def _lib():
    lib = _build.load("scan_energy")
    lib.scan_energy_launch.restype = ctypes.c_int
    lib.scan_energy_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


def energy_scan(x: torch.Tensor, lam: torch.Tensor, e: torch.Tensor,
                ql: torch.Tensor, lam_q: torch.Tensor, e_q: torch.Tensor,
                tau_star: torch.Tensor, w_l, w_d, topk: int, keys=None,
                bitmap=None):
    """Batched energy top-k: x [N, F], lam / e [N], ql [Q, F], lam_q / e_q
    [Q], tau_star 0-dim, w_l / w_d numbers (or 0-dim CPU tensors); keys
    [N] int32 and bitmap [Q, B] uint8 (every key below 8 B:
    ``bitmap_bytes``) route each query (None: every item).  Returns
    (idx [Q, k] int32, vals [Q, k]) with k = min(topk, N)."""
    global LAUNCHES, LAST_ROUTE
    if x.dim() != 2 or ql.dim() != 2 or ql.shape[1] != x.shape[1]:
        raise ValueError(f"shapes x {tuple(x.shape)} / ql "
                         f"{tuple(ql.shape)} do not match")
    n, f = x.shape
    q = ql.shape[0]
    if lam.shape != (n,) or e.shape != (n,) or lam_q.shape != (q,) \
            or e_q.shape != (q,):
        raise ValueError(f"item terms {tuple(lam.shape)} / "
                         f"{tuple(e.shape)} and query terms "
                         f"{tuple(lam_q.shape)} / {tuple(e_q.shape)} must be "
                         f"[{n}] and [{q}]")
    if (keys is None) != (bitmap is None):
        raise ValueError("keys and bitmap come together")
    if keys is not None and (keys.shape != (n,) or bitmap.dim() != 2
                             or bitmap.shape[0] != q):
        raise ValueError(f"keys {tuple(keys.shape)} / bitmap "
                         f"{tuple(bitmap.shape)} must be [{n}] / [{q}, B]")
    k = min(int(topk), n)
    routed = [] if keys is None else [keys, bitmap]
    devices = {t.device for t in (x, lam, e, ql, lam_q, e_q, tau_star,
                                  *routed)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    device = x.device
    if device.type == "cpu":
        return energy_plain(x, lam, e, ql, lam_q, e_q, tau_star, w_l, w_d, k,
                            keys, bitmap)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    for name, t in (("x", x), ("lam", lam), ("e", e), ("ql", ql),
                    ("lam_q", lam_q), ("e_q", e_q), ("tau_star", tau_star)):
        if t.dtype != torch.float32:
            raise TypeError(f"the energy scan kernel takes float32 {name}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the energy scan kernel takes a contiguous "
                             f"{name}")
    if keys is not None and (keys.dtype != torch.int32
                             or bitmap.dtype != torch.uint8
                             or not keys.is_contiguous()
                             or not bitmap.is_contiguous()):
        raise TypeError("the energy scan kernel takes contiguous int32 keys "
                        "and a contiguous uint8 bitmap")
    if n >= 2 ** 31 // f or q >= 2 ** 31 // f:
        raise ValueError(f"unsupported shapes N={n}, Q={q}, F={f}")
    out_i = torch.empty((q, k), dtype=torch.int32, device=device)
    out_s = torch.empty((q, k), dtype=torch.float32, device=device)
    if q == 0 or k == 0:
        return out_i, out_s
    lib = _lib()
    wide = k > scan_topk.WIDE_K
    staged = scan_topk._STAGE if wide else 0
    loader = loader_name(f, 4, x.data_ptr(), ql.data_ptr())
    route = (f"{'routed' if keys is not None else 'exact'}/"
             f"{scan_topk.route_name(n, q, k, device, loader)}")
    splits, q_chunk = scan_topk.plan_splits(n, q, k, device, staged)
    part = torch.empty((scan_topk.scratch_words(splits, min(q, q_chunk), k,
                                                staged), 2),
                       dtype=torch.int32, device=device)
    bm_bytes = 0 if bitmap is None else bitmap.shape[1]
    stream = torch.cuda.current_stream(device).cuda_stream
    for s in range(0, q, q_chunk):
        qc = min(q_chunk, q - s)
        err = lib.scan_energy_launch(
            x.data_ptr(), lam.data_ptr(), e.data_ptr(),
            None if keys is None else keys.data_ptr(), n, f,
            ql[s:].data_ptr(), lam_q[s:].data_ptr(), e_q[s:].data_ptr(),
            None if bitmap is None else bitmap[s:].data_ptr(), bm_bytes, qc,
            tau_star.data_ptr(), float(w_l), float(w_d), k, splits,
            part.data_ptr(), out_s[s:].data_ptr(), out_i[s:].data_ptr(),
            int(loader == "tma"), device.index or 0, stream)
        _build.check(lib, "scan_energy", err)
        LAUNCHES += 1
        LAST_ROUTE = route
    return out_i, torch.where(out_i >= 0, out_s, -torch.inf)
