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
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build

SUBTILE = 64

# Kernel launches since import (or since the caller last reset it).
LAUNCHES = 0

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


def _lib():
    lib = _build.load("subtile_max")
    lib.subtile_max_launch.restype = ctypes.c_int
    lib.subtile_max_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p]
    return lib


def subtile_max(xu: torch.Tensor, lam: torch.Tensor, qn: torch.Tensor,
                lam_q: torch.Tensor, tau: float, n_real: int):
    """[Q, N_pad / 64] float32 routing maxima: xu [N_pad, F] (float32 or
    bfloat16, N_pad a multiple of 64) with lambdas lam [N_pad] float32,
    queries qn [Q, F] of xu's dtype with lambdas lam_q [Q] float32."""
    global LAUNCHES
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
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.subtile_max_launch(
        xu.data_ptr(), lam.data_ptr(), n_sub, f, int(n_real), qn.data_ptr(),
        lam_q.data_ptr(), q, float(tau), int(xu.dtype == torch.bfloat16),
        out.data_ptr(), device.index or 0, stream)
    _build.check(lib, "subtile_max", err)
    LAUNCHES += 1
    return out
