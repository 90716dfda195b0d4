"""K5: the gather and score of the selected subtiles (phase b of subtile
serving) — the CUDA kernel's wrapper and its plain PyTorch version.

``gather_score`` returns, for every query, its dot with each row of its S
selected 64-row subtiles: ``cos [Q, S * 64]``, the subtiles in ``sel``'s
order.  The lambda blend stays with the caller.  On CPU tensors it runs
``gather_score_plain``; on CUDA tensors it launches
``csrc/gather_score.cu`` (built at first use) or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build

SUBTILE = 64

# Kernel launches since import (or since the caller last reset it).
LAUNCHES = 0

# Plain version: queries per chunk keep the gathered [queries, S * 64, F]
# rows near this many elements.
_PLAIN_CHUNK_ELEMS = 1 << 26


def gather_score_plain(xu: torch.Tensor, qn: torch.Tensor,
                       sel: torch.Tensor) -> torch.Tensor:
    """Gather the selected rows, upcast to float32, batched matvec."""
    q, s_keep = sel.shape
    f = xu.shape[1]
    rows = (sel.to(torch.int64)[:, :, None] * SUBTILE
            + torch.arange(SUBTILE, device=xu.device)).reshape(q, -1)
    out = torch.empty((q, s_keep * SUBTILE), dtype=torch.float32,
                      device=xu.device)
    step = max(1, _PLAIN_CHUNK_ELEMS // max(s_keep * SUBTILE * f, 1))
    for s in range(0, q, step):
        x = xu[rows[s:s + step]].to(torch.float32)       # [qc, S*64, F]
        qc = qn[s:s + step].to(torch.float32)[:, :, None]
        out[s:s + step] = torch.bmm(x, qc)[:, :, 0]
    return out


def _lib():
    lib = _build.load("gather_score")
    lib.gather_score_launch.restype = ctypes.c_int
    lib.gather_score_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p]
    return lib


def gather_score(xu: torch.Tensor, qn: torch.Tensor,
                 sel: torch.Tensor) -> torch.Tensor:
    """cos [Q, S * 64] float32: xu [N_pad, F] (float32 or bfloat16, N_pad a
    multiple of 64), queries qn [Q, F] of xu's dtype, sel [Q, S] int32
    subtile numbers in [0, N_pad / 64)."""
    global LAUNCHES
    if (xu.dim() != 2 or qn.dim() != 2 or sel.dim() != 2
            or qn.shape[1] != xu.shape[1] or sel.shape[0] != qn.shape[0]):
        raise ValueError(f"shapes xu {tuple(xu.shape)} / qn "
                         f"{tuple(qn.shape)} / sel {tuple(sel.shape)} do "
                         f"not match")
    n_pad, f = xu.shape
    q, s_keep = sel.shape
    if n_pad % SUBTILE:
        raise ValueError(f"xu rows {n_pad} must be a multiple of {SUBTILE}")
    devices = {t.device for t in (xu, qn, sel)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    device = xu.device
    if device.type == "cpu":
        return gather_score_plain(xu, qn, sel)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if xu.dtype not in (torch.float32, torch.bfloat16) or qn.dtype != xu.dtype:
        raise TypeError(f"the gather-score kernel takes a float32 or bfloat16 "
                        f"corpus and queries of its type, got {xu.dtype} / "
                        f"{qn.dtype}")
    if sel.dtype != torch.int32:
        raise TypeError(f"the gather-score kernel takes int32 sel, got "
                        f"{sel.dtype}")
    for name, t in (("xu", xu), ("qn", qn), ("sel", sel)):
        if not t.is_contiguous():
            raise ValueError(f"the gather-score kernel takes a contiguous "
                             f"{name}")
    if q * s_keep * SUBTILE >= 2 ** 31 or q >= 2 ** 31 // max(f, 1):
        raise ValueError(f"unsupported shapes Q={q}, S={s_keep}, F={f}")
    out = torch.empty((q, s_keep * SUBTILE), dtype=torch.float32,
                      device=device)
    if q == 0 or s_keep == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.gather_score_launch(
        xu.data_ptr(), f, qn.data_ptr(), sel.data_ptr(), q, s_keep,
        int(xu.dtype == torch.bfloat16), out.data_ptr(), device.index or 0,
        stream)
    _build.check(lib, "gather_score", err)
    LAUNCHES += 1
    return out
