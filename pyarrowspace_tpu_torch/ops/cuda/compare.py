"""Agreement of a kernel's top-k lists with its plain version's.

A kernel and its plain version sum the same products in different orders,
so values differ in the last bits and two candidates whose values differ
by less than that may trade places.  Two lists agree when every position's
values are within ``tol``, every id both hold has values within ``tol``,
and an id only one holds sits within ``tol`` of the other's last value.

``k5_blend`` and ``k5_distance`` are the bit-for-bit witnesses of K2's
scores and K1's distances on the card: K5 on the route K2 takes for the
same operands (its tensor-core route over bf16 rows, else its SIMT route,
which keeps the fmaf chain of K2's and K1's SIMT product).
"""

from __future__ import annotations

import numpy as np


def topk_disagreements(vals_a, ids_a, vals_b, ids_b, tol: float) -> list[int]:
    """Row numbers whose lists disagree beyond near-ties (empty = agree)."""
    va, ia = np.asarray(vals_a, np.float64), np.asarray(ids_a)
    vb, ib = np.asarray(vals_b, np.float64), np.asarray(ids_b)
    if va.shape != vb.shape or ia.shape != ib.shape or va.shape != ia.shape:
        raise ValueError(f"shapes differ: {va.shape} {ia.shape} "
                         f"{vb.shape} {ib.shape}")
    close = np.abs(va - vb) <= tol
    suspect = ~(close.all(axis=1) & (ia == ib).all(axis=1))
    bad = []
    for r in np.nonzero(suspect)[0]:
        if not close[r].all():
            bad.append(int(r))
            continue
        in_a = dict(zip(ia[r].tolist(), va[r].tolist()))
        in_b = dict(zip(ib[r].tolist(), vb[r].tolist()))
        ok = all(abs(in_b[i] - v) <= tol if i in in_b
                 else abs(v - vb[r, -1]) <= tol for i, v in in_a.items())
        ok = ok and all(abs(v - va[r, -1]) <= tol
                        for i, v in in_b.items() if i not in in_a)
        if not ok:
            bad.append(int(r))
    return bad


def max_abs_err(vals_a, vals_b) -> float:
    """Largest absolute difference between two value arrays."""
    diff = np.abs(np.asarray(vals_a, np.float64)
                  - np.asarray(vals_b, np.float64))
    return float(diff.max()) if diff.size else 0.0


def k5_blend(xu, lam, qn, lam_q, tau, ids, tensor_core=None):
    """K2's scores as another kernel computes them: K5's cosine of each
    query of qn [Q, F] with each id of its list ids [Q, k], xu padded to
    K5's 64-row subtiles, blended as tile::blend does:
    ``tau * cos + (1 - tau) * (1 / (1 + |lam_i - lam_q|))``, op by op in
    float32.  Every score K2 returns must equal it bit for bit.

    K5 takes the route the shared predicate (subtile_max.tensor_core_route)
    gives K2 on the same operands, the queries rounded to xu's type as K2
    rounds them: on bf16 rows with F % 8 == 0 and aligned bases, the bf16
    tensor-core route (wgmma_tile.cuh's k steps, whose sums K2's
    tensor-core route must equal); otherwise (float32 rows, ragged or
    unaligned bf16 rows) the SIMT route, tile_common.cuh's one fmaf chain
    over ascending features, on the rows and queries upcast to float32
    (exactly), the chain K2's SIMT route keeps.  ``tensor_core`` names the
    route K2 took where the caller knows it (another checkout's K2 may
    have only the SIMT route).  CUDA tensors; the package
    is imported by name, so a checkout's own copy of this file also checks
    another checkout's kernels."""
    import torch

    from pyarrowspace_tpu_torch.ops.cuda import gather_score, subtile_max
    sub = gather_score.SUBTILE
    f32 = torch.float32
    qs = qn.to(xu.dtype).contiguous()
    if tensor_core is None:
        tensor_core = subtile_max.tensor_core_route(xu, qs)
    if not tensor_core:
        xu, qs = xu.to(f32), qs.to(f32)
    xp = torch.nn.functional.pad(xu, (0, 0, 0, (-xu.shape[0]) % sub))
    ids64 = ids.to(torch.int64)
    cos = gather_score.gather_score(
        xp.contiguous(), qs.contiguous(),
        (ids64 // sub).to(torch.int32).contiguous())
    del xp
    cols = torch.arange(ids.shape[1], device=ids.device) * sub + ids64 % sub
    cos = torch.gather(cos, 1, cols)
    tau32 = torch.tensor(tau, dtype=torch.float32)
    prox = 1.0 / (1.0 + torch.abs(lam[ids64] - lam_q[:, None]))
    return tau32 * cos + (1.0 - tau32) * prox


def k5_distance(xu, rows, ids):
    """K1's distances as another kernel computes them: 1 - max(0, cos) with
    K5's cosine of each row xu[rows] (a slice or an index tensor) with each
    id of its list ids [R, k], xu float32 padded to K5's 64-row subtiles.
    Every distance K1 returns for an id >= 0 must equal it bit for bit; a
    missing id (-1) gets column 0's distance, to be ignored.

    K5 runs on float32 operands, so it takes its SIMT route
    (csrc/gather_score.cu), tile_common.cuh's one fmaf chain over ascending
    features, the chain K1's product keeps on its own tiles; fmaf(a, b, c)
    == fmaf(b, a, c), so which of the two rows is the query does not
    matter.  CUDA tensors; the package is imported by name, as for
    k5_blend."""
    import torch

    from pyarrowspace_tpu_torch.ops.cuda import gather_score
    sub = gather_score.SUBTILE
    xp = torch.nn.functional.pad(xu, (0, 0, 0, (-xu.shape[0]) % sub))
    ids64 = ids.to(torch.int64).clamp_min(0)
    cos = gather_score.gather_score(
        xp.contiguous(), xu[rows].contiguous(),
        (ids64 // sub).to(torch.int32).contiguous())
    del xp
    cols = torch.arange(ids.shape[1], device=ids.device) * sub + ids64 % sub
    return 1.0 - torch.clamp_min(torch.gather(cos, 1, cols), 0.0)
