"""Tensor-parallel taumode lambdas over a 2-D ("data", "model") mesh (port
of pyarrowspace_tpu/parallel/tp.py on ``torch.distributed``).

  * corpus rows shard over "data" (as in sharded.py);
  * the feature Laplacian / adjacency shard column-wise over "model": each
    rank uses the F / m columns of its model coordinate;
  * each rank computes its partial Rayleigh / dispersion contractions
    (a column-parallel matmul), and the partials are gathered over
    "model" and added in rank order (the column-parallel-linear reduction,
    here for x^T L x);
  * tau* (the median energy) comes from the energies gathered over "data".

SPMD like sharded.py: call it on every rank; the lambdas of a data shard
are the same on each of its model ranks, tau* on every rank.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..spectral.taumode import TAU_MIX, synthesize
from ..utils.stats import median
from .mesh import DATA_AXIS, MODEL_AXIS, Comm


def lambdas_dp_tp(x_loc: torch.Tensor, lap_f: torch.Tensor,
                  w_f: torch.Tensor, *, mesh: DeviceMesh, n_real: int,
                  tau_mix: float = TAU_MIX):
    """Per-item lambdas of this data shard's rows x_loc [N_loc, F] (rows
    past n_real are padding), with the F x F state lap_f / w_f split by
    columns over "model".  Returns (lambdas [N_loc], e_raw [N_loc],
    tau_star)."""
    data, model = Comm(mesh, DATA_AXIS), Comm(mesh, MODEL_AXIS)
    f = x_loc.shape[1]
    if f % model.size:
        raise ValueError(f"F={f} must divide over {model.size} model ranks")
    f_loc = f // model.size
    cols = slice(model.rank * f_loc, (model.rank + 1) * f_loc)
    lap_l, w_l = lap_f[:, cols], w_f[:, cols]

    # Rayleigh: e = sum_j (X @ L)_ij * X_ij, column-parallel.
    e = model.sum_ordered(torch.sum((x_loc @ lap_l) * x_loc[:, cols], dim=1))
    e = torch.clamp_min(e, 0.0)

    # Dispersion (ops/rayleigh.py's derivation), column-parallel.
    w2_l = w_l * w_l
    r = model.sum_ordered(torch.sum(w2_l, dim=1))             # [F]
    x2 = x_loc * x_loc
    x3 = x2 * x_loc
    x4 = x2 * x2
    t1 = (x4 @ r[:, None])[..., 0]
    t2 = model.sum_ordered(torch.sum((x2 @ w2_l) * x2[:, cols], dim=1))
    t3 = model.sum_ordered(torch.sum((x_loc @ w2_l) * x3[:, cols], dim=1))
    sum_ord_m2 = 2.0 * t1 + 6.0 * t2 - 8.0 * t3
    denom = (2.0 * e) ** 2
    g = torch.where(denom > 0,
                    2.0 * sum_ord_m2 / torch.clamp_min(denom, 1e-30), 0.0)
    g = torch.clamp(g, 0.0, 1.0)

    # Exact median energy over the real rows.
    tau_star = torch.clamp_min(median(data.all_gather_cat(e)[:n_real]),
                               1e-10)
    return synthesize(e, g, tau_star, tau_mix), e, tau_star
