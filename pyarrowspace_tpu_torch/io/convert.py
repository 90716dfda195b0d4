"""Carry a built index's state across into this package.

``state_from_numpy`` turns the arrays of an index (for instance pulled out
of a JAX-built ArrowSpace/GraphLaplacian with ``np.asarray``) into this
package's (ArrowSpace, GraphLaplacian) on a chosen device, so both
implementations can serve from identical state, the energy-only searches
of an energy-built index included.  ``io/persist.load_index`` goes
through it too.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ..core.laplacian import GraphLaplacian
from ..core.params import GraphParams
from ..core.space import ArrowSpace
from ..graph.build import resolve_device

STATE_KEYS = ("data", "data_unit", "lambdas", "e_raw", "lap_f", "w_f",
              "tau_star", "knn_dist", "knn_idx", "nbr_idx", "nbr_w",
              "degrees", "centroids", "assignments", "e_un")
_INT_KEYS = ("knn_idx", "nbr_idx", "assignments", "node_centroid")
_OPTIONAL_KEYS = ("knn_dist", "knn_idx", "centroids", "assignments", "e_un")
# The energy-map table of an energy-built index, all arrays but the last.
ENERGY_KEYS = ("nodes", "node_lambda", "node_disp", "node_dirichlet",
               "node_centroid", "candidate_m")


def state_from_numpy(arrays: Mapping[str, Optional[np.ndarray]],
                     params: GraphParams, device=None,
                     energy_maps: Optional[Mapping] = None, *,
                     rayleigh_normalized: bool = False,
                     tau_mix: Optional[float] = None, n_dropped: int = 0
                     ) -> tuple[ArrowSpace, GraphLaplacian]:
    """(ArrowSpace, GraphLaplacian) from the arrays of STATE_KEYS on
    ``device`` (default the card; without one it raises unless the caller
    asks for the CPU).  Float arrays keep their dtype on CPU and become
    float32 on CUDA (the dtype policy of the build); index arrays become
    int32.  Optional keys (k-NN candidates, reduction artifacts, the raw
    energies e_un) may be missing or None.  ``energy_maps`` (ENERGY_KEYS)
    attaches an energy-map table, so the space routes its energy searches.
    ``rayleigh_normalized``, ``tau_mix`` (default TAU_MIX) and
    ``n_dropped`` restore an index built with another BuildConfig."""
    from ..energy.maps import EnergyMaps
    from ..spectral.taumode import TAU_MIX

    missing = [key for key in STATE_KEYS
               if key not in _OPTIONAL_KEYS and arrays.get(key) is None]
    if missing:
        raise ValueError(f"state arrays missing: {missing}")
    dev = resolve_device(None, device)
    data_dtype = (torch.float64 if dev.type == "cpu"
                  and np.asarray(arrays["data"]).dtype == np.float64
                  else torch.float32)

    def tensor(key, src=arrays):
        a = src.get(key)
        if a is None:
            return None
        dtype = torch.int32 if key in _INT_KEYS else data_dtype
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    t = {key: tensor(key) for key in STATE_KEYS}
    aspace = ArrowSpace._from_build(
        data=t["data"], data_unit=t["data_unit"], lambdas=t["lambdas"],
        e_raw=t["e_raw"], e_un=t["e_un"], lap_f=t["lap_f"], w_f=t["w_f"],
        tau_star=t["tau_star"].reshape(()), params=params,
        rayleigh_normalized=rayleigh_normalized,
        tau_mix=TAU_MIX if tau_mix is None else tau_mix,
        centroids=t["centroids"], assignments=t["assignments"],
        knn_dist=t["knn_dist"], knn_idx=t["knn_idx"])
    if energy_maps is not None:
        aspace._energy_maps = EnergyMaps(
            **{key: tensor(key, energy_maps) for key in ENERGY_KEYS[:-1]},
            candidate_m=int(energy_maps["candidate_m"]))
    gl = GraphLaplacian._from_ell(t["nbr_idx"], t["nbr_w"], t["degrees"],
                                  params, n_dropped=n_dropped)
    return aspace, gl
