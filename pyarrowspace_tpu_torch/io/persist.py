"""Index persistence — build once, serve from a separate job (port of
pyarrowspace_tpu/io/persist.py).

The format is the JAX package's, so an index saved by either package loads
into the other: one .npz with the arrays {data, data_unit, lambdas, e_raw,
lap_f, w_f, tau_star, ELL graph} (plus e_un, the reduction clustering, the
directed k-NN state and the energy-node table where the index has them)
and a JSON manifest of params, written to ``path + ".tmp"`` and renamed
into place.  Self-contained, no pickle.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..core.laplacian import GraphLaplacian
from ..core.params import GraphParams, TauMode
from ..core.space import ArrowSpace
from ..utils.debug import dbg_println
from .convert import state_from_numpy

FORMAT_VERSION = 1

# npz name -> EnergyMaps field of an energy-built index.
_ENERGY_ARRAYS = {"em_nodes": "nodes", "em_lambda": "node_lambda",
                  "em_disp": "node_disp", "em_dirichlet": "node_dirichlet",
                  "em_centroid": "node_centroid"}


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_index(path: str, aspace: ArrowSpace, gl: GraphLaplacian) -> None:
    """Serialize a built (ArrowSpace, GraphLaplacian) pair to one .npz."""
    gp = aspace._params
    manifest = {
        "format_version": FORMAT_VERSION,
        "graph_params": {
            "eps": gp.eps, "k": gp.k, "topk": gp.topk, "p": gp.p,
            "sigma": gp.sigma, "normalise": gp.normalise, "seed": gp.seed,
            "synthesis": gp.synthesis.value, "tau_fixed": gp.tau_fixed,
            "dims_reduction": gp.dims_reduction,
            "reduction_eps": gp.reduction_eps,
            "sparsity_check": gp.sparsity_check,
        },
        "rayleigh_normalized": aspace._rayleigh_normalized,
        "tau_mix": aspace._tau_mix,
        "n_dropped": gl.n_dropped_edges,
        # Blocked-slab layout plan (enable_ivf): a loaded index rebuilds
        # the same slab layout.
        "ivf_cap_plan": aspace._ivf_cap_plan,
        "ivf_cap_factor": aspace._ivf_cap_factor,
    }
    arrays = {
        "data": _np(aspace._data),
        "data_unit": _np(aspace._data_unit),
        "lambdas": _np(aspace._lambdas),
        "e_raw": _np(aspace._e_raw),
        "lap_f": _np(aspace._lap_f),
        "w_f": _np(aspace._w_f),
        "tau_star": _np(aspace._tau_star),
        "nbr_idx": _np(gl.neighbor_indices),
        "nbr_w": _np(gl.neighbor_weights),
        "degrees": _np(gl.degrees),
        "manifest": np.frombuffer(
            json.dumps(manifest).encode("utf-8"), dtype=np.uint8),
    }
    if aspace._rayleigh_normalized:
        # e_raw holds normalized Rayleigh quotients; the energy searches
        # also need the raw x^T L x energies.
        arrays["e_un"] = _np(aspace._energies_raw())
    if aspace._centroids is not None:
        arrays["centroids"] = _np(aspace._centroids)
        arrays["assignments"] = _np(aspace._assignments)
    if aspace._knn_dist is not None:
        # Directed k-NN build state: a loaded index keeps accepting
        # ArrowSpaceBuilder.extend appends.
        arrays["knn_dist"] = _np(aspace._knn_dist)
        arrays["knn_idx"] = _np(aspace._knn_idx)
    emaps = aspace._energy_maps
    if emaps is not None:
        for key, field in _ENERGY_ARRAYS.items():
            arrays[key] = _np(getattr(emaps, field))
        arrays["em_candidate_m"] = np.asarray([emaps.candidate_m])
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:  # a file handle: savez won't append ".npz"
        np.savez(fh, **arrays)
    os.replace(tmp, path)
    dbg_println(f"saved index to {path} "
                f"({os.path.getsize(path) / 1e6:.1f} MB)")


def load_index(path: str, device=None) -> tuple[ArrowSpace, GraphLaplacian]:
    """Load an index saved by save_index (of either package) onto
    ``device``: by default the card, and without one it raises unless the
    caller asks for the CPU.  Float arrays keep float64 on the CPU and
    become float32 on CUDA.  ArrowSpaceBuilder.extend of the loaded index
    equals a rebuild bit for bit only on the device and dtype the index
    was built with: a float64 CPU index loaded onto the card extends as a
    float32 index, which no longer matches the float64 build."""
    z = np.load(path)
    manifest = json.loads(bytes(z["manifest"]).decode("utf-8"))
    if manifest["format_version"] != FORMAT_VERSION:
        raise ValueError(
            f"unsupported index format {manifest['format_version']}")
    gpd = manifest["graph_params"]
    gp = GraphParams(
        eps=gpd["eps"], k=gpd["k"], topk=gpd["topk"], p=gpd["p"],
        sigma=gpd["sigma"], normalise=gpd["normalise"], seed=gpd["seed"],
        synthesis=TauMode(gpd["synthesis"]), tau_fixed=gpd["tau_fixed"],
        dims_reduction=gpd["dims_reduction"],
        reduction_eps=gpd["reduction_eps"],
        sparsity_check=gpd["sparsity_check"])
    energy = None
    if "em_nodes" in z:
        energy = {field: z[key] for key, field in _ENERGY_ARRAYS.items()}
        energy["candidate_m"] = int(z["em_candidate_m"][0])
    aspace, gl = state_from_numpy(
        {key: z[key] for key in z.files}, gp, device, energy,
        rayleigh_normalized=manifest["rayleigh_normalized"],
        tau_mix=manifest["tau_mix"], n_dropped=manifest["n_dropped"])
    if manifest.get("ivf_cap_plan") is not None:
        aspace._ivf_cap_plan = int(manifest["ivf_cap_plan"])
    if manifest.get("ivf_cap_factor") is not None:
        aspace._ivf_cap_factor = float(manifest["ivf_cap_factor"])
    dbg_println(f"loaded index from {path}: nitems={aspace.nitems}")
    return aspace, gl
