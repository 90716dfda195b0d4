"""arrowspace-tpu on PyTorch: the spectral similarity-search engine of
``pyarrowspace_tpu`` ported to PyTorch and CUDA for NVIDIA Hopper.

Public API (the same names as the JAX package):

    ArrowSpaceBuilder.build(graph_params, items, device=None)
    ArrowSpaceBuilder.build_energy(items, energy_params=None,
                                   graph_params=None, device=None)
    ArrowSpaceBuilder.extend(aspace, gl, new_items, config=None)
    ArrowSpace.{nitems, nfeatures, get_item, lambdas, search, search_hybrid,
                search_energy, search_batch, search_hybrid_batch,
                search_energy_batch, enable_ivf, serving_stream, as_serving,
                spectral_summary, data, feature_laplacian}
    GraphLaplacian.{nnodes, shape, graph_params, matvec}
    io.save_index(path, aspace, gl), io.load_index(path, device=None)
    graph.suggest.suggest_graph_params(items, device=None)
    set_debug, get_phase_timings

Builds, loads and suggestions run on the card unless the caller passes
device="cpu" or a CPU tensor; without a card they raise.  The exact k-NN scan of the
build and the extend (K1, with its seeded, rotated and permuted walks; K1t
under ARROWSPACE_KNN_VARIANT=transposed), the blended top-k scan of exact
search (K2, float32 or bfloat16 rows), the four kernels of subtile
serving (K3 subtile max, K4b top-S select, K5 gather and score, K4a pool
cut), the probe scan of blocked-IVF and certified serving (K6) and the
int8 candidate scan of int8 serving (K7) are hand-written CUDA kernels
(``csrc/``) built with nvcc at first use; on CPU tensors each runs its
plain PyTorch version.  This package imports torch and numpy, never jax.
"""

import torch

# A float32 product in TF32 keeps ~3 decimal digits; distances and scores
# must stay in full float32 to agree with the reference.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .builder import ArrowSpaceBuilder  # noqa: E402
from .core.laplacian import GraphLaplacian  # noqa: E402
from .core.params import (EnergyParams, GraphParams, TauMode,  # noqa: E402
                          parse_energy_params, parse_graph_params)
from .core.space import ArrowItem, ArrowSpace  # noqa: E402
from .graph.build import BuildConfig  # noqa: E402
from .utils.debug import get_phase_timings, set_debug  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "ArrowSpaceBuilder",
    "ArrowSpace",
    "ArrowItem",
    "GraphLaplacian",
    "GraphParams",
    "EnergyParams",
    "TauMode",
    "BuildConfig",
    "set_debug",
    "get_phase_timings",
    "parse_graph_params",
    "parse_energy_params",
    "__version__",
]
