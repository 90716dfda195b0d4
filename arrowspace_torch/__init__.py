"""Drop-in alias for the reference's `arrowspace` Python package, on the
PyTorch / CUDA port.

The reference is imported as `from arrowspace import ArrowSpaceBuilder`;
this alias lets that code run on the port by changing the import to
`arrowspace_torch`.  Everything re-exports from `pyarrowspace_tpu_torch`
(builds run on the card unless the caller passes ``device="cpu"``).
"""

from pyarrowspace_tpu_torch import (ArrowItem, ArrowSpace, ArrowSpaceBuilder,
                                    BuildConfig, EnergyParams,
                                    GraphLaplacian, GraphParams, TauMode,
                                    get_phase_timings, parse_energy_params,
                                    parse_graph_params, set_debug,
                                    __version__)

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
