from .params import (DEFAULT_GRAPH_PARAMS, EnergyParams, GraphParams, TauMode,
                     parse_energy_params, parse_graph_params)
from .laplacian import GraphLaplacian
from .space import ArrowItem, ArrowSpace
