"""ArrowSpaceBuilder — the only way to construct ArrowSpace/GraphLaplacian.

Static-method API parity with the reference binding
(reference src/lib.rs:265-377):

  ArrowSpaceBuilder.build(graph_params, items) -> (ArrowSpace, GraphLaplacian)

  ArrowSpaceBuilder.build_energy(items, energy_params=None,
                                 graph_params=None)

  ArrowSpaceBuilder.extend(aspace, gl, new_items, config=None)

plus the engine's fluent configuration API.  ``build`` and
``build_energy`` take an optional ``device``: by default the device of a
tensor input, else CUDA; without a card they raise unless the caller asks
for the CPU.  ``extend`` runs on the index's own device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

from .core.laplacian import GraphLaplacian
from .core.params import DEFAULT_GRAPH_PARAMS, GraphParams, TauMode, \
    parse_energy_params, parse_graph_params
from .core.space import ArrowSpace
from .graph.build import BuildConfig, DEFAULT_BUILD_CONFIG, build_standard
from .utils.debug import dbg_println


class ArrowSpaceBuilder:
    """Fluent builder + the reference static entry point."""

    def __init__(self):
        self._params: GraphParams = DEFAULT_GRAPH_PARAMS
        self._config: BuildConfig = DEFAULT_BUILD_CONFIG
        self._sampling_rate: Optional[float] = None
        self._spectral: bool = False

    # -- fluent engine API (reference builder::ArrowSpaceBuilder) -------------
    @staticmethod
    def new() -> "ArrowSpaceBuilder":
        return ArrowSpaceBuilder()

    def with_lambda_graph(self, eps: float, k: int, topk: int, p: float,
                          sigma: Optional[float]) -> "ArrowSpaceBuilder":
        self._params = dataclasses.replace(
            self._params, eps=float(eps), k=int(k), topk=int(topk),
            p=float(p), sigma=None if sigma is None else float(sigma))
        return self

    def with_dims_reduction(self, enabled: bool,
                            eps: Optional[float] = None
                            ) -> "ArrowSpaceBuilder":
        self._params = dataclasses.replace(
            self._params, dims_reduction=bool(enabled),
            reduction_eps=None if eps is None else float(eps))
        return self

    def with_seed(self, seed: int) -> "ArrowSpaceBuilder":
        self._params = dataclasses.replace(self._params, seed=int(seed))
        return self

    def with_sparsity_check(self, enabled: bool) -> "ArrowSpaceBuilder":
        self._params = dataclasses.replace(self._params,
                                           sparsity_check=bool(enabled))
        return self

    def with_normalisation(self, enabled: bool) -> "ArrowSpaceBuilder":
        self._params = dataclasses.replace(self._params,
                                           normalise=bool(enabled))
        return self

    def with_synthesis(self, mode: TauMode,
                       tau_fixed: Optional[float] = None
                       ) -> "ArrowSpaceBuilder":
        self._params = dataclasses.replace(
            self._params, synthesis=mode,
            tau_fixed=None if tau_fixed is None else float(tau_fixed))
        return self

    def with_inline_sampling(self, rate: Optional[float]
                             ) -> "ArrowSpaceBuilder":
        """Sampling keep-rate for the reduction stage (None keeps the
        engine default of 0.6)."""
        self._sampling_rate = None if rate is None else float(rate)
        return self

    def with_spectral(self, enabled: bool) -> "ArrowSpaceBuilder":
        """Compute the spectral summary (feature-Laplacian eigenvalues)
        eagerly at build time and attach it to the ArrowSpace."""
        self._spectral = bool(enabled)
        return self

    def with_build_config(self, config: BuildConfig) -> "ArrowSpaceBuilder":
        self._config = config
        return self

    def build_rows(self, rows, device=None
                   ) -> tuple[ArrowSpace, GraphLaplacian]:
        """Fluent terminal: build from configured params."""
        config = self._config
        if self._sampling_rate is not None:
            config = dataclasses.replace(config,
                                         sampling_rate=self._sampling_rate)
        aspace, gl = build_standard(rows, self._params, config,
                                    device=device)
        if self._spectral:
            aspace.spectral_summary()  # compute and cache eagerly
        return aspace, gl

    # -- reference static API --------------------------------------------------
    @staticmethod
    def build(graph_params: Optional[Mapping[str, Any]], items, device=None
              ) -> tuple[ArrowSpace, GraphLaplacian]:
        """Standard build (parity: reference src/lib.rs:270-300).

        The binding always sets: lambda graph from the dict, dims-reduction
        on with the graph eps, seed 42, sparsity check off
        (reference src/lib.rs:278-286).
        """
        dbg_println("Convert pyarray2 and Vec<Vec>")
        gp = parse_graph_params(graph_params)
        if gp is None:
            gp = DEFAULT_GRAPH_PARAMS
        gp = dataclasses.replace(
            gp, dims_reduction=True,
            reduction_eps=gp.eps, seed=42, sparsity_check=False)
        dbg_println("Building from rows")
        return build_standard(items, gp, device=device)

    @staticmethod
    def extend(aspace: ArrowSpace, gl: GraphLaplacian, new_items,
               config: Optional[BuildConfig] = None
               ) -> tuple[ArrowSpace, GraphLaplacian]:
        """Append items to a built index without redoing the old-corpus
        k-NN scan.  Returns a NEW (ArrowSpace, GraphLaplacian) pair equal
        bit for bit to ``build(graph_params, concat(old, new))`` on the
        device and dtype the index was built with (graph/extend.py).  Pass
        the BuildConfig the index was built with when it wasn't the
        default."""
        from .graph.extend import extend_build
        return extend_build(aspace, gl, new_items,
                            config if config is not None
                            else DEFAULT_BUILD_CONFIG)

    @staticmethod
    def build_energy(items,
                     energy_params: Optional[Mapping[str, Any]] = None,
                     graph_params: Optional[Mapping[str, Any]] = None,
                     device=None) -> tuple[ArrowSpace, GraphLaplacian]:
        """Energy-only (cosine-free) build (parity: reference
        src/lib.rs:303-376).  Dims-reduction is mandatory for this pipeline
        (reference lib.rs:358-359 passes (true, Some(0.35)))."""
        from .energy.maps import build_energy_maps

        dbg_println("build_energy: Converting pyarray2 to Vec<Vec>")
        ep = parse_energy_params(energy_params)
        dbg_println(
            f"build_energy: optical_tokens={ep.optical_tokens}, "
            f"w_λ={ep.w_lambda:.2f}, w_G={ep.w_disp:.2f}, "
            f"w_D={ep.w_dirichlet:.2f}")
        gp = parse_graph_params(graph_params)
        if gp is None:
            gp = DEFAULT_GRAPH_PARAMS
        gp = dataclasses.replace(
            gp, dims_reduction=True, reduction_eps=0.35, seed=42,
            sparsity_check=False)
        dbg_println("build_energy: Starting energy pipeline")
        aspace, gl_energy = build_energy_maps(items, ep, gp, device=device)
        dbg_println(
            f"build_energy complete: nitems={aspace.nitems}, "
            f"nfeatures={aspace.nfeatures}, graph_nodes={gl_energy.nnodes}, "
            f"lambdas_len={aspace.nitems}")
        return aspace, gl_energy
