"""Parameter objects and dict-parsing with reference-identical semantics.

GraphParams mirrors the reference's `graph_params` dict contract
(reference: src/helpers.rs:48-77 — eps/k/topk/p required, sigma optional and
defaulting to eps*0.5 when missing or None) plus the engine-internal knobs the
reference binding hardcodes (seed=42, normalise=false, synthesis=Median,
dims_reduction=true — reference: src/lib.rs:278-286 and the build-config log
line in tests/output/1760705545_v0_16/suggested_eps.md:3).

EnergyParams mirrors the 11 optional keys over `EnergyParams::default()`
(reference: src/energyparams.rs:6-46; defaults documented at src/lib.rs:311-323).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Mapping, Optional


class TauMode(enum.Enum):
    """How the synthesis scale tau* is derived from the corpus energies.

    The reference engine's builder default is `synthesis=Median`
    (build-config log, reference tests/output/1760705545_v0_16/suggested_eps.md:3):
    tau* := median of the raw per-item Rayleigh/Dirichlet energies.
    """

    MEDIAN = "median"
    MEAN = "mean"
    MAX = "max"
    FIXED = "fixed"  # tau* given explicitly via GraphParams.tau_fixed


@dataclasses.dataclass(frozen=True)
class GraphParams:
    """Signal-graph construction parameters.

    eps   : max rectified-cosine distance per candidate edge
            (d(i,j) = 1 - max(0, cos(x_i, x_j)); edge kept iff d <= eps).
    k     : per-node neighbor cap (k nearest by distance after eps filter).
    topk  : number of results returned by `ArrowSpace.search`.
    p     : edge-weight kernel exponent, w = 1 / (1 + (d/sigma)^p).
    sigma : kernel scale; None resolves to eps * 0.5 (reference
            src/helpers.rs:69-72 — the binding's default, which overrides the
            engine-doc default of sigma := eps).

    Engine knobs the reference binding hardcodes, surfaced here explicitly
    (SURVEY.md §5 config plan):

    normalise      : store unit-normalized vectors instead of raw ones
                     (graph topology is unaffected — cosine is scale-invariant;
                     reference NORMALISATION.md).  Reference build logs show
                     normalise=false.
    seed           : PRNG seed for sampling/clustering (reference lib.rs:284: 42).
    synthesis      : TauMode for lambda synthesis (reference default Median).
    tau_fixed      : tau* when synthesis == TauMode.FIXED.
    dims_reduction : run the sampling/clustering reduction stage
                     (reference lib.rs:283 passes (true, Some(eps))).
    reduction_eps  : clustering radius for the reduction stage (None -> eps).
    sparsity_check : reference binding disables it (lib.rs:286).
    """

    eps: float
    k: int
    topk: int
    p: float
    sigma: Optional[float] = None
    normalise: bool = False
    seed: int = 42
    synthesis: TauMode = TauMode.MEDIAN
    tau_fixed: Optional[float] = None
    dims_reduction: bool = True
    reduction_eps: Optional[float] = None
    sparsity_check: bool = False

    @property
    def sigma_resolved(self) -> float:
        """sigma, with the binding's missing/None default of eps*0.5
        (reference src/helpers.rs:69-72)."""
        return self.sigma if self.sigma is not None else self.eps * 0.5

    def as_dict(self) -> dict[str, Any]:
        """The 5-key dict exposed as `GraphLaplacian.graph_params`
        (reference src/lib.rs:50-62)."""
        return {
            "eps": self.eps,
            "k": self.k,
            "topk": self.topk,
            "p": self.p,
            "sigma": self.sigma_resolved,
        }


def parse_graph_params(d: Optional[Mapping[str, Any]]) -> Optional[GraphParams]:
    """Parse the user-facing `graph_params` dict.

    Error-message parity with reference src/helpers.rs:48-77:
    eps/k/topk/p are required; sigma missing or None -> eps * 0.5.
    Returns None when d is None (builder then uses engine defaults), matching
    the Option<> passthrough at reference src/lib.rs:270-300.
    """
    if d is None:
        return None
    for key in ("eps", "k", "topk", "p"):
        if key not in d:
            raise ValueError(f"graph_params['{key}'] is required")
    eps = float(d["eps"])
    k = int(d["k"])
    topk = int(d["topk"])
    p = float(d["p"])
    sigma = d.get("sigma", None)
    sigma = float(sigma) if sigma is not None else eps * 0.5
    extra = {}
    # TPU-native extras (explicitly surfaced hardcoded knobs); optional keys.
    for key in ("normalise", "seed", "dims_reduction", "sparsity_check"):
        if key in d and d[key] is not None:
            extra[key] = d[key]
    if "synthesis" in d and d["synthesis"] is not None:
        syn = d["synthesis"]
        extra["synthesis"] = TauMode(syn) if not isinstance(syn, TauMode) else syn
    if "tau_fixed" in d and d["tau_fixed"] is not None:
        extra["tau_fixed"] = float(d["tau_fixed"])
    if "reduction_eps" in d and d["reduction_eps"] is not None:
        extra["reduction_eps"] = float(d["reduction_eps"])
    return GraphParams(eps=eps, k=k, topk=topk, p=p, sigma=sigma, **extra)


DEFAULT_GRAPH_PARAMS = GraphParams(eps=1e-3, k=6, topk=3, p=2.0, sigma=None)
"""Engine defaults when no graph_params dict is supplied
(reference GRAPH_VARIABLES.md: eps≈1e-3, k≈6, p=2.0, sigma:=None)."""


@dataclasses.dataclass(frozen=True)
class EnergyParams:
    """EnergyMaps pipeline parameters.

    Field names, types and defaults are reference-identical
    (reference src/energyparams.rs:6-46; doc comment src/lib.rs:311-323).
    """

    optical_tokens: Optional[int] = None  # target centroids after compression
    trim_quantile: float = 0.1            # fraction trimmed per bin
    eta: float = 0.1                      # diffusion step size
    steps: int = 4                        # diffusion iterations
    split_quantile: float = 0.9           # dispersion split threshold
    neighbor_k: int = 8                   # neighborhood size
    split_tau: float = 0.15               # split offset magnitude
    w_lambda: float = 1.0                 # lambda weight in energy distance
    w_disp: float = 0.5                   # dispersion weight
    w_dirichlet: float = 0.25             # Dirichlet weight
    candidate_m: int = 32                 # candidate pool size


def parse_energy_params(d: Optional[Mapping[str, Any]]) -> EnergyParams:
    """Parse the `energy_params` dict over defaults
    (parity: reference src/energyparams.rs:6-46)."""
    params = EnergyParams()
    if d is None:
        return params
    kwargs: dict[str, Any] = {}
    if "optical_tokens" in d:
        v = d["optical_tokens"]
        kwargs["optical_tokens"] = None if v is None else int(v)
    for key, cast in (
        ("trim_quantile", float),
        ("eta", float),
        ("steps", int),
        ("split_quantile", float),
        ("neighbor_k", int),
        ("split_tau", float),
        ("w_lambda", float),
        ("w_disp", float),
        ("w_dirichlet", float),
        ("candidate_m", int),
    ):
        if key in d and d[key] is not None:
            kwargs[key] = cast(d[key])
    return dataclasses.replace(params, **kwargs)
