"""ArrowSpace — the built index: item data, per-item synthetic lambdas, and
the stored feature-space spectral state used to score queries.

API parity with the reference's `PyArrowSpace` wrapper (reference
src/lib.rs:64-263) for the search paths ported so far: builder-only
construction; `nitems`, `nfeatures`,
`get_item(idx) -> (np.ndarray float64, float)`,
`lambdas() -> np.ndarray`, `search(query, gl, tau)` returning a list of
(index, score) by descending score, and `search_batch` in modes "exact",
"subtile" and "auto".  State lives as torch tensors on the build's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .laplacian import GraphLaplacian
from .params import GraphParams
from ..ops import search as search_ops
from ..ops.cuda import scan_topk
from ..ops.distance import unit_normalize
from ..ops.subtile_scan import build_subtile_state
from ..utils.debug import dbg_println

_BUILDER_TOKEN = object()

# mode="auto" serves an index of at least this many items with "subtile",
# a smaller one with "exact" (the reference's rule).
AUTO_SUBTILE_MIN_ITEMS = 131_072

# search_batch modes of the reference that this package does not run yet,
# with the ROADMAP.md item that ports each.
_PENDING_MODES = {
    "ivf": "Slice C item 13 (gather IVF)",
    "ivf_block": "Slice B item 11 (blocked IVF and certified serving)",
    "certified": "Slice B item 11 (blocked IVF and certified serving)",
    "int8": "Slice C item 12 (int8 scan + rescore)",
}


class ArrowItem:
    """A single (features, lambda) pair (reference core::ArrowItem)."""

    __slots__ = ("item", "lambda_")

    def __init__(self, item: np.ndarray, lambda_: float):
        self.item = np.asarray(item, dtype=np.float64)
        self.lambda_ = float(lambda_)


class ArrowSpace:
    def __init__(self, *args, **kwargs):
        # Parity: reference src/lib.rs:71-76 rejects direct construction.
        if kwargs.get("_token") is not _BUILDER_TOKEN:
            raise ValueError(
                "ArrowSpace cannot be constructed directly; "
                "use ArrowSpaceBuilder.build"
            )
        self._data: torch.Tensor = kwargs["data"]            # [N, F]
        self._data_unit: torch.Tensor = kwargs["data_unit"]  # [N, F] unit rows
        self._lambdas: torch.Tensor = kwargs["lambdas"]      # [N]
        self._e_raw: torch.Tensor = kwargs["e_raw"]          # [N]
        self._lap_f: torch.Tensor = kwargs["lap_f"]          # [F, F]
        self._w_f: torch.Tensor = kwargs["w_f"]              # [F, F]
        self._tau_star: torch.Tensor = kwargs["tau_star"]    # 0-dim
        self._params: GraphParams = kwargs["params"]
        self._rayleigh_normalized: bool = kwargs.get("rayleigh_normalized",
                                                     False)
        from ..spectral.taumode import TAU_MIX
        self._tau_mix: float = kwargs.get("tau_mix", TAU_MIX)
        # Reduction artifacts and the directed k-NN candidates of the build.
        self._centroids: Optional[torch.Tensor] = kwargs.get("centroids")
        self._assignments: Optional[torch.Tensor] = kwargs.get("assignments")
        self._knn_dist: Optional[torch.Tensor] = kwargs.get("knn_dist")
        self._knn_idx: Optional[torch.Tensor] = kwargs.get("knn_idx")
        # Padded serving layout of mode="subtile", made at its first use.
        self._subtile: Optional[dict] = None

    @classmethod
    def _from_build(cls, **kwargs) -> "ArrowSpace":
        return cls(_token=_BUILDER_TOKEN, **kwargs)

    # -- reference API --------------------------------------------------------
    @property
    def nitems(self) -> int:
        return int(self._data.shape[0])

    @property
    def nfeatures(self) -> int:
        return int(self._data.shape[1])

    @property
    def device(self) -> torch.device:
        return self._data.device

    def get_item(self, idx: int) -> tuple[np.ndarray, float]:
        """(features float64, lambda) for item idx
        (parity: reference src/lib.rs:100-124, ValueError on out-of-range)."""
        if idx >= self.nitems or idx < 0:
            raise ValueError(f"index {idx} out of range [0, {self.nitems})")
        feats = self._data[idx].cpu().numpy().astype(np.float64)
        return feats, float(self._lambdas[idx])

    def lambdas(self) -> np.ndarray:
        """Per-item synthetic lambdas as float64 (reference lib.rs:126-128)."""
        return self._lambdas.cpu().numpy().astype(np.float64)

    def _as_queries(self, queries) -> torch.Tensor:
        return torch.as_tensor(queries).to(device=self.device,
                                           dtype=self._data.dtype)

    def prepare_query_item(self, query, gl: GraphLaplacian) -> float:
        """Synthetic lambda of a query vector against the stored feature
        Laplacian (reference engine `prepare_query_item`)."""
        q = self._as_queries(query).reshape(1, -1)
        return float(search_ops.query_lambdas(
            q, self._lap_f, self._w_f, self._tau_star,
            rayleigh_normalized=self._rayleigh_normalized,
            tau_mix=self._tau_mix)[0])

    def _check_query(self, query) -> np.ndarray:
        if isinstance(query, torch.Tensor):
            query = query.cpu()
        v = np.asarray(query, dtype=np.float64).reshape(-1)
        if v.shape[0] != self.nfeatures:
            raise ValueError(
                f"query length {v.shape[0]} must match nfeatures "
                f"{self.nfeatures}")
        return v

    def search(self, query, gl: GraphLaplacian, tau: float
               ) -> list[tuple[int, float]]:
        """Lambda-aware search (parity: reference src/lib.rs:132-174).

        Returns graph_params.topk results as (index, score) descending.
        tau is the blend: score = tau*cos + (1-tau)*lambda-proximity.  On
        CUDA the scan is kernel K2 with one query; on CPU the plain
        ``lambda_aware_topk``.
        """
        v = self._check_query(query)
        lam_q = self.prepare_query_item(v, gl)
        # Loud-failure parity (reference lib.rs:156-159): a degenerate
        # query lambda or an edgeless signal graph.  An explicit raise, not
        # an assert, so the check survives `python -O`.
        if lam_q == 0.0 or gl.nedges == 0:
            raise AssertionError(
                "The lambdas are zero, check the magnitude of items "
                "and eps.")
        dbg_println(f"search: qlen={v.shape[0]}, lambda_q={lam_q:.6f}")
        topk = min(gl.params.topk, self.nitems)
        dt = self._data.dtype
        q = torch.as_tensor(v, dtype=dt, device=self.device)
        lam_t = torch.as_tensor(lam_q, dtype=dt, device=self.device)
        if self.device.type == "cuda":
            idx, vals = scan_topk.lambda_search(
                self._data_unit, self._lambdas, unit_normalize(q)[None, :],
                lam_t.reshape(1), float(tau), topk)
            idx, vals = idx[0], vals[0]
        else:
            idx, vals = search_ops.lambda_aware_topk(
                self._data_unit, self._lambdas, q, lam_t,
                torch.as_tensor(tau, dtype=dt), topk)
        return [(int(i), float(s)) for i, s in zip(idx.tolist(),
                                                   vals.tolist())]

    def search_batch(self, queries, gl: GraphLaplacian, tau: float,
                     topk: Optional[int] = None, mode: str = "exact"):
        """Batched lambda-aware search: queries [Q, F] ->
        (indices [Q, topk] np.int32, scores [Q, topk]).

        mode "exact" scans the full corpus: query-lambda synthesis, then
        the blended scan with a running top-k (kernel K2 on CUDA).
        mode "subtile" routes through the subtile maxima (kernels K3, K4b,
        K5 and K4a on CUDA; ops/subtile_scan.py) over a padded bf16 copy
        of the corpus made at its first use, and rescores a 2 x topk pool
        in float32.  mode "auto" is "subtile" for an index of
        AUTO_SUBTILE_MIN_ITEMS items or more, else "exact".  The
        reference's other modes are not ported yet and raise
        NotImplementedError naming their ROADMAP item."""
        if mode in _PENDING_MODES:
            raise NotImplementedError(
                f"search_batch(mode={mode!r}) is not ported yet: ROADMAP.md "
                f"{_PENDING_MODES[mode]}")
        if mode not in ("auto", "exact", "subtile"):
            raise ValueError(f"unknown search mode {mode!r}; expected "
                             "'auto', 'exact', 'int8', 'subtile', 'ivf', "
                             "'ivf_block', or 'certified'")
        if mode == "auto":
            mode = ("subtile" if self.nitems >= AUTO_SUBTILE_MIN_ITEMS
                    else "exact")
        q = self._as_queries(queries)
        if q.dim() != 2 or q.shape[1] != self.nfeatures:
            raise ValueError(
                f"queries must be [Q, {self.nfeatures}], got "
                f"{tuple(q.shape)}")
        topk = gl.params.topk if topk is None else int(topk)
        topk = min(topk, self.nitems)
        if mode == "subtile":
            f32 = torch.float32
            if self._subtile is None:
                self._subtile = build_subtile_state(
                    self._data_unit.to(f32), self._lambdas.to(f32))
            st = self._subtile
            idx, vals = search_ops.fused_query_pipeline_subtile(
                st["xu_scan"], st["xu_f32"], st["lambdas"], st["n_real"],
                self._lap_f.to(f32), self._w_f.to(f32),
                self._tau_star.to(f32), q.to(f32), float(tau), topk=topk,
                rayleigh_normalized=self._rayleigh_normalized,
                tau_mix=self._tau_mix)
            return idx.cpu().numpy(), vals.cpu().numpy()
        tau_arg = (float(tau) if self.device.type == "cuda"
                   else torch.as_tensor(tau, dtype=self._data.dtype))
        idx, vals = search_ops.fused_query_pipeline(
            self._data_unit, self._lambdas, self._lap_f, self._w_f,
            self._tau_star, q, tau_arg, topk=topk,
            rayleigh_normalized=self._rayleigh_normalized,
            tau_mix=self._tau_mix)
        return idx.cpu().numpy(), vals.cpu().numpy()

    @property
    def tau_star(self) -> float:
        return float(self._tau_star)

    def __repr__(self) -> str:
        return (f"ArrowSpace(nitems={self.nitems}, "
                f"nfeatures={self.nfeatures}, tau_star={self.tau_star:.6g})")
