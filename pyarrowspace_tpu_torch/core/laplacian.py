"""GraphLaplacian — the symmetrized item signal-graph in padded-ELL form.

API parity with the reference's `PyGraphLaplacian` wrapper
(reference src/lib.rs:26-62): builder-only construction, `nnodes`,
`shape()`, and a 5-key `graph_params` dict {eps, k, topk, p, sigma}.
Storage: fixed-width neighbour indices/weights (ELL) as torch tensors on
the build's device.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .params import GraphParams

_BUILDER_TOKEN = object()


class GraphLaplacian:
    """Sparse symmetric graph Laplacian L = D - W over the item graph."""

    def __init__(self, *args, **kwargs):
        # Parity: reference src/lib.rs:33-38 rejects direct construction.
        if kwargs.get("_token") is not _BUILDER_TOKEN:
            raise ValueError(
                "GraphLaplacian cannot be constructed directly; "
                "use ArrowSpaceBuilder.build_with_graph"
            )
        self._nbr_idx: torch.Tensor = kwargs["nbr_idx"]   # [N, m] int32, -1 pad
        self._nbr_w: torch.Tensor = kwargs["nbr_w"]       # [N, m]
        self._degrees: torch.Tensor = kwargs["degrees"]   # [N]
        self._params: GraphParams = kwargs["params"]
        self._n_dropped: int = int(kwargs.get("n_dropped", 0))
        self._nedges: int | None = None

    @classmethod
    def _from_ell(cls, nbr_idx, nbr_w, degrees, params: GraphParams,
                  n_dropped: int = 0) -> "GraphLaplacian":
        return cls(_token=_BUILDER_TOKEN, nbr_idx=nbr_idx, nbr_w=nbr_w,
                   degrees=degrees, params=params, n_dropped=n_dropped)

    # -- reference API -------------------------------------------------------
    @property
    def nnodes(self) -> int:
        return int(self._nbr_idx.shape[0])

    def shape(self) -> tuple[int, int]:
        n = self.nnodes
        return (n, n)

    @property
    def graph_params(self) -> dict[str, Any]:
        """{eps, k, topk, p, sigma} (parity: reference src/lib.rs:50-62)."""
        return self._params.as_dict()

    # -- extras ----------------------------------------------------------------
    @property
    def params(self) -> GraphParams:
        return self._params

    @property
    def degrees(self) -> torch.Tensor:
        return self._degrees

    @property
    def neighbor_indices(self) -> torch.Tensor:
        return self._nbr_idx

    @property
    def neighbor_weights(self) -> torch.Tensor:
        return self._nbr_w

    @property
    def nedges(self) -> int:
        """Number of undirected edges kept in the symmetrized graph
        (computed once — used as a degeneracy guard per search)."""
        if self._nedges is None:
            self._nedges = int((self._nbr_idx >= 0).sum()) // 2
        return self._nedges

    @property
    def n_dropped_edges(self) -> int:
        """Directed edges dropped by the fixed ELL width (hub overflow)."""
        return self._n_dropped

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """L @ v = D v - W v via a gather over the ELL neighbour lists."""
        v = torch.as_tensor(v, dtype=self._nbr_w.dtype,
                            device=self._nbr_w.device)
        gathered = torch.where(self._nbr_idx >= 0,
                               v[self._nbr_idx.clamp_min(0).to(torch.int64)],
                               0.0)
        wv = torch.sum(self._nbr_w * gathered, dim=1)
        return self._degrees * v - wv

    def to_dense(self) -> np.ndarray:
        """Dense L (small graphs / tests only)."""
        n = self.nnodes
        m = self._nbr_idx.shape[1]
        idx = self._nbr_idx.cpu().numpy()
        w = self._nbr_w.cpu().numpy()
        dense = np.zeros((n, n), dtype=w.dtype)
        rows = np.repeat(np.arange(n), m)
        cols = idx.reshape(-1)
        ww = w.reshape(-1)
        keep = cols >= 0
        dense[rows[keep], cols[keep]] = -ww[keep]
        dense[np.arange(n), np.arange(n)] = self._degrees.cpu().numpy()
        return dense

    def __repr__(self) -> str:
        return (f"GraphLaplacian(nnodes={self.nnodes}, "
                f"ell_width={self._nbr_idx.shape[1]}, "
                f"params={self.graph_params})")
