"""Plain reference of batched lambda-aware search: each query's taumode
lambda against the index's feature Laplacian, and its blended score

    s(q, i) = tau * cos(q, x_i) + (1 - tau) / (1 + |lambda_i - lambda_q|)

against every item, ranked descending, ties to the smaller id.  Imports
torch only, and the spectral reference beside it.
"""

from __future__ import annotations

import torch

from . import spectral
from .graph import unit_rows


def query_lambdas(q: torch.Tensor, state: dict) -> torch.Tensor:
    """Lambdas of the queries (rows of q) in the state's dtype."""
    return spectral.lambdas_of(q.to(state["lap_f"].dtype), state["lap_f"],
                               state["w_f"], state["tau_star"])


def scores(xu: torch.Tensor, lambdas: torch.Tensor, q: torch.Tensor,
           lam_q: torch.Tensor, tau: float) -> torch.Tensor:
    """[Q, n] blended scores of the queries against the unit corpus xu, in
    xu's dtype."""
    qn = unit_rows(q, xu.dtype)
    prox = 1.0 / (1.0 + torch.abs(lambdas.to(xu.dtype)[None, :]
                                  - lam_q.to(xu.dtype)[:, None]))
    return tau * (qn @ xu.T) + (1.0 - tau) * prox


def topk(s: torch.Tensor, k: int):
    """(values, ids int64) of each row's k best, descending, ties to the
    smaller id."""
    vals, ids = torch.topk(s, min(k + 1, s.shape[1]), dim=1)
    by_id = torch.argsort(ids, dim=1)
    vals, ids = torch.gather(vals, 1, by_id), torch.gather(ids, 1, by_id)
    order = torch.sort(vals, dim=1, descending=True,
                       stable=True).indices[:, :k]
    return torch.gather(vals, 1, order), torch.gather(ids, 1, order)
