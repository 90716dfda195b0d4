"""The ELL budget switch ARROWSPACE_ELL_BUDGET_BYTES in the port's build,
against the JAX package's on the same hub-heavy corpus (the corpus of
tests/test_hub_cap.py): at a budget of about 16 columns both keep the
capped graph, warn, and drop the same number of edges."""

import dataclasses
import logging

import numpy as np
import pytest

from pyarrowspace_tpu.core.params import parse_graph_params as jx_parse
from pyarrowspace_tpu.graph.build import BuildConfig as JxConfig
from pyarrowspace_tpu.graph.build import build_standard as jx_build
from pyarrowspace_tpu_torch.core.params import parse_graph_params as pt_parse
from pyarrowspace_tpu_torch.graph.build import BuildConfig as PtConfig
from pyarrowspace_tpu_torch.graph.build import build_standard as pt_build

GP = {"eps": 0.9, "k": 6, "topk": 6, "p": 2.0, "sigma": 0.3}
N_CENTERS, PER_GROUP, DIM = 12, 30, 48


@pytest.fixture(scope="module")
def hub_corpus():
    """Cluster centres planted in the corpus: each centre row's union
    degree is about PER_GROUP, far above the 2k = 12 ELL default."""
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(N_CENTERS, DIM))
    members = (np.repeat(centers, PER_GROUP, axis=0)
               + 0.3 * rng.normal(size=(N_CENTERS * PER_GROUP, DIM)))
    return np.concatenate([centers, members], axis=0) * 10.0


def _gp(parse):
    return dataclasses.replace(parse(GP), dims_reduction=True,
                               reduction_eps=GP["eps"], seed=42,
                               sparsity_check=False)


def _warned(caplog) -> bool:
    return any("still drops" in r.message
               and "ARROWSPACE_ELL_BUDGET_BYTES" in r.message
               for r in caplog.records)


def test_budget_switch_caps_the_width_as_the_reference(hub_corpus,
                                                       monkeypatch, caplog):
    n = hub_corpus.shape[0]
    # About 16 columns: 16 * (8 + 4) bytes an entry (float64 weights) * n.
    monkeypatch.setenv("ARROWSPACE_ELL_BUDGET_BYTES", str(16 * 12 * n))
    monkeypatch.setattr(logging.getLogger("arrowspace"), "propagate", True)
    with caplog.at_level(logging.WARNING):
        _, gl_pt = pt_build(hub_corpus, _gp(pt_parse), PtConfig(),
                            device="cpu")
    assert _warned(caplog)
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        _, gl_jx = jx_build(hub_corpus, _gp(jx_parse), JxConfig())
    assert _warned(caplog)
    assert gl_pt.n_dropped_edges > 0
    assert gl_pt.n_dropped_edges == gl_jx.n_dropped_edges
    assert gl_pt._nbr_idx.shape[1] == gl_jx._nbr_idx.shape[1] == 16


def test_default_budget_keeps_every_edge(hub_corpus, monkeypatch):
    monkeypatch.delenv("ARROWSPACE_ELL_BUDGET_BYTES", raising=False)
    _, gl = pt_build(hub_corpus, _gp(pt_parse), PtConfig(), device="cpu")
    assert gl.n_dropped_edges == 0
