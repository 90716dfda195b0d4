"""The plain reference against known answers at tiny sizes: k-NN lists of
hand-made points, the ELL union with and without the width cap, the tie
rule of the top-k, and the upstream's test_0 orderings (four taus over
five items, reference tests/test_0.py:29-61) from the spectral state and
the blended score."""

import math

import numpy as np
import pytest
import torch

from reference import graph, serve, spectral

# The upstream's test_0 fixture (reference tests/test_0.py:4-18).
ITEMS_5X24 = np.array([
    [0.82, 0.11, 0.43, 0.28, 0.64, 0.32, 0.55, 0.48, 0.19, 0.73, 0.07, 0.36,
     0.58, 0.23, 0.44, 0.31, 0.52, 0.16, 0.61, 0.40, 0.27, 0.49, 0.35, 0.29],
    [0.79, 0.12, 0.45, 0.29, 0.61, 0.33, 0.54, 0.47, 0.21, 0.70, 0.08, 0.37,
     0.56, 0.22, 0.46, 0.30, 0.51, 0.18, 0.60, 0.39, 0.26, 0.48, 0.36, 0.30],
    [0.78, 0.13, 0.46, 0.27, 0.62, 0.34, 0.53, 0.46, 0.22, 0.69, 0.09, 0.35,
     0.55, 0.24, 0.45, 0.29, 0.50, 0.17, 0.59, 0.38, 0.28, 0.47, 0.34, 0.31],
    [0.81, 0.10, 0.44, 0.26, 0.63, 0.31, 0.56, 0.45, 0.20, 0.71, 0.06, 0.34,
     0.57, 0.25, 0.47, 0.33, 0.53, 0.15, 0.62, 0.41, 0.25, 0.50, 0.37, 0.27],
    [0.80, 0.12, 0.42, 0.25, 0.60, 0.35, 0.52, 0.49, 0.23, 0.68, 0.10, 0.38,
     0.54, 0.21, 0.43, 0.28, 0.49, 0.19, 0.58, 0.37, 0.29, 0.46, 0.33, 0.32]])
GRAPH_PARAMS_TEST0 = {"eps": 0.05, "k": 5, "topk": 3, "p": 2.0,
                      "sigma": 0.05}
EXPECTED_ORDERINGS = {1.0: [2, 1, 4], 0.9: [1, 2, 0], 0.6: [1, 3, 2],
                      0.55: [1, 3, 2]}

# Points on the unit circle at these angles (degrees): rows 1 and 2 are the
# same point (a tie), row 5 is opposite row 0.
ANGLES = [0.0, 30.0, 30.0, 60.0, 90.0, 180.0]


def _circle():
    a = np.radians(ANGLES)
    return torch.tensor(np.stack([np.cos(a), np.sin(a)], 1) * 3.0)


def _d(a, b):
    return 1.0 - max(0.0, math.cos(math.radians(a - b)))


def test_knn_rows_known_answers():
    xu = graph.unit_rows(_circle(), torch.float64)
    d, i = graph.knn_rows(xu, torch.arange(6), 3, eps=0.6)
    # Row 0: the tie at 30 degrees goes to the smaller id first; 90 degrees
    # (d = 1) and 180 (d = 1) are past eps.
    assert i[0].tolist() == [1, 2, 3]
    assert d[0].tolist() == pytest.approx([_d(0, 30), _d(0, 30), _d(0, 60)])
    # Row 1: its twin at distance 0, then 0 and 60 degrees (equal: the
    # smaller id first).
    assert i[1].tolist() == [2, 0, 3]
    # Row 5 has no neighbour within eps: (2.0, -1) entries.
    assert i[5].tolist() == [-1, -1, -1]
    assert d[5].tolist() == [2.0, 2.0, 2.0]
    # Lists longer than n - 1 are padded.
    d, i = graph.knn_rows(xu, torch.tensor([4]), 8, eps=2.0)
    assert i[0].tolist() == [3, 1, 2, 0, 5, -1, -1, -1]


def test_knn_rows_reads_the_distance_at_given_ids():
    """The distances read off the k-NN pass at given ids are the pairs'
    own distances, in blocks smaller than the rows."""
    xu = graph.unit_rows(torch.randn(300, 5, generator=torch.Generator()
                                     .manual_seed(1), dtype=torch.float64),
                         torch.float64)
    rows = torch.arange(0, 300, 3)
    at = torch.randint(0, 300, (rows.shape[0], 4),
                       generator=torch.Generator().manual_seed(2))
    graph_block, graph._block = graph._block, lambda n: 7
    try:
        d, i, d_at = graph.knn_rows(xu, rows, 4, eps=2.0, at=at)
    finally:
        graph._block = graph_block
    want = graph.pair_distances(xu, rows[:, None].expand_as(at).reshape(-1),
                                at.reshape(-1)).reshape(at.shape)
    assert torch.allclose(d_at, want, rtol=0, atol=1e-15)
    assert torch.equal(i, graph.knn_rows(xu, rows, 4, eps=2.0)[1])


def _brute_union(lists, r):
    cols = {c for c in lists[r] if c >= 0}
    cols |= {s for s in range(len(lists)) if r in lists[s]}
    return sorted(cols)


def test_ell_rows_union_without_cap():
    lists = torch.tensor([[1, 2], [0, -1], [3, 0], [0, 1], [0, 2]])
    xu = graph.unit_rows(torch.randn(5, 4, generator=torch.Generator()
                                     .manual_seed(0), dtype=torch.float64),
                         torch.float64)
    rows = torch.arange(5)
    got = graph.ell_rows(lists, rows, 8, xu, 0.5, 2.0)
    for r in range(5):
        cols, ws = got[r]
        assert cols.tolist() == _brute_union(lists.tolist(), r)
        want = [1.0 / (1.0 + ((1.0 - max(0.0, float(xu[r] @ xu[c]))) / 0.5)
                       ** 2) for c in cols.tolist()]
        assert ws.tolist() == pytest.approx(want)


def test_ell_rows_width_cap_keeps_edges_that_fit_both_rows():
    # Node 0 is a hub: four rows list it, so its union has 4 entries; at
    # width 2 only its two heaviest edges survive, in both rows.
    xu = graph.unit_rows(torch.tensor([[1.0, 0.0], [1.0, 0.1], [1.0, 0.2],
                                       [1.0, 0.3], [1.0, 0.4]],
                                      dtype=torch.float64), torch.float64)
    lists = torch.tensor([[-1], [0], [0], [0], [0]])
    got = graph.ell_rows(lists, torch.arange(5), 2, xu, 0.5, 2.0)
    assert got[0][0].tolist() == [1, 2]
    assert [got[r][0].tolist() for r in range(1, 5)] == [[0], [0], [], []]


def test_topk_ties_to_the_smaller_id():
    s = torch.tensor([[0.5, 0.9, 0.9, 0.1, 0.9]], dtype=torch.float64)
    vals, ids = serve.topk(s, 3)
    assert ids.tolist() == [[1, 2, 4]]
    assert vals.tolist() == [[0.9, 0.9, 0.9]]


@pytest.mark.parametrize("tau", sorted(EXPECTED_ORDERINGS))
def test_upstream_test0_orderings(tau):
    x = torch.tensor(ITEMS_5X24)
    state = spectral.index_state(x, GRAPH_PARAMS_TEST0)
    q = x[2:3] * 1.05
    lam_q = serve.query_lambdas(q, state)
    xu = graph.unit_rows(x, torch.float64)
    _, ids = serve.topk(serve.scores(xu, state["lambdas"], q, lam_q, tau), 3)
    assert ids[0].tolist() == EXPECTED_ORDERINGS[tau]


def test_spectral_state_matches_a_cpu_build():
    """The frozen copy's lambdas of a corpus past the reduction's size agree
    with the port's CPU build (float32, the last stage in float64 here)."""
    import pyarrowspace_tpu_torch as pt
    x = torch.randn(4200, 12, generator=torch.Generator().manual_seed(3)) * 12
    gp = {"eps": 1.31, "k": 5, "topk": 4, "p": 2.0, "sigma": 0.535}
    aspace, _ = pt.ArrowSpaceBuilder.build(gp, x, device="cpu")
    state = spectral.index_state(x, gp)
    assert aspace.lambdas() == pytest.approx(state["lambdas"].numpy(),
                                             abs=1e-5)
