"""The k-NN variants of the PyTorch port (ARROWSPACE_KNN_VARIANT) on the
CPU: each against the JAX package's Pallas variant in interpret mode, as
tests/test_graph.py drives it, and each bit for bit against the port's
row-major scan, ties included; the seeded scan of the extend; and the
build under each variant.  Inputs are made with numpy from a seed and
handed to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyarrowspace_tpu_torch as pt
from pyarrowspace_tpu.ops.distance import unit_normalize as jax_unit
from pyarrowspace_tpu.ops.pallas.knn import knn_graph_candidates_pallas
from pyarrowspace_tpu_torch.ops.cuda import knn, knn_t
from pyarrowspace_tpu_torch.ops.distance import (VARIANTS,
                                                 knn_graph_candidates,
                                                 projection_order,
                                                 unit_normalize)


def _tie_free(seed):
    """The corpora of tests/test_graph.py's variant tests (eps 0.9 masks
    the d = 1.0 plateau, so distances are tie-free)."""
    rng = np.random.default_rng(seed)
    if seed == 61:   # clustered: the regime the locality variants target
        cents = rng.normal(size=(12, 32))
        return (cents[rng.integers(0, 12, size=500)]
                + 0.3 * rng.normal(size=(500, 32))).astype(np.float32)
    return rng.normal(size=(300, 32)).astype(np.float32)


def _tied(dtype):
    """Rows with four entries of +-0.5, half of them duplicated: exact
    distance ties at every rank, the d = 1.0 plateau kept (eps >= 1)."""
    rng = np.random.default_rng(3)
    x = np.zeros((400, 16))
    for r in range(400):
        x[r, rng.choice(16, size=4, replace=False)] = rng.choice([-.5, .5], 4)
    x[200:] = x[:200]
    return torch.from_numpy(x.astype(dtype))


@pytest.mark.parametrize("seed", [57, 58, 61])
@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_matches_pallas_interpret(seed, variant, monkeypatch):
    """Ids exact, distances within 1e-6 (the two products sum in different
    orders)."""
    monkeypatch.setenv("ARROWSPACE_KNN_SUB", "64")
    x = _tie_free(seed)
    d_ref, i_ref = knn_graph_candidates_pallas(
        jax_unit(jnp.asarray(x)), 7, 0.9, interpret=True, variant=variant)
    d, i = knn_graph_candidates(unit_normalize(torch.from_numpy(x)), 7, 0.9,
                                variant=variant)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("k,eps", [(5, 1.0), (20, 1.3)])
@pytest.mark.parametrize("variant", VARIANTS[1:])
def test_variant_bitwise_rowmajor_on_ties(variant, k, eps, dtype):
    xu = _tied(dtype)
    d0, i0 = knn_graph_candidates(xu, k, eps, variant="rowmajor")
    d, i = knn_graph_candidates(xu, k, eps, variant=variant)
    assert torch.equal(i, i0) and torch.equal(d, d0)


@pytest.mark.parametrize("sub", ["64", "96", "128"])
def test_subtile_scans_every_column(sub, monkeypatch):
    """A width that does not divide the tile (96) drops no column: at 1,000
    rows the reference's 1,024-column tile holds 10 slices of 96 and would
    leave columns 960-999 out."""
    monkeypatch.setenv("ARROWSPACE_KNN_SUB", sub)
    rng = np.random.default_rng(14)
    xu = unit_normalize(torch.from_numpy(rng.normal(size=(1000, 12))))
    d0, i0 = knn_graph_candidates(xu, 9, 1.2, variant="rowmajor")
    d, i = knn_graph_candidates(xu, 9, 1.2, variant="subtile")
    assert torch.equal(i, i0) and torch.equal(d, d0)
    assert (i0 >= 960).any()


@pytest.mark.parametrize("bad", ["0", "-3", "abc", "1.5"])
def test_subtile_rejects_bad_width(bad, monkeypatch):
    monkeypatch.setenv("ARROWSPACE_KNN_SUB", bad)
    xu = unit_normalize(torch.ones((4, 3), dtype=torch.float64))
    with pytest.raises(ValueError, match="ARROWSPACE_KNN_SUB"):
        knn_graph_candidates(xu, 2, 0.5, variant="subtile")


def test_unknown_variant_raises(monkeypatch):
    xu = unit_normalize(torch.ones((4, 3), dtype=torch.float64))
    with pytest.raises(ValueError, match="rowmajor, transposed, subtile, "
                                         "diagstart, reorder"):
        knn_graph_candidates(xu, 2, 0.5, variant="colmajor")
    monkeypatch.setenv("ARROWSPACE_KNN_VARIANT", "diagonal")
    with pytest.raises(ValueError, match="unknown k-NN variant 'diagonal'"):
        pt.ArrowSpaceBuilder.build({"eps": 1.0, "k": 2, "topk": 2, "p": 2.0,
                                    "sigma": None}, np.eye(4), device="cpu")


def test_cpu_calls_launch_nothing():
    counters = (knn, "LAUNCHES"), (knn, "SEEDED_LAUNCHES"), \
        (knn, "DIAG_START_LAUNCHES"), (knn, "PERM_LAUNCHES"), \
        (knn_t, "LAUNCHES")
    before = [getattr(m, c) for m, c in counters]
    xu = unit_normalize(torch.from_numpy(
        np.random.default_rng(2).normal(size=(200, 8))))
    for variant in VARIANTS:
        knn_graph_candidates(xu, 6, 0.9, variant=variant)
    d, i = knn_t.knn_scan_t(xu, 6, 0.9, 20, 50)
    dp, ip = knn.knn_plain(xu, 6, 0.9, slice(20, 70))
    assert torch.equal(d, dp) and torch.equal(i, ip)
    assert [getattr(m, c) for m, c in counters] == before


@pytest.mark.parametrize("c,k", [(1, 5), (63, 5), (64, 9), (150, 9),
                                 (199, 30)])
def test_seeded_plain_scan(c, k):
    """Seeded with the lists over [0, c), the scan of [c, N) is the full
    scan; seeded with empty lists it is the unseeded scan of [c, N)."""
    xu = unit_normalize(torch.from_numpy(
        np.random.default_rng(c).normal(size=(200, 10))))
    full = knn.knn_scan(xu, k, 1.1)
    head = knn.knn_scan(xu[:c], k, 1.1)
    seeded = knn.knn_scan(xu, k, 1.1, 0, c, col_start=c, seed=head)
    assert all(torch.equal(a, b[:c]) for a, b in zip(seeded, full))
    empty = (torch.full((c, k), 2.0, dtype=xu.dtype),
             torch.full((c, k), -1, dtype=torch.int32))
    tail = knn.knn_plain(xu, k, 1.1, slice(0, c), col_start=c)
    seeded = knn.knn_plain(xu, k, 1.1, slice(0, c), col_start=c, seed=empty)
    assert all(torch.equal(a, b) for a, b in zip(seeded, tail))
    assert bool((tail[1][tail[1] >= 0] >= c).all())


def test_reordered_plain_unpermutes():
    """knn_plain_reordered under an arbitrary permutation, and the
    projection order itself, give the row-major lists."""
    xu = _tied(np.float64)
    d0, i0 = knn.knn_plain(xu, 12, 1.0)
    for perm in (projection_order(xu),
                 torch.from_numpy(np.random.default_rng(0).permutation(400))):
        d, i = knn.knn_plain_reordered(xu, 12, 1.0, perm)
        assert torch.equal(i, i0) and torch.equal(d, d0)
    perm = projection_order(xu)
    assert torch.equal(torch.sort(perm).values, torch.arange(400))


@pytest.mark.parametrize("variant", VARIANTS[1:])
def test_build_under_each_variant_equals_default(variant, monkeypatch):
    rng = np.random.default_rng(8)
    items = rng.normal(size=(300, 24)) + 0.1
    gp = {"eps": 1.0, "k": 8, "topk": 5, "p": 2.0, "sigma": 0.4}
    a0, g0 = pt.ArrowSpaceBuilder.build(gp, items, device="cpu")
    monkeypatch.setenv("ARROWSPACE_KNN_VARIANT", variant)
    a, g = pt.ArrowSpaceBuilder.build(gp, items, device="cpu")
    for x, y in ((a._knn_dist, a0._knn_dist), (a._knn_idx, a0._knn_idx),
                 (g.neighbor_indices, g0.neighbor_indices),
                 (g.neighbor_weights, g0.neighbor_weights),
                 (a._lambdas, a0._lambdas)):
        assert torch.equal(x, y)
