"""The PyTorch port's incremental extend (ArrowSpaceBuilder.extend) on the
CPU in float64: the cases of tests/test_extend.py with the same bitwise
comparisons against a rebuild of the concatenated corpus, and the port's
extend against the JAX package's.

Bit-for-bit equality needs every distance of the extend to round as the
rebuild's does.  Torch's CPU product does not guarantee that for every
shape (a one-row product is a matrix-vector call, and at wide F a product
narrower than 256 columns sums in another order), so the plain k-NN
computes every distance in products of 256 rows by at least 256 columns
(ops/cuda/knn.py _cosines); the cases across column widths hold the BLAS
to giving such products the same bits at every width."""

import numpy as np
import pytest
import torch

import pyarrowspace_tpu as jx
import pyarrowspace_tpu_torch as pt
from pyarrowspace_tpu_torch.graph.build import BuildConfig
from pyarrowspace_tpu_torch.io import load_index, save_index

GP = {"eps": 0.8, "k": 5, "topk": 4, "p": 2.0, "sigma": None}


def _corpus(n, f=16, seed=0, scale=10.0):
    return np.random.default_rng(seed).standard_normal((n, f)) * scale


def _build(items, gp=GP):
    return pt.ArrowSpaceBuilder.build(gp, items, device="cpu")


def _assert_index_equal(a, b):
    (aa, ga), (ab, gb) = a, b
    for x, y in ((ga.neighbor_indices, gb.neighbor_indices),
                 (ga.neighbor_weights, gb.neighbor_weights),
                 (ga.degrees, gb.degrees), (aa._lambdas, ab._lambdas),
                 (aa._knn_dist, ab._knn_dist), (aa._knn_idx, ab._knn_idx)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert ga.n_dropped_edges == gb.n_dropped_edges
    assert float(aa._tau_star) == float(ab._tau_star)


@pytest.mark.parametrize("n_old,n_new,seed", [
    (60, 25, 0),        # test_extend_equals_rebuild
    (40, 1, 4),         # test_single_row_extend
    (12, 90, 6),        # test_extend_larger_than_original
    (4, 30, 8),         # test_extend_from_tiny_corpus_grows_k
])
def test_extend_equals_rebuild(n_old, n_new, seed):
    old = _corpus(n_old, seed=seed)
    new = _corpus(n_new, seed=seed + 1)
    extended = pt.ArrowSpaceBuilder.extend(*_build(old), new)
    assert extended[0].device.type == "cpu"
    assert extended[0]._data.dtype == torch.float64
    _assert_index_equal(extended, _build(np.concatenate([old, new])))


@pytest.mark.parametrize("n_old,n_new,f", [(250, 30, 384), (500, 40, 200)])
def test_extend_equals_rebuild_across_tile_widths(n_old, n_new, f):
    """The old corpus fits one 256-column product, the extended one needs a
    512-column product: the old pairs keep their bits."""
    old = _corpus(n_old, f=f, seed=n_old)
    new = _corpus(n_new, f=f, seed=n_old + 1)
    gp = {"eps": 1.0, "k": 6, "topk": 4, "p": 2.0, "sigma": None}
    extended = pt.ArrowSpaceBuilder.extend(*_build(old, gp), new)
    _assert_index_equal(extended, _build(np.concatenate([old, new]), gp))


def test_extend_search_matches_rebuild():
    old = _corpus(80, seed=2)
    new = _corpus(40, seed=3)
    ea, eg = pt.ArrowSpaceBuilder.extend(*_build(old), new)
    ra, rg = _build(np.concatenate([old, new]))
    q = old[7] * 1.01
    for tau in (1.0, 0.62):
        assert ea.search(q, eg, tau) == ra.search(q, rg, tau)


def test_sequential_extends_equal_one_rebuild():
    parts = [_corpus(50, seed=s) for s in range(4)]
    idx = _build(parts[0])
    for p in parts[1:]:
        idx = pt.ArrowSpaceBuilder.extend(*idx, p)
    _assert_index_equal(idx, _build(np.concatenate(parts)))


def test_extend_across_reduction_threshold():
    """Crossing reduction_min_n switches the feature-Laplacian signals from
    raw rows to centroids; extend must follow the same gate."""
    cfg = BuildConfig(reduction_min_n=128)
    old = _corpus(100, seed=10)
    new = _corpus(60, seed=11)

    def builder():
        return (pt.ArrowSpaceBuilder.new()
                .with_lambda_graph(GP["eps"], GP["k"], GP["topk"], GP["p"],
                                   0.4)
                .with_dims_reduction(True, GP["eps"])
                .with_build_config(cfg))

    a, g = builder().build_rows(old, device="cpu")
    extended = pt.ArrowSpaceBuilder.extend(a, g, new, config=cfg)
    rebuilt = builder().build_rows(np.concatenate([old, new]), device="cpu")
    assert extended[0].nitems == 160
    assert extended[0]._centroids is not None
    _assert_index_equal(extended, rebuilt)


def test_extend_eps_isolated_rows():
    """Rows with no neighbour within eps stay isolated identically."""
    rng = np.random.default_rng(12)
    old = np.eye(20) * 5.0 + 0.01 * rng.standard_normal((20, 20))
    new = np.eye(20)[:6] * -5.0
    gp = {"eps": 0.3, "k": 4, "topk": 3, "p": 2.0, "sigma": None}
    extended = pt.ArrowSpaceBuilder.extend(*_build(old, gp), new)
    rebuilt = _build(np.concatenate([old, new]), gp)
    _assert_index_equal(extended, rebuilt)
    assert bool((extended[0]._knn_idx[20:] == -1).all())


def test_extend_persist_roundtrip(tmp_path):
    old = _corpus(50, seed=13)
    new = _corpus(20, seed=14)
    p = str(tmp_path / "idx.npz")
    save_index(p, *_build(old))
    extended = pt.ArrowSpaceBuilder.extend(*load_index(p, device="cpu"), new)
    _assert_index_equal(extended, _build(np.concatenate([old, new])))


def test_extend_under_every_variant(monkeypatch):
    """An index built under any k-NN variant extends to the rebuild."""
    old = _corpus(70, seed=21)
    new = _corpus(30, seed=22)
    rebuilt = _build(np.concatenate([old, new]))
    for variant in ("transposed", "diagstart", "reorder"):
        monkeypatch.setenv("ARROWSPACE_KNN_VARIANT", variant)
        _assert_index_equal(pt.ArrowSpaceBuilder.extend(*_build(old), new),
                            rebuilt)


def test_extend_without_knn_state_raises():
    a, g = _build(_corpus(30, seed=15))
    a._knn_dist = None
    a._knn_idx = None
    with pytest.raises(ValueError, match="cannot be extended"):
        pt.ArrowSpaceBuilder.extend(a, g, _corpus(5, seed=16))


def test_extend_feature_mismatch_raises():
    a, g = _build(_corpus(30, seed=17))
    with pytest.raises(ValueError, match="features"):
        pt.ArrowSpaceBuilder.extend(a, g, _corpus(5, f=8, seed=18))


def test_extend_empty_rejected():
    a, g = _build(_corpus(30, seed=19))
    with pytest.raises(ValueError, match="non-empty 2D"):
        pt.ArrowSpaceBuilder.extend(a, g, np.zeros((0, 16)))


@pytest.mark.parametrize("n_old,n_new,seed", [(60, 25, 30), (90, 45, 32)])
def test_extend_matches_jax_extend(n_old, n_new, seed):
    """k-NN and ELL ids exact, weights and lambdas within 1e-9, the same
    search ids."""
    old = _corpus(n_old, seed=seed)
    new = _corpus(n_new, seed=seed + 1)
    ta, tg = pt.ArrowSpaceBuilder.extend(*_build(old), new)
    ja, jg = jx.ArrowSpaceBuilder.extend(*jx.ArrowSpaceBuilder.build(GP, old),
                                         new)
    np.testing.assert_array_equal(ta._knn_idx.numpy(), np.asarray(ja._knn_idx))
    np.testing.assert_allclose(ta._knn_dist.numpy(), np.asarray(ja._knn_dist),
                               rtol=0, atol=1e-9)
    np.testing.assert_array_equal(tg.neighbor_indices.numpy(),
                                  np.asarray(jg.neighbor_indices))
    np.testing.assert_allclose(tg.neighbor_weights.numpy(),
                               np.asarray(jg.neighbor_weights), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(ta.lambdas(), ja.lambdas(), rtol=0, atol=1e-9)
    q = np.concatenate([old[:3], new[:3]]) * 1.01
    ti, _ = ta.search_batch(q, tg, 0.62)
    ji, _ = ja.search_batch(q, jg, 0.62)
    np.testing.assert_array_equal(ti, np.asarray(ji))
