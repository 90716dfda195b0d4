"""symmetrize_to_ell and union_width_bound: the PyTorch port against the
JAX package on the same directed k-NN graph.  The ELL arrays must be
identical: row order highest weight first, ties by column, an edge dropped
at the cap dropped from both endpoint rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyarrowspace_tpu.ops.distance import (kernel_weights as jax_weights,
                                           knn_graph_candidates_chunked)
from pyarrowspace_tpu.ops.symmetrize import symmetrize_to_ell as jax_sym
from pyarrowspace_tpu.ops.symmetrize import union_width_bound as jax_bound
from pyarrowspace_tpu_torch.ops.distance import kernel_weights
from pyarrowspace_tpu_torch.ops.symmetrize import (symmetrize_to_ell,
                                                   union_width_bound)


def _knn_graph(seed, n, f, k, eps, hub=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    if hub:   # a few rows near the mean become everyone's neighbour
        x[:3] = x.mean(axis=0) + 1e-3 * rng.normal(size=(3, f))
        x += 0.8
    xu = x / np.linalg.norm(x, axis=1, keepdims=True)
    d, i = knn_graph_candidates_chunked(jnp.asarray(xu), k, eps)
    w = jax_weights(d, 0.4, 2.0)
    w = jnp.where(i >= 0, w, 0.0)
    return np.array(i), np.array(w)


def _assert_same(i, w, width):
    ref = jax_sym(jnp.asarray(i), jnp.asarray(w), width)
    got = symmetrize_to_ell(torch.from_numpy(i), torch.from_numpy(w), width)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]),
                               rtol=1e-14)
    assert got[3] == int(ref[3])
    return got


@pytest.mark.parametrize("seed,n,k,eps", [(0, 150, 6, 0.9), (1, 400, 10, 1.0),
                                          (2, 90, 8, 0.6)])
def test_default_width_matches_reference(seed, n, k, eps):
    i, w = _knn_graph(seed, n, 12, k, eps)
    nbr_idx, nbr_w, _, dropped = _assert_same(i, w, 2 * k)
    # Exactly symmetric: every stored (r, c, w) has its (c, r, w) partner.
    dense = np.zeros((n, n))
    rows = np.repeat(np.arange(n), 2 * k)
    keep = nbr_idx.numpy().reshape(-1) >= 0
    dense[rows[keep], nbr_idx.numpy().reshape(-1)[keep]] = \
        nbr_w.numpy().reshape(-1)[keep]
    np.testing.assert_array_equal(dense, dense.T)


@pytest.mark.parametrize("width", [3, 6])
def test_explicit_cap_drops_edges_like_reference(width):
    i, w = _knn_graph(4, 300, 10, 8, 1.2, hub=True)
    _, _, _, dropped = _assert_same(i, w, width)
    assert dropped > 0


def test_union_width_bound_matches_reference():
    for hub in (False, True):
        i, _ = _knn_graph(5, 250, 10, 7, 1.1, hub=hub)
        assert union_width_bound(torch.from_numpy(i)) == int(
            jax_bound(jnp.asarray(i)))


def test_kernel_weights_match_reference():
    d = np.random.default_rng(6).uniform(0, 1.2, size=(40, 5))
    got = kernel_weights(torch.from_numpy(d), 0.535, 2.0).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_weights(jnp.asarray(d),
                                                           0.535, 2.0)),
                               rtol=1e-14)
