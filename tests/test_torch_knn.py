"""K1, the exact eps/k-NN scan: the PyTorch port's plain version (what a
CPU tensor runs) against the JAX package's Pallas kernel in interpret mode
(float32) and its XLA path (float64).  Inputs are made with numpy from a
seed and handed to both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyarrowspace_tpu.ops.distance import knn_graph_candidates_chunked
from pyarrowspace_tpu.ops.pallas.knn import knn_graph_candidates_pallas
from pyarrowspace_tpu_torch.ops.cuda import knn
from pyarrowspace_tpu_torch.ops.distance import (knn_graph_candidates,
                                                 unit_normalize)


def _unit(rng, n, f, dtype):
    x = rng.normal(size=(n, f))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(dtype)


def _tied_unit(rng, n, f):
    """Rows with four entries of +-0.5: unit norm, dot products exact in
    any summation order, so exact distance ties are everywhere."""
    x = np.zeros((n, f))
    for r in range(n):
        x[r, rng.choice(f, size=4, replace=False)] = rng.choice([-.5, .5], 4)
    return x


def _neighbour_sets(i):
    return [set(row[row >= 0].tolist()) for row in np.asarray(i)]


def assert_same_up_to_boundary_ties(d_a, i_a, d_b, i_b):
    """Equal sorted values; equal id sets among the entries strictly before
    the last value of each row; the same number of entries at that value."""
    d_a, i_a, d_b, i_b = map(np.asarray, (d_a, i_a, d_b, i_b))
    np.testing.assert_array_equal(d_a, d_b)
    for da, ia, ib in zip(d_a, i_a, i_b):
        inner = da < da[-1]
        assert set(ia[inner].tolist()) == set(ib[inner].tolist())


def test_plain_matches_pallas_interpret_f32_multi_block():
    """N=300, F=32, k=7, eps 0.9 on a 3x3 (row block x column tile) grid,
    as tests/test_graph.py drives the Pallas kernel: equal neighbour sets,
    distances within 1e-6 (the two matmuls sum in different orders)."""
    xu = _unit(np.random.default_rng(31), 300, 32, np.float32)
    d_ref, i_ref = knn_graph_candidates_pallas(
        jnp.asarray(xu), 7, 0.9, block_rows=128, col_tile=128,
        interpret=True)
    d, i = knn_graph_candidates(torch.from_numpy(xu), 7, 0.9)
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), atol=1e-6)
    assert _neighbour_sets(i.numpy()) == _neighbour_sets(i_ref)


@pytest.mark.parametrize("n,f,k,eps", [(500, 24, 9, 0.85), (64, 8, 5, 0.5),
                                       (200, 40, 25, 1.31)])
def test_plain_matches_xla_f64_exact_ids(n, f, k, eps):
    xu = _unit(np.random.default_rng(n), n, f, np.float64)
    d_ref, i_ref = knn_graph_candidates_chunked(jnp.asarray(xu), k, eps)
    d, i = knn_graph_candidates(torch.from_numpy(xu), k, eps)
    assert d.dtype == torch.float64
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("k,eps", [(5, 0.8), (20, 1.0)])
def test_tie_rule_on_exact_ties(k, eps):
    """Exact distance ties at every rank: ascending (distance, id) order —
    the same ids in the same order as the reference's XLA path.  Against
    the Pallas kernel the distances are equal and the sets agree except
    inside the tie on the kth boundary: its merge inserts an entry before
    the equal ones already held, so an earlier-seen tied entry is evicted
    first (knn.py:_lazy_merge_min, pos = #(rd < m)), while K1 keeps the
    smallest ids, as the XLA path does."""
    x = _tied_unit(np.random.default_rng(3), 300, 16)
    d_ref, i_ref = knn_graph_candidates_chunked(jnp.asarray(x), k, eps)
    d, i = knn_graph_candidates(torch.from_numpy(x), k, eps)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))
    x32 = x.astype(np.float32)
    d_p, i_p = knn_graph_candidates_pallas(jnp.asarray(x32), k, eps,
                                           block_rows=128, col_tile=128,
                                           interpret=True)
    d32, i32 = knn_graph_candidates(torch.from_numpy(x32), k, eps)
    assert_same_up_to_boundary_ties(d32.numpy(), i32.numpy(), d_p, i_p)


def test_k_above_n_minus_one_pads():
    xu = _unit(np.random.default_rng(5), 5, 6, np.float64)
    d_ref, i_ref = knn_graph_candidates_chunked(jnp.asarray(xu), 7, 2.0)
    d, i = knn_graph_candidates(torch.from_numpy(xu), 7, 2.0)
    assert d.shape == (5, 7)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), atol=1e-12)
    assert (i.numpy()[:, 4:] == -1).all() and (d.numpy()[:, 4:] == 2.0).all()


def test_single_item_has_no_neighbours():
    d, i = knn_graph_candidates(torch.ones((1, 3), dtype=torch.float64), 4,
                                0.5)
    assert (i.numpy() == -1).all() and (d.numpy() == 2.0).all()


def test_cpu_wrapper_runs_plain_version_without_launching():
    xu = torch.from_numpy(_unit(np.random.default_rng(9), 120, 10,
                                np.float32))
    before = knn.LAUNCHES
    d, i = knn.knn_scan(xu, 6, 0.9, row_start=30, row_count=50)
    dp, ip = knn.knn_plain(xu, 6, 0.9, rows=slice(30, 80))
    assert knn.LAUNCHES == before
    assert torch.equal(d, dp) and torch.equal(i, ip)
    d_all, i_all = knn.knn_scan(xu, 6, 0.9)
    assert torch.equal(d, d_all[30:80]) and torch.equal(i, i_all[30:80])
    with pytest.raises(ValueError):
        knn.knn_scan(xu, 6, 0.9, row_start=100, row_count=50)


def test_unit_normalize_matches_reference():
    from pyarrowspace_tpu.ops.distance import unit_normalize as jax_unit
    x = np.random.default_rng(4).normal(size=(20, 7))
    x[3] = 0.0
    got = unit_normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_unit(jnp.asarray(x))),
                               atol=1e-15)
    assert (got[3] == 0).all()
