"""The whole slice — build, then single and batched exact search — of the
PyTorch port on CPU in float64, against the JAX package on the same numpy
inputs: the Laplacian to 1e-9, lambdas and query lambdas to 1e-9 relative,
top-k ids exact.  Also the reference's own parity data (tests/test_0 and
the README quickstart), serving from state carried over from a JAX-built
index, the API's error paths, and that the port never imports jax."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import pyarrowspace_tpu as jx
import pyarrowspace_tpu_torch as pt
from data_test0 import EXPECTED_ORDERINGS, GRAPH_PARAMS_TEST0, ITEMS_5X24
from pyarrowspace_tpu_torch.io import state_from_numpy

README_ITEMS = np.array([[0.1, 0.2, 0.3], [0.0, 0.5, 0.1], [0.9, 0.1, 0.0]])
README_GP = {"eps": 1.0, "k": 6, "topk": 3, "p": 2.0, "sigma": 1.0}
README_EXPECTED = [(0, 0.989743318610787), (1, 0.7565344158360029),
                   (2, 0.22151940739207396)]


def _both(gp, items):
    return (jx.ArrowSpaceBuilder.build(gp, items),
            pt.ArrowSpaceBuilder.build(gp, items, device="cpu"))


def _reference_build(gp, items, col_tile):
    """The JAX package's static build with a narrower k-NN column tile (a
    tiling choice: the same exact neighbours, a faster CPU scan)."""
    from pyarrowspace_tpu.graph.build import BuildConfig
    return (jx.ArrowSpaceBuilder.new()
            .with_lambda_graph(gp["eps"], gp["k"], gp["topk"], gp["p"],
                               gp["sigma"])
            .with_dims_reduction(True, gp["eps"]).with_seed(42)
            .with_build_config(BuildConfig(col_tile=col_tile))
            .build_rows(items))


def _assert_hits(got, ref, tol=1e-9):
    assert [h[0] for h in got] == [h[0] for h in ref]
    np.testing.assert_allclose([h[1] for h in got], [h[1] for h in ref],
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_golden_pipeline_seeds_match_reference(seed):
    """The tests/test_golden_pipeline.py cases."""
    rng = np.random.default_rng(seed)
    items = rng.normal(size=(60, 10)) + 0.3
    gp = {"eps": 0.8, "k": 5, "topk": 6, "p": 2.0, "sigma": 0.3}
    query = items[seed + 3] * 1.04
    (ja, jg), (ta, tg) = _both(gp, items)
    assert ta._data.dtype == torch.float64
    np.testing.assert_allclose(tg.to_dense(), jg.to_dense(), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(ta.lambdas(), ja.lambdas(), rtol=1e-9)
    assert ta.prepare_query_item(query, tg) == pytest.approx(
        ja.prepare_query_item(query, jg), rel=1e-9)
    _assert_hits(ta.search(query, tg, 0.7), ja.search(query, jg, 0.7))


@pytest.fixture(scope="module")
def reduced_pair():
    """N=5,000 > reduction_min_n: the build takes the reduction path."""
    rng = np.random.default_rng(12)
    centers = rng.normal(size=(8, 12)) * 3.0
    items = centers[rng.integers(0, 8, 5000)] + rng.normal(size=(5000, 12))
    gp = {"eps": 0.9, "k": 10, "topk": 8, "p": 2.0, "sigma": 0.45}
    return items, (_reference_build(gp, items, col_tile=256),
                   pt.ArrowSpaceBuilder.build(gp, items, device="cpu"))


def test_reduction_build_matches_reference(reduced_pair):
    _, ((ja, jg), (ta, tg)) = reduced_pair
    assert ta._centroids is not None
    np.testing.assert_array_equal(ta._assignments.numpy(),
                                  np.asarray(ja._assignments))
    np.testing.assert_allclose(ta._centroids.numpy(),
                               np.asarray(ja._centroids), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(ta._lap_f.numpy(), np.asarray(ja._lap_f),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(tg.neighbor_indices.numpy(),
                                  np.asarray(jg.neighbor_indices))
    np.testing.assert_allclose(tg.neighbor_weights.numpy(),
                               np.asarray(jg.neighbor_weights), atol=1e-12)
    np.testing.assert_allclose(ta.lambdas(), ja.lambdas(), rtol=1e-9)
    assert ta.tau_star == pytest.approx(ja.tau_star, rel=1e-9)
    assert tg.n_dropped_edges == jg.n_dropped_edges
    assert tg.nedges == jg.nedges


def test_search_batch_exact_matches_reference_and_single(reduced_pair):
    items, ((ja, jg), (ta, tg)) = reduced_pair
    queries = items[np.random.default_rng(3).choice(5000, 40)] * 1.01
    ti, ts = ta.search_batch(queries, tg, 0.62)
    ji, js = ja.search_batch(queries, jg, 0.62)
    assert ti.dtype == np.int32 and ti.shape == (40, 8)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), rtol=1e-9, atol=1e-9)
    for r in (0, 17, 39):
        hits = ta.search(queries[r], tg, 0.62)
        assert [h[0] for h in hits] == ti[r].tolist()
        np.testing.assert_allclose([h[1] for h in hits], ts[r], atol=1e-12)


def test_state_from_numpy_serves_like_reference(reduced_pair):
    """A JAX-built index carried over array by array serves the same ids
    and scores from the port."""
    items, ((ja, jg), _) = reduced_pair
    arrays = {
        "data": ja._data, "data_unit": ja._data_unit,
        "lambdas": ja._lambdas, "e_raw": ja._e_raw, "lap_f": ja._lap_f,
        "w_f": ja._w_f, "tau_star": ja._tau_star, "knn_dist": ja._knn_dist,
        "knn_idx": ja._knn_idx, "nbr_idx": jg.neighbor_indices,
        "nbr_w": jg.neighbor_weights, "degrees": jg.degrees,
        "centroids": ja._centroids, "assignments": ja._assignments}
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    params = pt.GraphParams(**{
        f: getattr(jg.params, f) for f in ("eps", "k", "topk", "p", "sigma",
                                           "normalise", "seed")})
    ta, tg = state_from_numpy(arrays, params, "cpu")
    queries = items[:25] * 0.97 + 0.01
    ti, ts = ta.search_batch(queries, tg, 0.5)
    ji, js = ja.search_batch(queries, jg, 0.5)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), atol=1e-12)
    _assert_hits(ta.search(queries[4], tg, 0.8),
                 ja.search(queries[4], jg, 0.8), 1e-12)
    assert tg.nedges == jg.nedges
    np.testing.assert_allclose(ta.lambdas(), ja.lambdas(), rtol=0, atol=0)
    with pytest.raises(ValueError):
        state_from_numpy({"data": arrays["data"]}, params)


@pytest.mark.parametrize("tau", sorted(EXPECTED_ORDERINGS))
def test_test0_orderings(tau):
    aspace, gl = pt.ArrowSpaceBuilder.build(GRAPH_PARAMS_TEST0, ITEMS_5X24,
                                            device="cpu")
    hits = aspace.search(ITEMS_5X24[2] * 1.05, gl, tau)
    assert [h[0] for h in hits] == EXPECTED_ORDERINGS[tau]


def test_readme_quickstart_scores():
    aspace, gl = pt.ArrowSpaceBuilder.build(README_GP, README_ITEMS,
                                            device="cpu")
    assert (aspace.nitems, aspace.nfeatures, gl.nnodes, gl.shape()) == (
        3, 3, 3, (3, 3))
    _assert_hits(aspace.search(np.array([0.05, 0.2, 0.25]), gl, 1.0),
                 README_EXPECTED)
    lams = aspace.lambdas()
    assert np.all(lams > 0) and np.all(lams <= 1.0)


def test_api_error_paths():
    aspace, gl = pt.ArrowSpaceBuilder.build(README_GP, README_ITEMS,
                                            device="cpu")
    with pytest.raises(ValueError, match="cannot be constructed directly"):
        pt.ArrowSpace()
    with pytest.raises(ValueError, match="cannot be constructed directly"):
        pt.GraphLaplacian()
    with pytest.raises(ValueError, match=r"graph_params\['k'\] is required"):
        pt.ArrowSpaceBuilder.build({"eps": 1.0, "topk": 3, "p": 2.0},
                                   README_ITEMS)
    with pytest.raises(ValueError, match="non-empty 2D"):
        pt.ArrowSpaceBuilder.build(README_GP, np.zeros((0, 3)))
    with pytest.raises(ValueError, match="must match nfeatures"):
        aspace.search(np.array([0.1, 0.2]), gl, 1.0)
    with pytest.raises(AssertionError, match="lambdas are zero"):
        aspace.search(np.zeros(3), gl, 1.0)
    with pytest.raises(ValueError, match="out of range"):
        aspace.get_item(3)
    feats, lam = aspace.get_item(1)
    assert feats.dtype == np.float64 and lam == aspace.lambdas()[1]
    # Every mode of the JAX package serves.  "int8" and "ivf" serve what
    # the JAX package serves on the same index.
    query = README_ITEMS * 0.9 + 0.01
    ja, jg = jx.ArrowSpaceBuilder.build(README_GP, README_ITEMS)
    for mode in ("int8", "ivf"):
        got = aspace.search_batch(query, gl, 1.0, mode=mode)
        ref = ja.search_batch(query, jg, 1.0, mode=mode)
        np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
        np.testing.assert_allclose(got[1], np.asarray(ref[1]), rtol=0,
                                   atol=1e-6)
    # "auto" and "subtile" serve: 3 items fall below the auto threshold, so
    # auto is exact; subtile scans a bf16 copy and rescores in float32.
    # "ivf_block" and "certified" serve too: certified serving is exact.
    exact = aspace.search_batch(query, gl, 1.0)
    certified = aspace.search_batch(query, gl, 1.0, mode="certified")
    np.testing.assert_array_equal(certified[0], exact[0])
    np.testing.assert_allclose(certified[1], exact[1], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="certify"):
        aspace.search_batch(query, gl, 1.0, mode="exact", certify=True)
    auto = aspace.search_batch(query, gl, 1.0, mode="auto")
    subtile = aspace.search_batch(query, gl, 1.0, mode="subtile")
    np.testing.assert_array_equal(auto[0], exact[0])
    np.testing.assert_array_equal(auto[1], exact[1])
    np.testing.assert_array_equal(subtile[0], exact[0])
    np.testing.assert_allclose(subtile[1], exact[1], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="unknown search mode"):
        aspace.search_batch(README_ITEMS, gl, 1.0, mode="fast")
    # build_energy serves what the JAX package's serves.
    ea, eg = pt.ArrowSpaceBuilder.build_energy(README_ITEMS, device="cpu")
    ja, jg = jx.ArrowSpaceBuilder.build_energy(README_ITEMS)
    assert eg.nnodes == jg.nnodes
    np.testing.assert_allclose(ea.lambdas(), ja.lambdas(), rtol=1e-9)
    assert ([h[0] for h in ea.search_energy(query[0], eg, 3)]
            == [h[0] for h in ja.search_energy(query[0], jg, 3)])
    assert gl.graph_params == {"eps": 1.0, "k": 6, "topk": 3, "p": 2.0,
                               "sigma": 1.0}


def test_fluent_builder_matches_static_build():
    b = (pt.ArrowSpaceBuilder.new().with_lambda_graph(0.8, 5, 6, 2.0, 0.3)
         .with_dims_reduction(True, 0.8).with_seed(42))
    items = torch.from_numpy(
        np.random.default_rng(8).normal(size=(40, 9)) + 0.3)   # on the CPU
    fa, fg = b.build_rows(items)
    sa, sg = pt.ArrowSpaceBuilder.build(
        {"eps": 0.8, "k": 5, "topk": 6, "p": 2.0, "sigma": 0.3}, items)
    assert fa.device.type == "cpu"
    np.testing.assert_array_equal(fa.lambdas(), sa.lambdas())
    np.testing.assert_array_equal(fg.to_dense(), sg.to_dense())


def test_float32_input_builds_in_float32():
    items = (np.random.default_rng(9).normal(size=(50, 8)) + 0.3).astype(
        np.float32)
    aspace, gl = pt.ArrowSpaceBuilder.build(
        {"eps": 0.8, "k": 5, "topk": 4, "p": 2.0, "sigma": 0.3}, items,
        device="cpu")
    assert aspace._data.dtype == torch.float32
    assert gl.neighbor_weights.dtype == torch.float32
    idx, vals = aspace.search_batch(items[:3], gl, 0.9)
    assert vals.dtype == np.float32 and idx[:, 0].tolist() == [0, 1, 2]


def test_package_imports_no_jax():
    code = ("import sys, pyarrowspace_tpu_torch, pyarrowspace_tpu_torch.io; "
            "from pyarrowspace_tpu_torch.ops.cuda import knn, scan_topk, "
            "scan_int8; import pyarrowspace_tpu_torch.energy; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'pyarrowspace_tpu.'))] "
            "+ [m for m in sys.modules if m == 'pyarrowspace_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
