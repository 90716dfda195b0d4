"""The energy-only pipeline of the PyTorch port — ArrowSpaceBuilder.
build_energy (energy/maps.py), the energy searches of core/space.py
(routed through the energy maps, and the exact fallback) and the energy
ranking functions of ops/search.py — against the JAX package on the same
numpy inputs, in float64: the energy nodes, lambdas, raw energies, tau*
and the energy graph's dense Laplacian to 1e-9, served ids exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyarrowspace_tpu as jx
import pyarrowspace_tpu_torch as pt
from pyarrowspace_tpu.ops import search as jsearch
from pyarrowspace_tpu_torch.io import state_from_numpy
from pyarrowspace_tpu_torch.ops import search as tsearch

GP = {"eps": 0.9, "k": 6, "topk": 6, "p": 2.0, "sigma": 0.4}
EP = {"optical_tokens": 12, "candidate_m": 8}


@pytest.fixture(scope="module")
def energy_pair():
    rng = np.random.default_rng(5)
    centers = rng.normal(size=(10, 14)) * 2.0
    items = centers[rng.integers(0, 10, 500)] + 0.6 * rng.normal(
        size=(500, 14))
    return (items, jx.ArrowSpaceBuilder.build_energy(items, EP, GP),
            pt.ArrowSpaceBuilder.build_energy(items, EP, GP, device="cpu"))


def _close(a, b, tol=1e-9):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=tol)


def test_build_energy_matches_reference(energy_pair):
    _, (ja, jg), (ta, tg) = energy_pair
    te, je = ta._energy_maps, ja._energy_maps
    assert te.nodes.dtype == torch.float64
    assert te.nodes.shape == je.nodes.shape and te.candidate_m == 8
    np.testing.assert_array_equal(te.node_centroid.numpy(),
                                  np.asarray(je.node_centroid))
    np.testing.assert_array_equal(ta._assignments.numpy(),
                                  np.asarray(ja._assignments))
    _close(ta._centroids, ja._centroids)
    for name in ("nodes", "node_lambda", "node_disp", "node_dirichlet"):
        _close(getattr(te, name), getattr(je, name))
    _close(ta.lambdas(), ja.lambdas())
    _close(ta._e_raw, ja._e_raw)
    _close(ta._lap_f, ja._lap_f)
    assert ta.tau_star == pytest.approx(ja.tau_star, abs=1e-9)
    assert tg.nnodes == jg.nnodes and tg.nedges == jg.nedges
    _close(tg.to_dense(), jg.to_dense())
    assert set(pt.get_phase_timings()) >= {
        "energy_compress", "energy_diffuse", "energy_split",
        "energy_features", "energy_graph"}


@pytest.mark.parametrize("k,w", [(5, (None, None)), (10, (0.7, 1.3))])
def test_search_energy_routed_matches_reference(energy_pair, k, w):
    items, (ja, jg), (ta, tg) = energy_pair
    for q in (items[3] * 1.02, items[250] + 0.1):
        qt = torch.from_numpy(q[None])
        routed = ta._search_energy_routed(qt, *ta._energy_query(qt), 1.0,
                                          0.5, k)
        assert bool((routed[0] >= 0).all())            # the routed branch
        got = ta.search_energy(q, tg, k, *w)
        ref = ja.search_energy(q, jg, k, *w)
        assert [h[0] for h in got] == [h[0] for h in ref]
        _close([h[1] for h in got], [h[1] for h in ref])


def test_search_energy_fallback_matches_reference(energy_pair):
    """k past the routed pool: the exact energy scan serves."""
    items, (ja, jg), (ta, tg) = energy_pair
    q = items[7] * 0.98
    routed = ta._search_energy_routed(
        torch.from_numpy(q[None]), *ta._energy_query(torch.from_numpy(
            q[None])), 1.0, 0.5, 500)
    assert bool((routed[0] < 0).any())                 # the pool is short
    got, ref = ta.search_energy(q, tg, 500), ja.search_energy(q, jg, 500)
    assert [h[0] for h in got] == [h[0] for h in ref]
    _close([h[1] for h in got], [h[1] for h in ref])


@pytest.mark.parametrize("k", [5, 499])
def test_search_energy_batch_matches_reference(energy_pair, k):
    items, (ja, jg), (ta, tg) = energy_pair
    queries = items[np.random.default_rng(2).choice(500, 12)] * 1.01
    i, s = ta.search_energy_batch(queries, tg, k)
    i_ref, s_ref = ja.search_energy_batch(queries, jg, k)
    assert i.dtype == np.int32
    np.testing.assert_array_equal(i, np.asarray(i_ref))
    _close(s, s_ref)


def test_energy_state_carried_over_serves_like_reference(energy_pair):
    """A JAX-built energy index carried into the port array by array,
    energy maps and raw energies included, serves the same ids."""
    items, (ja, jg), _ = energy_pair
    arrays = {key: np.asarray(getattr(ja, "_" + key)) for key in (
        "data", "data_unit", "lambdas", "e_raw", "lap_f", "w_f", "tau_star",
        "centroids", "assignments")}
    arrays.update(nbr_idx=np.asarray(jg.neighbor_indices),
                  nbr_w=np.asarray(jg.neighbor_weights),
                  degrees=np.asarray(jg.degrees), e_un=arrays["e_raw"])
    je = ja._energy_maps
    emaps = {key: getattr(je, key) for key in (
        "nodes", "node_lambda", "node_disp", "node_dirichlet",
        "node_centroid", "candidate_m")}
    params = pt.GraphParams(**{f: getattr(jg.params, f) for f in (
        "eps", "k", "topk", "p", "sigma", "normalise", "seed")})
    ta, tg = state_from_numpy(arrays, params, "cpu", energy_maps=emaps)
    queries = items[:9] * 1.03
    i, s = ta.search_energy_batch(queries, tg, 6)
    i_ref, s_ref = ja.search_energy_batch(queries, jg, 6)
    np.testing.assert_array_equal(i, np.asarray(i_ref))
    _close(s, s_ref, 1e-12)


def test_energy_ranking_functions_match_reference():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(80, 6))
    a = rng.normal(size=(6, 6))
    lap = a @ a.T
    e = np.einsum("nf,fg,ng->n", x, lap, x)
    lam = rng.uniform(0, 1, 80)
    q = rng.normal(size=(4, 6))
    lam_q = rng.uniform(0, 1, 4)
    e_q = np.einsum("nf,fg,ng->n", q, lap, q)
    ts = np.float64(0.7)
    t = [torch.from_numpy(v) for v in (x, lam, e, lap, q, lam_q, e_q)]
    i, s = tsearch.energy_topk_batch(*t, torch.tensor(ts), 1.0, 0.5, 9)
    i_ref, s_ref = jsearch.energy_topk_batch(
        *map(jnp.asarray, (x, lam, e, lap, q, lam_q, e_q)), jnp.asarray(ts),
        jnp.asarray(1.0), jnp.asarray(0.5), 9)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    _close(s, s_ref, 1e-12)
    i1, s1 = tsearch.energy_topk(t[0], t[1], t[2], t[3], t[4][2], t[5][2],
                                 t[6][2], torch.tensor(ts), 1.0, 0.5, 9)
    np.testing.assert_array_equal(i1.numpy(), i[2].numpy())
    _close(s1, s[2], 1e-12)
    _close(tsearch.bounded_energy(t[2], torch.tensor(ts)),
           jsearch.bounded_energy(jnp.asarray(e), jnp.asarray(ts)), 1e-15)


@pytest.mark.parametrize("normalized", [False, True])
def test_search_energy_on_a_standard_build(normalized):
    """No energy maps: the exact energy scan serves, over the RAW energies
    (_energies_raw computes them once when the build stored normalized
    Rayleigh quotients)."""
    from pyarrowspace_tpu.graph.build import BuildConfig as JConfig
    rng = np.random.default_rng(8)
    items = rng.normal(size=(200, 10)) + 0.3
    b = [(pkg.ArrowSpaceBuilder.new().with_lambda_graph(0.9, 6, 6, 2.0, 0.4)
          .with_build_config(cfg(rayleigh_normalized=normalized)))
         for pkg, cfg in ((jx, JConfig), (pt, pt.BuildConfig))]
    ja, jg = b[0].build_rows(items)
    ta, tg = b[1].build_rows(torch.from_numpy(items))
    assert ta._energy_maps is None and ta._rayleigh_normalized == normalized
    queries = items[:6] * 1.02
    i, s = ta.search_energy_batch(queries, tg, 7, 0.8, 1.2)
    i_ref, s_ref = ja.search_energy_batch(queries, jg, 7, 0.8, 1.2)
    np.testing.assert_array_equal(i, np.asarray(i_ref))
    _close(s, s_ref)
    got = ta.search_energy(queries[2], tg, 7)
    assert [h[0] for h in got] == [
        h[0] for h in ja.search_energy(queries[2], jg, 7)]
    _close(ta._energies_raw(), ja._energies_raw())
