"""The energy index and its routed search on the CPU, held to the
benchmark's plain float64 reference (perfbench/reference/energy.py, which
imports neither package): the energy build (nodes, lambdas, raw energies,
tau*, the feature Laplacian and the node graph); search_energy_batch on
the routed path and on the exact path, including the fall-back, decided on
the device, of a whole batch to the exact scan when one query's pool is
short of k; the routing bitmap's pool against the pool of the candidate
gather it replaced, item for item; ties to the smaller id; and the spans of
the energy searches, in tests/test_torch_spans.py's style."""

import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pyarrowspace_tpu_torch as pt
from pyarrowspace_tpu_torch.ops import search as search_ops
from pyarrowspace_tpu_torch.ops.cuda import scan_energy
from pyarrowspace_tpu_torch.ops.ivf import build_ivf

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "perfbench"))
from reference import energy as ref_energy  # noqa: E402
from reference.serve import topk as ref_topk  # noqa: E402

GP = {"eps": 1.31, "k": 25, "topk": 15, "p": 2.0, "sigma": 0.535}
N, F = 4096, 384
W_L, W_D = 1.0, 0.5


def _ep(tokens, candidate_m=32):
    return {"optical_tokens": tokens, "trim_quantile": 0.1, "eta": 0.05,
            "steps": 4, "split_quantile": 0.9, "neighbor_k": 8,
            "split_tau": 0.15, "w_lambda": 1.0, "w_disp": 0.5,
            "w_dirichlet": 0.25, "candidate_m": candidate_m}


def _items(seed=0):
    return np.random.default_rng(seed).normal(size=(N, F)) * 12.0


def _queries(items, q=40, seed=1):
    rng = np.random.default_rng(seed)
    return items[rng.choice(N, q)] + 3.0 * rng.normal(size=(q, F))


@pytest.fixture(scope="module", params=[(8, 4), (40, 32)])
def built(request):
    """(items, port space, port graph, reference state, energy params) at
    optical_tokens 8 (candidate_m 4) and 40 (32, the CVE deployment's),
    float64 on the CPU."""
    items = _items()
    ep = _ep(*request.param)
    aspace, gl = pt.ArrowSpaceBuilder.build_energy(items, ep, GP,
                                                   device="cpu")
    ref, _ = ref_energy.build(torch.from_numpy(items), GP, ep,
                              torch.float64)
    return items, aspace, gl, ref, ep


def _close(a, b, tol=1e-9):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=tol)


def _ref_answers(ref, queries, k, probe, exact=False):
    """The reference's routed (or, ``exact``, full) energy top-k."""
    lam_q, e_q, ql = ref_energy.query_terms(torch.from_numpy(queries), ref)
    full = ref_energy.scores(torch.from_numpy(_items()), ref, lam_q, e_q, ql,
                             W_L, W_D)
    if exact:
        pool = torch.ones_like(full, dtype=torch.bool)
    else:
        order = torch.sort(ref_energy.node_distances(lam_q, e_q, ql, ref,
                                                     W_L, W_D),
                           dim=1, stable=True).indices
        keys = ref_energy.route_keys(ref["assignments"], ref["n_centroids"])
        pool = ref_energy.pools(order, ref["node_centroid"],
                                ref["n_centroids"], probe)[:, keys]
    v, i = ref_topk(torch.where(pool, full, -torch.inf), k)
    return i.numpy(), v.numpy(), pool


def test_energy_build_matches_reference(built):
    _, aspace, gl, ref, ep = built
    em = aspace._energy_maps
    assert em.nodes.dtype == torch.float64
    assert em.nodes.shape == ref["nodes"].shape
    np.testing.assert_array_equal(em.node_centroid.numpy(),
                                  ref["node_centroid"].numpy())
    np.testing.assert_array_equal(aspace._assignments.numpy(),
                                  ref["assignments"].numpy())
    _close(em.nodes, ref["nodes"])
    _close(em.node_lambda, ref["node_lambda"])
    _close(em.node_dirichlet, ref["node_e"])
    _close(em.node_disp, ref["node_disp"])
    _close(aspace._lap_f, ref["lap_f"])
    _close(aspace.lambdas(), ref["lambdas"])
    _close(aspace._e_raw, ref["e"], 1e-6)
    assert float(aspace._tau_star) == pytest.approx(float(ref["tau_star"]),
                                                    rel=1e-12)
    assert gl._n_dropped == 0
    _close(gl.to_dense(), ref_energy.energy_graph(ref, ep))


def test_routed_search_matches_reference(built):
    items, aspace, gl, ref, ep = built
    queries = _queries(items)
    i, s = aspace.search_energy_batch(queries, gl, 20, W_L, W_D)
    i_ref, s_ref, pool = _ref_answers(ref, queries, 20, ep["candidate_m"])
    assert not bool(pool.all())                     # a routed pool
    np.testing.assert_array_equal(i, i_ref)
    _close(s, s_ref)
    got = aspace.search_energy(queries[3], gl, 20, W_L, W_D)
    assert [h[0] for h in got] == i_ref[3].tolist()


def test_short_pool_sends_the_whole_batch_to_the_exact_scan():
    """candidate_m 1: each pool is one centroid's bucket and the tail; with
    k between the smallest and the largest pool, some pool is short, and
    every query of the batch is answered by the exact scan, decided on the
    device."""
    items = _items()
    ep = _ep(8, candidate_m=1)
    aspace, gl = pt.ArrowSpaceBuilder.build_energy(items, ep, GP,
                                                   device="cpu")
    ref, _ = ref_energy.build(torch.from_numpy(items), GP, ep, torch.float64)
    queries = _queries(items)
    _, _, pool = _ref_answers(ref, queries, 1, 1)
    sizes = pool.sum(dim=1)
    k = int(sizes.min()) + 1
    assert k <= int(sizes.max())
    i, s = aspace.search_energy_batch(queries, gl, k, W_L, W_D)
    i_ref, s_ref, _ = _ref_answers(ref, queries, k, 1, exact=True)
    np.testing.assert_array_equal(i, i_ref)
    _close(s, s_ref)
    i_routed, _, _ = _ref_answers(ref, queries[sizes.numpy() >= k], k, 1)
    assert not np.array_equal(i[sizes.numpy() >= k], i_routed)
    routed = aspace._search_energy_routed(
        torch.from_numpy(queries), *aspace._energy_query(
            torch.from_numpy(queries)), W_L, W_D, k)
    assert bool((routed[0] < 0).any())              # no fall-back there


def test_bitmap_pool_is_the_gather_pool(built):
    """Each query's admitted items (its bitmap over the route keys) are
    exactly the old candidate gather's pool: the bucket members of the
    de-duplicated centroids of its candidate_m nodes, then the tail."""
    items, aspace, gl, _, ep = built
    q = torch.from_numpy(_queries(items))
    lam_q, e_q, ql = aspace._energy_terms(q)
    keys, bitmap, pool = aspace._energy_route(ql, lam_q, e_q, W_L, W_D)
    admitted = scan_energy.admitted(keys, bitmap)
    em = aspace._energy_maps
    ivf = build_ivf(aspace._centroids, aspace._assignments, N,
                    capacity_factor=2.0)
    d = ref_energy.node_distances(lam_q, e_q, ql, dict(
        nodes=em.nodes, node_lambda=em.node_lambda, node_e=em.node_dirichlet,
        tau_star=aspace._tau_star), W_L, W_D)
    sel = torch.sort(d, dim=1, stable=True).indices[:, :ep["candidate_m"]]
    for r in range(q.shape[0]):
        cents = []
        for c in em.node_centroid[sel[r]].tolist():
            if c not in cents:
                cents.append(c)
        gather = torch.cat([ivf.buckets[cents].reshape(-1), ivf.tail])
        gather = gather[gather >= 0]
        assert gather.unique().numel() == gather.numel()
        assert set(gather.tolist()) == set(
            torch.nonzero(admitted[r]).reshape(-1).tolist())
        assert int(pool[r]) == gather.numel()


def test_ties_go_to_the_smaller_id():
    """Duplicated rows score alike: the lower id is listed first, routed
    and exact (the candidate gather's stable sort listed them by pool
    position)."""
    rng = np.random.default_rng(3)
    half = rng.normal(size=(N // 2, F)) * 12.0
    items = np.concatenate([half, half])
    aspace, gl = pt.ArrowSpaceBuilder.build_energy(items, _ep(8), GP,
                                                   device="cpu")
    queries = half[:12] + 3.0 * rng.normal(size=(12, F))
    for k in (20, N):
        i, s = aspace.search_energy_batch(queries, gl, k)
        tied = s[:, 1:] == s[:, :-1]
        assert tied.any() and np.all(np.diff(i, axis=1)[tied] > 0)


def test_energy_scan_plain_mask_and_empty_slots():
    """energy_scan on the CPU: an item outside the bitmap never enters, a
    list short of admitted items ends in (-1, -inf), and an all-ones
    bitmap is the exact scan."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((50, 6), generator=g, dtype=torch.float64)
    lap = torch.eye(6, dtype=torch.float64) * 2 - 0.3
    e = torch.sum((x @ lap) * x, dim=1)
    ql = torch.randn((3, 6), generator=g, dtype=torch.float64)
    lam, lam_q = torch.rand(50, generator=g), torch.rand(3, generator=g)
    lam, lam_q = lam.double(), lam_q.double()
    e_q = torch.rand(3, generator=g).double()
    ts = torch.tensor(1.0, dtype=torch.float64)
    keys = torch.arange(50, dtype=torch.int32) % 5
    bitmap = torch.tensor([[0b00001], [0b10010], [0b11111]],
                          dtype=torch.uint8)
    i, v = scan_energy.energy_scan(x, lam, e, ql, lam_q, e_q, ts, W_L, W_D,
                                   15, keys, bitmap)
    assert set(i[0, :10].tolist()) == set(range(0, 50, 5))
    assert i[0, 10:].tolist() == [-1] * 5
    assert np.all(np.isneginf(v[0, 10:].numpy()))
    assert all(int(j) % 5 in (1, 4) for j in i[1])
    exact = scan_energy.energy_scan(x, lam, e, ql, lam_q, e_q, ts, W_L, W_D,
                                    15)
    assert torch.equal(i[2], exact[0][2]) and torch.equal(v[2], exact[1][2])


def test_device_fallback_reads_nothing_back():
    """exact_where_short keeps the bitmaps, or turns every one to all
    ones, from tensors alone."""
    bm = torch.tensor([[1, 2], [3, 4]], dtype=torch.uint8)
    same = search_ops.exact_where_short(bm, torch.tensor([5, 9]), 5)
    ones = search_ops.exact_where_short(bm, torch.tensor([5, 4]), 5)
    assert torch.equal(same, bm) and bool((ones == 255).all())


# -- spans ---------------------------------------------------------------
def _ranges(prof, prefix="arrowspace:"):
    out = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.name.startswith(prefix)]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def _one_search_range(prof, stages):
    ranges = _ranges(prof)
    roots = [r for r in ranges if r[0] == "arrowspace:search"]
    assert len(roots) == 1
    kids = [r for r in ranges if r[0].startswith("arrowspace:search.")]
    assert [r[0] for r in kids] == [f"arrowspace:search.{s}"
                                    for s in stages]
    assert all(roots[0][1] <= k[1] and k[2] <= roots[0][2] for k in kids)
    assert all(a[2] <= b[1] for a, b in zip(kids, kids[1:]))


@pytest.mark.parametrize("batch", [True, False])
def test_energy_searches_are_one_range_with_their_stages(built, batch):
    items, aspace, gl, _, _ = built
    queries = _queries(items, q=8)
    run = ((lambda: aspace.search_energy_batch(queries, gl, 20)) if batch
           else (lambda: aspace.search_energy(queries[0], gl, 20)))
    run()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    _one_search_range(prof, ["query_lambda", "route", "scan", "to_host"])


def test_energy_search_without_maps_has_no_route():
    items = _items()[:600]
    aspace, gl = pt.ArrowSpaceBuilder.build(GP, items, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        aspace.search_energy_batch(items[:4], gl, 5)
    _one_search_range(prof, ["query_lambda", "scan", "to_host"])
