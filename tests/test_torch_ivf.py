"""Blocked-IVF and certified serving of the PyTorch port (utils/prng.py,
the serving clustering of reduction/pipeline.py, ops/ivf.py,
ops/ivf_scan.py with the plain version of kernel K6, serving.py and
core/space.py) against the JAX package on the same numpy inputs; the JAX
package runs its Pallas scan in interpret mode on the CPU by itself.

Tolerances: the PRNG stream is bitwise equal; clusterings on float64 data
are equal, on float32 data centroids agree within 1e-6 with equal
assignments (matmuls sum in other orders); slab ids and probe tables are
equal; float32 statistics and scan scores agree within 1e-6; served ids and
certificates are equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyarrowspace_tpu as jx
import pyarrowspace_tpu.ops.pallas.ivf_scan as jis
import pyarrowspace_tpu_torch as pt
from pyarrowspace_tpu.reduction import pipeline as jp
from pyarrowspace_tpu.serving import CertifiedStream as RefStream
from pyarrowspace_tpu_torch.io import state_from_numpy
from pyarrowspace_tpu_torch.ops import ivf_scan as tis
from pyarrowspace_tpu_torch.ops.cuda import ivf_scan as k6
from pyarrowspace_tpu_torch.ops.cuda.compare import topk_disagreements
from pyarrowspace_tpu_torch.reduction import pipeline as tp
from pyarrowspace_tpu_torch.serving import CertifiedStream
from pyarrowspace_tpu_torch.utils import prng

TOL = 1e-6
TAU = 0.62
GP = {"eps": 0.9, "k": 6, "topk": 10, "p": 2.0, "sigma": 0.3}


def _carry(ja, jg):
    """The port's (ArrowSpace, GraphLaplacian) from a JAX-built index."""
    arrays = {
        "data": ja._data, "data_unit": ja._data_unit,
        "lambdas": ja._lambdas, "e_raw": ja._e_raw, "lap_f": ja._lap_f,
        "w_f": ja._w_f, "tau_star": ja._tau_star, "knn_dist": ja._knn_dist,
        "knn_idx": ja._knn_idx, "nbr_idx": jg.neighbor_indices,
        "nbr_w": jg.neighbor_weights, "degrees": jg.degrees,
        "centroids": ja._centroids, "assignments": ja._assignments}
    arrays = {k: None if v is None else np.asarray(v)
              for k, v in arrays.items()}
    params = pt.GraphParams(**{
        f: getattr(jg.params, f) for f in ("eps", "k", "topk", "p", "sigma",
                                           "normalise", "seed")})
    return state_from_numpy(arrays, params, "cpu")


@pytest.fixture(scope="module")
def served():
    """The 40-component mixture of tests/test_ivf.py, built by the JAX
    package, carried into the port, both clustered by enable_ivf."""
    rng = np.random.default_rng(77)
    base = rng.normal(size=(40, 32))
    items = np.repeat(base, 50, axis=0) + 0.15 * rng.normal(size=(2000, 32))
    ja, jg = jx.ArrowSpaceBuilder.build(GP, items)
    ta, tg = _carry(ja, jg)
    ja.enable_ivf(n_clusters=40)
    ta.enable_ivf(n_clusters=40)
    return ja, jg, ta, tg, items


def _mixed_queries(items, seed, n_in=8, n_rand=8, n_neg=3):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        items[rng.choice(len(items), n_in, replace=False)] * 1.02,
        rng.normal(size=(n_rand, items.shape[1])),
        -items[rng.choice(len(items), n_neg, replace=False)]])


def _planted_mixture(seed=5, k_mix=24, n=3000, f=64, noise=0.35):
    """tests/test_ivf.py::_planted_mixture, in numpy."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k_mix, f))
    assign = rng.integers(0, k_mix, size=n)
    x = centers[assign] + noise * rng.normal(size=(n, f))
    xu = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    return xu, rng


# -- the PRNG ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 42, 123457, 2 ** 31 - 1])
def test_prng_matches_jax_bitwise(seed):
    key = jax.random.PRNGKey(seed)
    assert tuple(np.asarray(key).tolist()) == prng.prng_key(seed)
    for it in (0, 1, 9, 11, 4099):
        jk = jax.random.fold_in(key, it)
        tk = prng.fold_in(prng.prng_key(seed), it)
        assert tuple(np.asarray(jk).tolist()) == tk
        for n in (1, 7, 1001, 4096):
            assert np.array_equal(
                np.asarray(jax.random.bits(jk, (n,), jnp.uint32)),
                prng.random_bits(tk, n))
            assert np.array_equal(
                np.asarray(jax.random.uniform(jk, (n,), jnp.float32)).view(
                    np.uint32),
                prng.uniform(tk, n).view(np.uint32))
            g = np.asarray(jax.random.gumbel(jk, (n,), dtype=jnp.float32))
            assert np.array_equal(g.view(np.uint32),
                                  prng.gumbel(tk, n).view(np.uint32))


def test_prng_log_matches_xla_bitwise():
    """XLA's float32 log is not correctly rounded; log32 is its
    evaluation, bit for bit, over 200,000 values of every magnitude."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(0.5, 2.0, 100_000),
        np.exp(rng.uniform(-80, 80, 100_000))]).astype(np.float32)
    ref = np.asarray(jax.jit(jnp.log)(jnp.asarray(x)))
    assert np.array_equal(ref.view(np.uint32), prng.log32(x).view(np.uint32))
    with pytest.raises(ValueError):
        prng.prng_key(-1)


# -- the serving clustering -------------------------------------------------------

def test_lloyd_reseed_matches_jax():
    xu, rng = _planted_mixture()
    sel = rng.choice(xu.shape[0], size=24, replace=False)
    jc, ja_ = jp.lloyd_reseed(jnp.asarray(xu), jnp.asarray(xu[sel]), 12,
                              seed=0)
    tc, ta_ = tp.lloyd_reseed(torch.from_numpy(xu),
                              torch.from_numpy(xu[sel]), 12, seed=0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=TOL)
    assert np.array_equal(ta_.numpy(), np.asarray(ja_))


def test_lloyd_reseed_float64_bitwise_and_twins():
    """On float64 data the clusterings are bitwise equal, reseeding
    included (the 40-mixture from a random start: empty clusters and twin
    centroids both recycle)."""
    rng = np.random.default_rng(77)
    base = rng.normal(size=(40, 32))
    x = np.repeat(base, 50, axis=0) + 0.15 * rng.normal(size=(2000, 32))
    c0 = x[np.random.default_rng(3).choice(2000, 40, replace=False)]
    jc, ja_ = jp.lloyd_reseed(jnp.asarray(x), jnp.asarray(c0), 12, seed=42)
    tc, ta_ = tp.lloyd_reseed(torch.from_numpy(x), torch.from_numpy(c0), 12,
                              seed=42)
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(ta_.numpy(), np.asarray(ja_))
    plain, _ = tp._lloyd(torch.from_numpy(x), torch.from_numpy(c0), 12)
    assert not torch.equal(plain, tc)          # the reseeding acted


def test_lloyd_tighten_matches_jax():
    xu, rng = _planted_mixture()
    sel = rng.choice(xu.shape[0], size=24, replace=False)
    c = np.array(jp.lloyd_reseed(jnp.asarray(xu), jnp.asarray(xu[sel]), 12,
                                 seed=0)[0])
    jc, ja_ = jp.lloyd_tighten(jnp.asarray(xu), jnp.asarray(c), max_size=100)
    tc, ta_ = tp.lloyd_tighten(torch.from_numpy(xu), torch.from_numpy(c),
                               max_size=100)
    assert tc.shape == jc.shape and tc.shape[0] > 24      # it split
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=TOL)
    assert np.array_equal(ta_.numpy(), np.asarray(ja_))


def test_pad_k_sentinels_match_jax():
    """At K >= 1024 grown centroid sets pad to a multiple of 128 with far
    sentinels that capture no member; K sets the slab layout."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3000, 8)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    c = x[:1030]
    jc, ja_ = jp.lloyd_tighten(jnp.asarray(x), jnp.asarray(c), r_max=0.05,
                               max_rounds=1)
    tc, ta_ = tp.lloyd_tighten(torch.from_numpy(x), torch.from_numpy(c),
                               r_max=0.05, max_rounds=1)
    assert tc.shape == jc.shape and tc.shape[0] % 128 == 0
    assert np.all(tc.numpy()[-1] == 1e6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=TOL)
    assert np.array_equal(ta_.numpy(), np.asarray(ja_))


def test_reduce_corpus_reseed_matches_jax():
    xu, _ = _planted_mixture()
    jr = jp.reduce_corpus(jnp.asarray(xu), seed=42, keep_rate=1.0,
                          k_clusters=24, reseed_empty=True)
    tr = tp.reduce_corpus(torch.from_numpy(xu), seed=42, keep_rate=1.0,
                          k_clusters=24, reseed_empty=True)
    np.testing.assert_allclose(tr.centroids.numpy(), np.asarray(jr.centroids),
                               rtol=0, atol=TOL)
    assert np.array_equal(tr.assignments.numpy(), np.asarray(jr.assignments))
    assert tp.planned_slab_cap(1_000_000, 4096, 1.5) == \
        jp.planned_slab_cap(1_000_000, 4096, 1.5)


def test_enable_ivf_matches_jax(served):
    ja, jg, ta, tg, items = served
    np.testing.assert_allclose(ta._centroids.numpy(),
                               np.asarray(ja._centroids), rtol=0, atol=1e-12)
    assert np.array_equal(ta._assignments.numpy(),
                          np.asarray(ja._assignments))
    assert ta._ivf_cap_plan == ja._ivf_cap_plan
    for a, b in zip(ta._ivf[1:], ja._ivf[1:]):      # buckets, tail
        assert np.array_equal(a.numpy(), np.asarray(b))


# -- the slab layout ----------------------------------------------------------------

def _skewed(seed, n, f, k, share):
    """tests/test_ivf.py:101 and :302: most items in cluster 0, so the
    layout spills."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    xu = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    lams = rng.uniform(0.1, 0.9, size=n).astype(np.float32)
    assign = np.where(rng.uniform(size=n) < share, 0,
                      rng.integers(1, k, size=n)).astype(np.int32)
    cents = rng.normal(size=(k, f)).astype(np.float32)
    return xu, lams, assign, cents


def _both_layouts(xu, lams, cents, assign, dt=None, **kw):
    jb = jis.build_blocked_ivf(jnp.asarray(xu), jnp.asarray(lams), cents,
                               assign, slab_dtype=dt and jnp.bfloat16, **kw)
    tb = tis.build_blocked_ivf(torch.from_numpy(xu), torch.from_numpy(lams),
                               torch.tensor(cents), assign,
                               slab_dtype=dt and torch.bfloat16, **kw)
    return jb, tb


@pytest.mark.parametrize("case", [(11, 1500, 16, 12, 0.85),
                                  (81, 1200, 16, 8, 0.7)])
@pytest.mark.parametrize("dt", [None, "bf16"])
def test_build_blocked_ivf_matches_jax(case, dt):
    xu, lams, assign, cents = _skewed(*case)
    jb, tb = _both_layouts(xu, lams, cents, assign, dt)
    assert tb.cap == jb.cap
    ids = tb.slab_ids.numpy()
    assert np.array_equal(ids, np.asarray(jb.slab_ids))
    assert sorted(ids[ids >= 0].tolist()) == list(range(case[1]))
    spilled = (ids >= 0) & (np.repeat(np.arange(case[3]), tb.cap)
                            != assign[np.maximum(ids, 0)])
    assert spilled.any()                          # the spill path ran
    if dt:
        assert tb.slabs.dtype == torch.bfloat16
        assert np.array_equal(tb.slabs.view(torch.int16).numpy(),
                              np.asarray(jb.slabs).view(np.int16))
    for name in ("radii", "lam_lo", "lam_hi", "res_eps"):
        a, b = getattr(tb, name), getattr(jb, name)
        if b is None:
            assert a is None
            continue
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=TOL)
    assert np.array_equal(tb.nonempty.numpy(), np.asarray(jb.nonempty))
    np.testing.assert_allclose(tb.centroids_unit.numpy(),
                               np.asarray(jb.centroids_unit), rtol=0,
                               atol=TOL)


# -- routing, the K6 plain version and blocked_ivf_search ---------------------------

def _mixture_index(dt=None):
    xu, rng = _planted_mixture()
    n, f = xu.shape
    lams = rng.uniform(0.3, 0.5, size=n).astype(np.float32)
    sel = rng.choice(n, size=24, replace=False)
    cents, assign = jp.lloyd_reseed(jnp.asarray(xu), jnp.asarray(xu[sel]),
                                    12, seed=0)
    jb, tb = _both_layouts(xu, lams, np.asarray(cents), np.asarray(assign),
                           dt)
    rows = rng.choice(n, size=64, replace=False)
    q = xu[rows] + (0.25 / np.sqrt(f)) * rng.standard_normal(
        (64, f)).astype(np.float32)
    qn = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    return xu, lams, jb, tb, qn, lams[rows]


@pytest.mark.parametrize("use_bound", [True, False])
def test_routing_probe_tables_match_jax(use_bound):
    _, _, jb, tb, qn, lamq = _mixture_index()
    q = qn.shape[0] - 5                      # a padded last block
    bound = ((jb.radii, jb.lam_lo, jb.lam_hi, jb.nonempty) if use_bound
             else None)
    j_out = jis._route_scan_core(
        jb.centroids_unit, jb.slabs, jb.slab_lambdas, jb.slab_ids,
        jnp.asarray(qn[:q]), jnp.asarray(lamq[:q]), jnp.float32(TAU), k=15,
        qb=16, q=q, cap=jb.cap, n_probe=5, interpret=True,
        bound_state=bound)
    t_out = tis._route_scan_core(tb, torch.from_numpy(qn[:q]),
                                 torch.from_numpy(lamq[:q]), tis._f32(TAU),
                                 k=15, qb=16, n_probe=5, use_bound=use_bound)
    assert np.array_equal(t_out[5].numpy(), np.asarray(j_out[5]))
    assert np.array_equal(t_out[2].numpy(), np.asarray(j_out[2]))   # inv
    np.testing.assert_allclose(t_out[1].numpy(), np.asarray(j_out[1]),
                               rtol=0, atol=TOL)
    assert np.array_equal(t_out[0].numpy(), np.asarray(j_out[0]))
    if use_bound:
        np.testing.assert_allclose(t_out[6].numpy(), np.asarray(j_out[6]),
                                   rtol=0, atol=TOL)


def _scan_inputs(seed, dt, n_clusters=12, cap=128, f=24, qb=8, n_blocks=3,
                 n_probe=4, tied=False):
    rng = np.random.default_rng(seed)
    rows = n_clusters * cap
    if tied:
        # Rows of four +-0.5 entries: dot products exact in any order, so
        # equal rows (with equal lambdas) tie exactly.
        base = np.zeros((6, f), np.float32)
        for r in range(6):
            base[r, rng.choice(f, 4, replace=False)] = rng.choice(
                [-0.5, 0.5], 4)
        x = base[rng.integers(0, 6, rows)]
        lam = np.full(rows, 0.2, np.float32)
        qn = base[rng.integers(0, 6, n_blocks * qb)]
        lamq = np.full(n_blocks * qb, 0.2, np.float32)
    else:
        x = rng.standard_normal((rows, f)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        lam = rng.uniform(0.05, 0.3, rows).astype(np.float32)
        qn = rng.standard_normal((n_blocks * qb, f)).astype(np.float32)
        qn /= np.linalg.norm(qn, axis=1, keepdims=True)
        lamq = rng.uniform(0.05, 0.3, n_blocks * qb).astype(np.float32)
    ids = rng.permutation(3 * rows)[:rows].astype(np.int32)
    ids[rng.uniform(size=rows) > 0.85] = -1
    lam[ids < 0] = np.inf
    probe = np.stack([rng.permutation(n_clusters)[:n_probe]
                      for _ in range(n_blocks)]).astype(np.int32)
    if dt == "bf16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x, lam, ids, qn, lamq, probe


def _scan_both(x, lam, ids, qn, lamq, probe, dt, k, qb=8, cap=128):
    jdt = jnp.bfloat16 if dt == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dt == "bf16" else torch.float32
    n_blocks, n_probe = probe.shape
    js, ji = jis._ivf_scan(
        jnp.asarray(x, jdt), jnp.asarray(lam)[None, :],
        jnp.asarray(ids)[None, :], jnp.asarray(qn),
        jnp.broadcast_to(jnp.asarray(lamq)[:, None], (len(lamq), 128)),
        jnp.asarray(probe), TAU, k=k, q_block=qb, cap=cap, n_probe=n_probe,
        interpret=True)
    ts, ti = k6.ivf_scan(torch.from_numpy(x).to(tdt), torch.from_numpy(lam),
                         torch.from_numpy(ids), torch.from_numpy(qn),
                         torch.from_numpy(lamq), torch.from_numpy(probe),
                         TAU, k=k, q_block=qb, cap=cap,
                         tiles=k6.slab_tiles(torch.from_numpy(ids), cap))
    return (ts.numpy(), ti.numpy()), (np.asarray(js), np.asarray(ji))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("k", [15, 512])
def test_ivf_scan_plain_matches_pallas(dt, k):
    x, lam, ids, qn, lamq, probe = _scan_inputs(k, dt)
    (ts, ti), (js, ji) = _scan_both(x, lam, ids, qn, lamq, probe, dt, k)
    np.testing.assert_allclose(ts, js, rtol=0, atol=TOL)
    assert topk_disagreements(ts, ti, js, ji, TOL) == []
    assert (ti == ji).mean() > 0.99          # near-ties swap a few
    if k == 512:                          # every probed slot, padding too
        assert np.all((ti < 0) == (ts <= -3.0e38)) and (ti < 0).any()


def test_ivf_scan_plain_ties_at_the_kth_slot():
    """Exact ties: the plain version (and the CUDA kernel, MaxLex) keep the
    lexicographic (score desc, id asc) top-k.  The Pallas merge inserts a
    new entry BEFORE equal entries already held (ROADMAP §3), so where a
    tie straddles the kth slot it keeps other ids of the tie; the scores
    are equal everywhere."""
    x, lam, ids, qn, lamq, probe = _scan_inputs(3, "f32", tied=True)
    (ts, ti), (js, ji) = _scan_both(x, lam, ids, qn, lamq, probe, "f32", 20)
    np.testing.assert_array_equal(ts, js)
    straddled = 0
    for r in range(len(qn)):
        b = r // 8
        rows = (probe[b][:, None] * 128 + np.arange(128)).reshape(-1)
        score = np.where(ids[rows] < 0, -3.0e38,
                         (TAU * (x[rows] @ qn[r])
                          + (1 - TAU) / (1 + np.abs(lam[rows] - lamq[r])))
                         ).astype(np.float32)
        order = np.lexsort((ids[rows], -score))[:20]
        assert np.array_equal(ti[r], ids[rows][order])          # lexicographic
        kth = ts[r, -1]
        tie = set(ids[rows][score == kth].tolist())
        same = ti[r] == ji[r]
        assert all(a in tie and b_ in tie
                   for a, b_ in zip(ti[r][~same], ji[r][~same]))
        straddled += int(not same.all())
    assert straddled > 0                  # the divergence shows here


@pytest.mark.parametrize("dt", [None, "bf16"])
@pytest.mark.parametrize("certify", [False, True])
def test_blocked_ivf_search_matches_jax(dt, certify):
    xu, lams, jb, tb, qn, lamq = _mixture_index(dt)
    kw = {}
    if certify and dt:
        kw = dict(rescore_corpus=xu, rescore_lambdas=lams)
    jo = jis.blocked_ivf_search(jb, jnp.asarray(qn), jnp.asarray(lamq), TAU,
                                15, n_probe=8, certify=certify,
                                **{k: jnp.asarray(v) for k, v in kw.items()})
    to = tis.blocked_ivf_search(tb, torch.from_numpy(qn),
                                torch.from_numpy(lamq), TAU, 15, n_probe=8,
                                certify=certify,
                                **{k: torch.from_numpy(v)
                                   for k, v in kw.items()})
    assert np.array_equal(to[0].numpy(), np.asarray(jo[0]))
    np.testing.assert_allclose(to[1].numpy(), np.asarray(jo[1]), rtol=0,
                               atol=TOL)
    if certify:
        cert = to[2].numpy()
        assert np.array_equal(cert, np.asarray(jo[2])) and cert.mean() > 0.8


def test_pack_and_cert_helpers():
    idx = torch.tensor([[3, -1], [7, 2]], dtype=torch.int32)
    vals = torch.tensor([[0.5, -3e38], [0.25, 0.125]])
    cert = torch.tensor([True, False])
    i, v, c = tis.unpack_certified(tis.pack_certified(idx, vals, cert), 4)
    assert np.array_equal(i, idx.numpy()) and np.array_equal(v, vals.numpy())
    assert c.tolist() == [True, False]
    with pytest.raises(ValueError):
        tis.unpack_certified(tis.pack_certified(idx, vals, cert), 1)
    for args in ((None, 10, 1000), (7, 5, 1000), (None, 10, 20)):
        assert tis.cert_pool_width(*args) == jis.cert_pool_width(*args)
    for args in ((False, 4), (True, 4), (True, 8)):
        assert tis.default_q_block(*args) == jis.default_q_block(*args)
    for q in (1, 5, 9, 100):
        assert tis.q_block_for(q) == jis.q_block_for(q)
    for f in (32, 768):
        assert tis.scan_dot_eps(torch.bfloat16, f) == \
            jis.scan_dot_eps(jnp.bfloat16, f)
    assert tis.cast_residual_worst(torch.float16) == \
        jis.cast_residual_worst(jnp.float16)


# -- search_batch: ivf_block and certified ------------------------------------------

@pytest.mark.parametrize("kw", [dict(mode="ivf_block", n_probe=8),
                                dict(mode="ivf_block", n_probe=3,
                                     certify=True, q_block=8),
                                dict(mode="certified", n_probe=8)])
def test_search_batch_ivf_modes_match_jax(served, kw):
    ja, jg, ta, tg, items = served
    queries = _mixed_queries(items, 71)
    jo = ja.search_batch(queries, jg, TAU, **kw)
    to = ta.search_batch(queries, tg, TAU, **kw)
    assert np.array_equal(to[0], np.asarray(jo[0]))
    np.testing.assert_allclose(to[1], np.asarray(jo[1], np.float64), rtol=0,
                               atol=TOL)
    if len(jo) == 3:
        assert np.array_equal(to[2], np.asarray(jo[2]))
    if kw["mode"] == "certified":
        ei, ev = ta.search_batch(queries, tg, TAU, mode="exact")
        assert np.array_equal(to[0], ei)


def test_certified_narrow_width_escalates(served):
    """cap * n_probe < topk: with widening off every query escalates to
    the exact path (bitwise float64 output); with widening on the grown
    width serves the exact top-k set."""
    ja, jg, ta, tg, items = served
    rng = np.random.default_rng(91)
    queries = items[rng.choice(2000, 4, replace=False)] * 1.02
    ei, ev = ta.search_batch(queries, tg, TAU, topk=200, mode="exact")
    ci, cv = ta.search_batch(queries, tg, TAU, mode="certified", topk=200,
                             n_probe=1, n_widen=0)
    assert np.array_equal(ci, ei) and np.array_equal(cv, ev)
    wi, wv = ta.search_batch(queries, tg, TAU, mode="certified", topk=200,
                             n_probe=1)
    ji, _ = ja.search_batch(queries, jg, TAU, mode="certified", topk=200,
                            n_probe=1)
    assert np.array_equal(wi, np.asarray(ji))
    for r in range(4):
        assert set(wi[r].tolist()) == set(ei[r].tolist())


def test_certified_widening_integration(served, monkeypatch):
    ja, jg, ta, tg, items = served
    rng = np.random.default_rng(101)
    queries = np.concatenate([
        items[rng.choice(2000, 12, replace=False)] * 1.02,
        rng.normal(size=(4, 32))])
    _, _, cert_raw = ta.search_batch(queries, tg, TAU, mode="ivf_block",
                                     n_probe=3, certify=True, q_block=8)
    seen = {}
    orig_esc, orig_widen = tis.escalate_uncertified, tis.widen_refusals

    def spy_esc(idx, vals, cert, run_exact, topk):
        seen["after"] = np.array(cert, dtype=bool)
        return orig_esc(idx, vals, cert, run_exact, topk)

    def spy_widen(idx, vals, cert, run_certified, topk, n_probe, n_max):
        seen["n_probe_max"] = n_max
        return orig_widen(idx, vals, cert, run_certified, topk, n_probe,
                          n_max)

    monkeypatch.setattr(tis, "escalate_uncertified", spy_esc)
    monkeypatch.setattr(tis, "widen_refusals", spy_widen)
    ci, cv = ta.search_batch(queries, tg, TAU, mode="certified", n_probe=3,
                             n_widen=4, q_block=8)
    ji, jv = ja.search_batch(queries, jg, TAU, mode="certified", n_probe=3,
                             n_widen=4, q_block=8)
    ei, _ = ta.search_batch(queries, tg, TAU, mode="exact")
    assert np.array_equal(ci, np.asarray(ji)) and np.array_equal(ci, ei)
    assert seen["n_probe_max"] >= 6
    assert seen["after"].sum() > cert_raw.sum()        # widening added


def test_certified_bf16_slabs_match_jax():
    rng = np.random.default_rng(77)
    base = rng.normal(size=(40, 32))
    items = np.repeat(base, 50, axis=0) + 0.15 * rng.normal(size=(2000, 32))
    ja, jg = jx.ArrowSpaceBuilder.build(GP, items)
    ta, tg = _carry(ja, jg)
    ja.enable_ivf(n_clusters=40, slab_dtype=jnp.bfloat16)
    ta.enable_ivf(n_clusters=40, slab_dtype=torch.bfloat16)
    queries = _mixed_queries(items, 52, n_neg=0)
    jo = ja.search_batch(queries, jg, TAU, mode="ivf_block", n_probe=40,
                         certify=True)
    to = ta.search_batch(queries, tg, TAU, mode="ivf_block", n_probe=40,
                         certify=True)
    assert ta._ivf_blocked.slabs.dtype == torch.bfloat16
    assert np.array_equal(to[0], np.asarray(jo[0]))
    assert np.array_equal(to[2], np.asarray(jo[2])) and to[2].any()
    ci, _ = ta.search_batch(queries, tg, TAU, mode="certified")
    ei, _ = ta.search_batch(queries, tg, TAU, mode="exact")
    assert np.array_equal(ci, ei)


# -- the two reference faults ------------------------------------------------------

def test_leaner_slab_factor_shrinks_the_slab():
    """Fault of the reference (core/space.py:333-343 against 369-373 and
    396-401): once a clustering was planned, a leaner slab factor keeps the
    old planned cap as min_cap, so the slab cannot shrink and the saved
    factor disagrees with the layout.  In the port the plan follows the
    factor: the clustering is re-tightened to the new plan, the cap
    shrinks, and the layout stays a spill-free partition."""
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(8, 16)).astype(np.float32) * 4.0
    items = (np.repeat(centers, 256, axis=0)
             + 0.2 * rng.normal(size=(2048, 16)).astype(np.float32))
    ja, jg = jx.ArrowSpaceBuilder.build(GP, items)
    ta, tg = _carry(ja, jg)
    for a in (ja, ta):
        a.enable_ivf(n_clusters=8, capacity_factor=2.0)
        assert a._ensure_ivf_blocked().cap == 512
        a.enable_ivf(capacity_factor=1.5)
    lean = ta._ensure_ivf_blocked()
    assert ta._ivf_cap_factor == ja._ivf_cap_factor == 1.5
    assert ja._ensure_ivf_blocked().cap == 512          # the reference
    assert lean.cap == tp.planned_slab_cap(2048, 8, 1.5) == 384
    ids = lean.slab_ids.numpy()
    assert sorted(ids[ids >= 0].tolist()) == list(range(2048))
    home = np.repeat(np.arange(lean.n_clusters), lean.cap)
    assign = ta._assignments.numpy()
    assert np.all(assign[ids[ids >= 0]] == home[ids >= 0])   # no spill
    queries = items[rng.choice(2048, 6, replace=False)] * 1.02
    ci, _ = ta.search_batch(queries, tg, TAU, mode="certified")
    ei, _ = ta.search_batch(queries, tg, TAU, mode="exact")
    assert np.array_equal(ci, ei)


def _ladder(stream_cls):
    """Drive a stream whose every batch collapses (base rate 0): depth 4,
    patience 2, two escalation rungs, an exact fallback."""
    state = {"n_probe": 8, "rungs": 2}
    dispatched = []

    def dispatch(q):
        dispatched.append(state["n_probe"])
        return state["n_probe"]

    def on_collapse():
        if state["rungs"] == 0:
            return False
        state["rungs"] -= 1
        state["n_probe"] *= 2
        return True

    s = stream_cls(dispatch, lambda q, out: (q, out, 0.0),
                   fallback=lambda q: q,
                   finalize_fallback=lambda q, out: (q, None),
                   depth=4, cert_floor=0.35, floor_patience=2,
                   on_collapse=on_collapse)
    for b in range(12):
        s.submit(b)
    s.finish()
    return s, dispatched


def test_escalation_ladder_waits_for_the_new_setting():
    """Fault of the reference (serving.py:134-142): batches already in
    flight at the old n_probe when a rung fires still count, so the
    reference spends its second rung on batches 2 and 3 (dispatched at
    n_probe 8 before the first rung) and degrades on batches 4 and 5.  In
    the port a rung counts only batches dispatched after it: the second
    rung fires on batches 5 and 6 (n_probe 16), and the stream degrades
    only after batches at n_probe 32 collapse too."""
    ref, ref_np = _ladder(RefStream)
    assert ref.escalated_at == [1, 3] and ref.degraded_at == 5
    assert ref_np[2:4] == [8, 8]          # the second rung's evidence
    port, port_np = _ladder(CertifiedStream)
    assert port.escalated_at == [1, 6] and port.degraded_at == 11
    assert port_np[5:7] == [16, 16] and port_np[10:12] == [32, 32]


def test_serving_stream_matches_certified(served):
    ja, jg, ta, tg, items = served
    rng = np.random.default_rng(7)
    batches = [items[rng.choice(2000, 24, replace=False)] * 1.01
               for _ in range(3)]
    stream = ta.serving_stream(tg, TAU, depth=2)
    for b in batches:
        stream.submit(b)
    got = stream.finish()
    assert len(got) == 3 and not stream.degraded
    for (idx, vals, rate), b in zip(got, batches):
        ci, cv = ta.search_batch(b, tg, TAU, mode="certified")
        assert np.array_equal(idx, ci) and np.array_equal(vals, cv)
        assert 0.0 <= rate <= 1.0


# -- lists wider than 256 ------------------------------------------------------------

@pytest.mark.parametrize("mode", ["exact", "subtile"])
def test_search_batch_topk_300_matches_jax(served, mode):
    ja, jg, ta, tg, items = served
    # One query for subtile: its Pallas selects of 300 run in interpret
    # mode, ~9 s a batch on the CPU.
    queries = items[:3 if mode == "exact" else 1] * 1.01
    ji, jv = ja.search_batch(queries, jg, TAU, topk=300, mode=mode)
    ti, tv = ta.search_batch(queries, tg, TAU, topk=300, mode=mode)
    assert ti.shape == (len(queries), 300)
    np.testing.assert_allclose(tv, np.asarray(jv), rtol=0, atol=TOL)
    assert topk_disagreements(tv, ti, np.asarray(jv), np.asarray(ji),
                              TOL) == []
