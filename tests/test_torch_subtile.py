"""Subtile serving of the PyTorch port (ops/subtile_scan.py and the plain
versions of kernels K3, K4a, K4b and K5) against the JAX package's
ops/pallas/subtile_scan.py, its Pallas kernels run in interpret mode, on
the same numpy inputs.

Tolerances: the serving state is bitwise equal; the extractions (K4a,
K4b) return identical ids, since they do no arithmetic; scores (K3, K5,
subtile_search) agree within 1e-6, the float32 rounding of sums taken in
another order; top-k ids are equal outside near-ties of 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyarrowspace_tpu as jx
import pyarrowspace_tpu_torch as pt
from pyarrowspace_tpu.ops.pallas import subtile_scan as jss
from pyarrowspace_tpu_torch.core import space as space_mod
from pyarrowspace_tpu_torch.io import state_from_numpy
from pyarrowspace_tpu_torch.ops import subtile_scan as tss
from pyarrowspace_tpu_torch.ops.cuda import extract, gather_score, subtile_max
from pyarrowspace_tpu_torch.ops.cuda.compare import topk_disagreements
from pyarrowspace_tpu_torch.ops.search import lambda_aware_topk_batch

TOL = 1e-6
TAU = 0.62


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _corpus(seed, n, f, lam_lo=0.05, lam_hi=0.3):
    rng = np.random.default_rng(seed)
    xu = _unit(rng.standard_normal((n, f), dtype=np.float32))
    lam = rng.uniform(lam_lo, lam_hi, n).astype(np.float32)
    return rng, xu, lam


def _states(xu, lam, scan=np.float32):
    """The JAX package's and the port's serving state of one corpus."""
    jdt = jnp.float32 if scan == np.float32 else jnp.bfloat16
    tdt = torch.float32 if scan == np.float32 else torch.bfloat16
    js = jss.build_subtile_state(jnp.asarray(xu), jnp.asarray(lam),
                                 scan_dtype=jdt)
    ts = tss.build_subtile_state(torch.from_numpy(xu), torch.from_numpy(lam),
                                 scan_dtype=tdt)
    return js, ts


def _search_both(js, ts, qn, lam_q, **kw):
    ji, jv = jss.subtile_search(js["xu_scan"], js["xu_f32"], js["lambdas"],
                                jnp.asarray(qn), jnp.asarray(lam_q),
                                jnp.float32(TAU), js["n_real"], **kw)
    ti, tv = tss.subtile_search(ts["xu_scan"], ts["xu_f32"], ts["lambdas"],
                                torch.from_numpy(qn), torch.from_numpy(lam_q),
                                TAU, ts["n_real"], **kw)
    return (np.asarray(ji), np.asarray(jv)), (ti.numpy(), tv.numpy())


def _assert_agree(port, ref):
    (ti, tv), (ji, jv) = port, ref
    assert ti.dtype == np.int32 and ti.shape == ji.shape
    np.testing.assert_allclose(tv, jv, rtol=0, atol=TOL)
    assert topk_disagreements(tv, ti, jv, ji, TOL) == []


def _overlap(a, b):
    k = a.shape[1]
    return np.mean([len(set(x) & set(y)) / k for x, y in zip(a, b)])


def _exact_ids(xu, lam, qn, lam_q, topk):
    idx, _ = lambda_aware_topk_batch(
        torch.from_numpy(xu), torch.from_numpy(lam), torch.from_numpy(qn),
        torch.from_numpy(lam_q), torch.tensor(TAU, dtype=torch.float32), topk)
    return idx.numpy()


# -- the serving state ---------------------------------------------------------

@pytest.mark.parametrize("scan", [np.float32, "bf16"])
def test_build_subtile_state_bitwise(scan):
    rng = np.random.default_rng(5)
    xu = rng.standard_normal((3000, 40))
    xu /= np.linalg.norm(xu, axis=1, keepdims=True)      # float64 input
    lam = rng.uniform(0.0, 1.0, 3000)
    js, ts = _states(xu, lam, scan)
    assert ts["n_real"] == js["n_real"] == 3000
    assert ts["xu_scan"].shape == (8192, 40)
    if scan == np.float32:
        assert ts["xu_scan"].dtype == torch.float32
        np.testing.assert_array_equal(
            ts["xu_scan"].numpy().view(np.uint32),
            np.asarray(js["xu_scan"]).view(np.uint32))
    else:
        assert ts["xu_scan"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            ts["xu_scan"].view(torch.int16).numpy(),
            np.asarray(js["xu_scan"]).view(np.int16))
    np.testing.assert_array_equal(ts["xu_f32"].numpy().view(np.uint32),
                                  np.asarray(js["xu_f32"]).view(np.uint32))
    np.testing.assert_array_equal(ts["lambdas"].numpy().view(np.uint32),
                                  np.asarray(js["lambdas"]).view(np.uint32))
    assert np.all(ts["lambdas"].numpy()[3000:] == -2.0)


# -- K4b and K4a: identical ids ------------------------------------------------

def _tied_scores(rng, rows, cols, n_sentinel):
    """Scores on a grid of eighths (exact ties everywhere) with some
    entries masked to their sentinel -1e6 - id."""
    s = (rng.integers(0, 24, (rows, cols)) / 8.0).astype(np.float32)
    for r in range(rows):
        at = rng.choice(cols, n_sentinel, replace=False)
        s[r, at] = np.float32(-1.0e6) - at.astype(np.float32)
    return s


@pytest.mark.parametrize("m", [16, 48, 200])
def test_extract_ids_plain_matches_pallas(m):
    rng = np.random.default_rng(m)
    score = _tied_scores(rng, 8, 300, 40)               # [Q, M]
    ref = jss._extract_ids_pallas_t(jnp.asarray(score.T), m_pool=m,
                                    interpret=True)
    got = extract.extract_ids(torch.from_numpy(score), m)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("m", [15, 30, 48])
def test_extract_pool_plain_matches_pallas(m):
    rng = np.random.default_rng(100 + m)
    q, cols = 8, 256
    score = _tied_scores(rng, q, cols, 30)
    # Distinct ids per row in no order; a masked entry's sentinel is made
    # from its cand id, as subtile_search makes it.
    cand = np.stack([rng.permutation(5000)[:cols] for _ in range(q)])
    cand = cand.astype(np.int32)
    masked = score < -1.0e5
    score[masked] = np.float32(-1.0e6) - cand[masked].astype(np.float32)
    ref = jss._extract_pool_pallas(jnp.asarray(score), jnp.asarray(cand),
                                   m_pool=m, interpret=True)
    got = extract.extract_pool(torch.from_numpy(score),
                               torch.from_numpy(cand), m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# -- K3 and K5: scores within 1e-6 ---------------------------------------------

@pytest.mark.parametrize("scan", [np.float32, "bf16"])
def test_subtile_max_plain_matches_pallas(scan):
    """n = 3000: subtile 46 holds 56 real rows and 8 pad rows; 47..127
    are padding."""
    rng, xu, lam = _corpus(3, 3000, 128)
    js, ts = _states(xu, lam, scan)
    q = 16
    qn = _unit(rng.standard_normal((q, 128), dtype=np.float32))
    lam_q = rng.uniform(0.05, 0.3, q).astype(np.float32)
    qn_scan = jnp.asarray(qn).astype(js["xu_scan"].dtype)
    sub_t, _ = jss._subtile_pallas_t(
        js["xu_scan"], js["lambdas"].reshape(-1, 1), qn_scan,
        jnp.asarray(lam_q).reshape(1, q), jnp.float32(TAU), q_block=q,
        col_tile=1024, interpret=True)
    got = subtile_max.subtile_max(
        ts["xu_scan"], ts["lambdas"],
        torch.from_numpy(qn).to(ts["xu_scan"].dtype),
        torch.from_numpy(lam_q), TAU, 3000).numpy()
    assert got.shape == (q, 128) and got.dtype == np.float32
    np.testing.assert_allclose(got[:, :46], np.asarray(sub_t).T[:, :46],
                               rtol=0, atol=TOL)
    # The partial subtile: the max over its 56 real rows only.
    x = np.asarray(ts["xu_scan"][2944:3000].to(torch.float32), np.float64)
    qs = np.asarray(torch.from_numpy(qn).to(ts["xu_scan"].dtype)
                    .to(torch.float32), np.float64)
    blend = (TAU * qs @ x.T + (1 - TAU)
             / (1 + np.abs(lam[2944:3000][None, :] - lam_q[:, None])))
    np.testing.assert_allclose(got[:, 46], blend.max(axis=1), rtol=0,
                               atol=TOL)
    sentinel = np.float32(-1.0e6) - np.arange(47, 128, dtype=np.float32)
    np.testing.assert_array_equal(got[:, 47:], np.broadcast_to(sentinel,
                                                               (q, 81)))


@pytest.mark.parametrize("scan", [np.float32, "bf16"])
def test_gather_score_plain_matches_pallas(scan):
    rng, xu, _ = _corpus(4, 2000, 96)
    js, ts = _states(xu, np.zeros(2000, np.float32), scan)
    q, s_keep = 12, 6
    qn = _unit(rng.standard_normal((q, 96), dtype=np.float32))
    sel = np.stack([rng.permutation(128)[:s_keep] for _ in range(q)])
    sel = sel.astype(np.int32)
    xb3 = js["xu_scan"].reshape(128, 64, 96)
    qn_j = jnp.asarray(qn).astype(xb3.dtype).reshape(q, 1, 96)
    ref = jss._gather_score_pallas(xb3, qn_j, jnp.asarray(sel),
                                   s_keep=s_keep, interpret=True)
    got = gather_score.gather_score(
        ts["xu_scan"], torch.from_numpy(qn).to(ts["xu_scan"].dtype),
        torch.from_numpy(sel))
    assert got.shape == (q, s_keep * 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL)


# -- subtile_search: the cases of tests/test_subtile.py -------------------------

def _queries(rng, q, f, lo=0.05, hi=0.3):
    qn = _unit(rng.standard_normal((q, f), dtype=np.float32))
    return qn, rng.uniform(lo, hi, q).astype(np.float32)


@pytest.mark.parametrize("case", [
    # (seed, n, f, q, search keywords)
    (0, 5000, 256, 64, dict(topk=10, n_subtiles_keep=16, pool_m=64)),
    (0, 5000, 256, 16, dict(topk=25, n_subtiles_keep=16)),
    (11, 20000, 32, 32, dict(topk=10)),
    (11, 1000, 64, 16, dict(topk=30, pool_m=30)),
    (11, 1000, 64, 16, dict(topk=30, pool_m=60)),
], ids=["matches_exact", "topk_beyond_s_keep", "larger_corpus",
        "no_duplicates_pool30", "no_duplicates_pool60"])
def test_subtile_search_matches_jax(case):
    seed, n, f, q, kw = case
    rng, xu, lam = _corpus(seed, n, f)
    js, ts = _states(xu, lam)
    qn, lam_q = _queries(rng, q, f)
    ref, port = _search_both(js, ts, qn, lam_q, **kw)
    _assert_agree(port, ref)
    topk = kw["topk"]
    ids = port[0]
    assert ids.max() < n
    assert all(len(set(row)) == topk for row in ids)
    assert _overlap(ids, _exact_ids(xu, lam, qn, lam_q, topk)) >= 0.99


def test_subtile_search_pad_guard():
    _, xu, lam = _corpus(0, 5000, 16)
    ts = tss.build_subtile_state(torch.from_numpy(xu), torch.from_numpy(lam))
    with pytest.raises(ValueError, match="padded"):
        tss.subtile_search(torch.from_numpy(xu), ts["xu_f32"], ts["lambdas"],
                           torch.zeros((4, 16)), torch.zeros(4), TAU,
                           ts["n_real"], topk=5)


def test_subtile_search_never_serves_padding():
    """Anti-aligned queries: every real blended score is negative while a
    padded row would score ~0.1; padding must never be served."""
    rng = np.random.default_rng(3)
    n, f = 5000, 256
    direction = rng.standard_normal(f).astype(np.float32)
    xu = _unit(direction[None, :] + 0.05 * rng.standard_normal(
        (n, f)).astype(np.float32))
    lam = rng.uniform(0.05, 0.3, n).astype(np.float32)
    js, ts = _states(xu, lam)
    qn = _unit(-direction[None, :].repeat(8, 0))
    lam_q = np.full(8, 0.1, np.float32)
    ref, port = _search_both(js, ts, qn, lam_q, topk=10)
    _assert_agree(port, ref)
    assert port[0].max() < n


def test_subtile_search_partial_subtile_routing_exact():
    """n = 3000 with lambda-mismatched items and s_keep == topk: the pad
    rows of the partial last subtile must not inflate its routing max."""
    rng, xu, lam = _corpus(3, 3000, 128, 5.0, 9.0)
    js, ts = _states(xu, lam)
    qn, lam_q = _queries(rng, 32, 128, 0.05, 0.2)
    ref, port = _search_both(js, ts, qn, lam_q, topk=16, n_subtiles_keep=16)
    _assert_agree(port, ref)
    assert _overlap(port[0], _exact_ids(xu, lam, qn, lam_q, 16)) == 1.0


@pytest.mark.parametrize("seed,n,f", [(21, 4000, 64), (11, 20000, 32)],
                         ids=["one_subtile_select", "supertile_select"])
def test_subtile_search_two_level_select(monkeypatch, seed, n, f):
    """_SINGLE_LEVEL_MAX_NSUB patched to 8 on both sides: the two-level
    select through K4a must serve what the JAX package's does, and what
    the port's one-level select does.  At n = 4000 there are fewer
    supertiles (8) than s_keep (16), so the subtiles are selected at once;
    at n = 20000 the top supertiles are selected first."""
    rng, xu, lam = _corpus(seed, n, f)
    js, ts = _states(xu, lam)
    qn, lam_q = _queries(rng, 16, f)
    one_level = _search_both(js, ts, qn, lam_q, topk=10)[1]
    monkeypatch.setattr(jss, "_SINGLE_LEVEL_MAX_NSUB", 8)
    monkeypatch.setattr(tss, "_SINGLE_LEVEL_MAX_NSUB", 8)
    jax.clear_caches()
    try:
        ref, port = _search_both(js, ts, qn, lam_q, topk=10)
    finally:
        jax.clear_caches()
    _assert_agree(port, ref)
    np.testing.assert_array_equal(port[0], one_level[0])
    np.testing.assert_allclose(port[1], one_level[1], rtol=0, atol=TOL)


# -- search_batch on one index carried across -----------------------------------

@pytest.fixture(scope="module")
def carried_index():
    rng = np.random.default_rng(17)
    items = rng.normal(size=(900, 12)) + 0.3
    gp = {"eps": 0.8, "k": 5, "topk": 6, "p": 2.0, "sigma": 0.3}
    ja, jg = jx.ArrowSpaceBuilder.build(gp, items)
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
    ta, tg = state_from_numpy(arrays, params, "cpu")
    queries = items[rng.choice(900, 40)] * 1.02 + 0.01
    return (ja, jg), (ta, tg), queries


@pytest.mark.parametrize("tau,topk", [(0.62, None), (1.0, 9), (0.3, 40)])
def test_search_batch_subtile_matches_jax(carried_index, tau, topk):
    (ja, jg), (ta, tg), queries = carried_index
    ji, jv = ja.search_batch(queries, jg, tau, topk=topk, mode="subtile")
    ti, tv = ta.search_batch(queries, tg, tau, topk=topk, mode="subtile")
    assert ta._subtile["xu_scan"].dtype == torch.bfloat16
    assert tv.dtype == np.float32
    _assert_agree((ti, tv), (np.asarray(ji), np.asarray(jv)))


def test_search_batch_auto_routes_by_threshold(carried_index, monkeypatch):
    _, (ta, tg), queries = carried_index
    assert ta.nitems < space_mod.AUTO_SUBTILE_MIN_ITEMS == 131_072
    exact = ta.search_batch(queries, tg, 0.62, mode="exact")
    subtile = ta.search_batch(queries, tg, 0.62, mode="subtile")
    auto = ta.search_batch(queries, tg, 0.62, mode="auto")
    np.testing.assert_array_equal(auto[0], exact[0])
    np.testing.assert_array_equal(auto[1], exact[1])
    monkeypatch.setattr(space_mod, "AUTO_SUBTILE_MIN_ITEMS", ta.nitems)
    auto = ta.search_batch(queries, tg, 0.62, mode="auto")
    np.testing.assert_array_equal(auto[0], subtile[0])
    np.testing.assert_array_equal(auto[1], subtile[1])
