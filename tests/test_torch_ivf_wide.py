"""K6's lists past 256 on the CPU: a numpy model of the kernel's wide
route (tests/_ivf_wide_model.py: the filter refreshed at each merge,
staging rows of the kernel's 512 keys, csrc/knn_wide.cuh's descending keys,
one sorted merge) bit for bit the plain version on tied, NaN, zero-score
and repeated-probe data; the route predicate and the wrapper's staging
rows; and search_batch(mode="certified") over bf16 slabs at topk 65 (pool
260, widening to 520 and 1,040) and mode="ivf_block" at topk 300 against
the JAX package on the same numpy inputs (its Pallas scan in interpret
mode on the CPU, as tests/test_torch_ivf.py runs it).

Tolerances: the model and the plain version agree in every bit; served
scores agree with the JAX package's within 1e-6 (the products sum in other
orders) and served ids are equal (certified serving's rescored top-65:
equal outside near-ties of 1e-6, where the two packages' float32 sums may
order two candidates either way)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _ivf_wide_model as model
import pyarrowspace_tpu as jx
import pyarrowspace_tpu_torch as pt
from pyarrowspace_tpu_torch.ops import ivf_scan as tis
from pyarrowspace_tpu_torch.ops.cuda import ivf_scan as k6
from pyarrowspace_tpu_torch.ops.cuda.compare import topk_disagreements

TOL = 1e-6
TAU = 0.62
NEG = model.NEG


# -- the model against the plain version -----------------------------------

def _tied(rng, n, f):
    """Rows with four entries of +-0.5: unit norm, exact products, ties at
    every rank and orthogonal pairs (cosine +0.0)."""
    x = np.zeros((n, f), np.float32)
    for r in range(n):
        x[r, rng.choice(f, size=4, replace=False)] = rng.choice([-.5, .5], 4)
    return x


def _case(data, qb, n_blocks=3, n_clusters=12, cap=256, n_probe=6, f=16):
    """Tied slabs with a share of padding rows, the last cluster all
    padding (tiles 0) and probed by every block, ids distinct and shuffled.
    "ties": lambdas on a grid of 0.25, tau 0.5; "zeros": item lambdas
    +inf at tau 1.5 (tau cos + (1 - tau) 0: the orthogonal items tie at
    +0.0); "nan": lambdas +inf on a third of the items and on query 1 (NaN
    scores: its list runs short); "repeat": tau 0.5, each block's probe
    row names one cluster twice."""
    rng = np.random.default_rng({"ties": 1, "zeros": 2, "nan": 3,
                                 "repeat": 4}[data] + qb)
    rows = n_clusters * cap
    slabs = _tied(rng, rows, f)
    ids = rng.permutation(3 * rows)[:rows].astype(np.int32)
    ids[rng.uniform(size=rows) > 0.8] = -1
    ids[(n_clusters - 1) * cap:] = -1
    lam = rng.choice([0.25, 0.5, 0.75], rows).astype(np.float32)
    qn = _tied(rng, n_blocks * qb, f)
    lamq = rng.choice([0.25, 0.5], n_blocks * qb).astype(np.float32)
    tau = {"ties": 0.5, "zeros": 1.5, "nan": TAU, "repeat": 0.5}[data]
    if data == "zeros":
        lam[:] = np.inf
    if data == "nan":
        lam[np.arange(rows) % 3 == 0] = np.inf
        lamq[1] = np.inf
    lam[ids < 0] = np.inf
    probe = np.stack([np.concatenate([[n_clusters - 1], rng.permutation(
        n_clusters - 1)[:n_probe - 1]]) for _ in range(n_blocks)])
    if data == "repeat":
        probe[:, -1] = probe[:, 1]
    probe = probe.astype(np.int32)
    tiles = k6.slab_tiles(torch.from_numpy(ids), cap).numpy()
    return slabs, lam, ids, qn, lamq, probe, tau, cap, tiles


def _plain(case, k, qb):
    slabs, lam, ids, qn, lamq, probe, tau, cap, tiles = case
    t = [torch.from_numpy(a) for a in (slabs, lam, ids, qn, lamq, probe)]
    s, i = k6.ivf_scan_plain(*t, tau, k=k, q_block=qb, cap=cap,
                             tiles=torch.from_numpy(tiles))
    return s.numpy(), i.numpy()


@pytest.mark.parametrize("k", [257, 300, 1040])
@pytest.mark.parametrize("qb", [8, 16])
@pytest.mark.parametrize("data", ["ties", "zeros", "nan", "repeat"])
def test_k6_wide_model_equals_plain(data, qb, k):
    case = _case(data, qb)
    slabs, lam, ids, qn, lamq, probe, tau, cap, tiles = case
    assert tiles[-1] == 0 and np.all(probe[:, 0] == len(tiles) - 1)
    ms, mi, merges = model.scan(slabs, lam, ids, qn, lamq, probe, tau, k, qb,
                                cap, tiles)
    ps, pi = _plain(case, k, qb)
    np.testing.assert_array_equal(mi, pi)
    assert ms.view(np.uint32).tolist() == ps.view(np.uint32).tolist()
    assert not np.isnan(ms).any() and np.all((mi < 0) == (ms == NEG))
    # A merge takes 257 to 512 staged keys, the last one at least one.
    walked = np.array([(ids[model.walk(p, tiles, cap)] >= 0).sum()
                       for p in probe for _ in range(qb)])
    assert np.all(merges >= 1) and np.all(merges <= walked // 257 + 1)
    if data == "nan" and k == 1040:         # NaN never enters: short lists
        assert (mi[1] < 0).any()
    if data == "zeros" and k == 1040:       # the kth among the +0.0 ties
        zero = ms == 0
        assert zero.any() and not np.signbit(ms[zero]).any()
    if data == "repeat":                    # the repeated cluster's rows
        assert any(len(np.unique(r[r >= 0])) < (r >= 0).sum() for r in mi)
    if k == 300:                            # a prefix of the 256 list
        ns, ni = _plain(case, 256, qb)
        np.testing.assert_array_equal(mi[:, :256], ni)
        assert ms[:, :256].view(np.uint32).tolist() == \
            ns.view(np.uint32).tolist()


def test_k6_wide_model_keeps_signed_zeros():
    """The kernel's blend never yields -0.0 (its product chain starts at
    +0.0, so tau cos and (1 - tau) prox are never both -0.0), but its keys
    keep one: injected +-0.0 scores tie by id and come back with their own
    sign bits, as the plain version's stable sorts keep them."""
    rng = np.random.default_rng(9)
    w = 6 * model.STEP
    scores = rng.choice(np.array([0.5, 0.0, -0.0, -0.25, np.nan],
                                 np.float32), w)
    ids = rng.permutation(4 * w)[:w].astype(np.int32)
    ids[-100:] = -1
    scores[-100:] = NEG
    for k in (257, 700, 1500):
        lv, li, _ = model.wide_list(scores, ids, k)
        real = np.flatnonzero((ids >= 0) & ~np.isnan(scores))
        order = sorted(real, key=lambda j: (-float(scores[j]), ids[j]))[:k]
        n = len(order)
        np.testing.assert_array_equal(li[:n], ids[order])
        assert lv[:n].view(np.uint32).tolist() == \
            scores[order].view(np.uint32).tolist()
        assert np.all(li[n:] == -1) and np.all(lv[n:] == NEG)
    assert np.signbit(lv[lv == 0]).any() and (~np.signbit(lv[lv == 0])).any()


# -- the route and the staging rows ----------------------------------------

@pytest.mark.parametrize("k", [1, 15, 64, 65, 128, 129, 256, 257, 260,
                               1040, 4096])
def test_route_name_at_the_narrow_limit(k):
    """Narrow lists up to 256 (csrc/ivf_scan.cu asserts they fit beside
    the stages at every block width), wide past it."""
    assert k6.route_name(k) == ("narrow" if k <= 256 else "wide")


@pytest.mark.parametrize("k,qb,wide", [(256, 16, False), (257, 16, True),
                                       (1040, 32, True), (15, 8, False)])
def test_staging_rows(k, qb, wide):
    """The wide route's staging rows: SROW (512) 8-byte keys a query, 4
    KB, allocated by the wrapper on the scan's device; none for narrow
    lists."""
    rows = k6.staging_rows(4 * qb, k, torch.device("cpu"))
    if not wide:
        assert rows is None
        return
    assert rows.shape == (4 * qb, k6.SROW) and rows.dtype == torch.int64
    assert rows.element_size() * rows.shape[1] == 4096
    assert k6.SROW == model.SROW


def test_wide_scan_on_cpu_is_the_plain_version():
    """On CPU tensors the wrapper runs the plain version at any k, and
    refuses a merge count (the kernel's measurement, on the card only)."""
    case = _case("ties", 8)
    slabs, lam, ids, qn, lamq, probe, tau, cap, tiles = case
    t = [torch.from_numpy(a) for a in (slabs, lam, ids, qn, lamq, probe)]
    tt = torch.from_numpy(tiles)
    launches = k6.WIDE_LAUNCHES
    s, i = k6.ivf_scan(*t, tau, k=300, q_block=8, cap=cap, tiles=tt)
    ps, pi = _plain(case, 300, 8)
    assert np.array_equal(i.numpy(), pi) and np.array_equal(s.numpy(), ps)
    assert k6.WIDE_LAUNCHES == launches
    with pytest.raises(ValueError, match="merges"):
        k6.ivf_scan(*t, tau, k=300, q_block=8, cap=cap, tiles=tt,
                    merges=torch.zeros(24, dtype=torch.int32))


# -- serving at these pools against the JAX package ------------------------

GP = {"eps": 0.9, "k": 6, "topk": 10, "p": 2.0, "sigma": 0.3}


@pytest.fixture(scope="module")
def spaces():
    """4,096 rows of 16 tight components of 128 and 4 of 512 (F 16), built
    by the port on the CPU, the same state carried into the JAX package;
    both clustered by enable_ivf(n_clusters=64) over bf16 slabs (cap 128).
    A block of queries from a small component certifies at n_probe 4 (pool
    260); one from a large component only at 16 (pool 1,040)."""
    rng = np.random.default_rng(5)
    sizes = [128] * 16 + [512] * 4
    base = rng.normal(size=(len(sizes), 16)) * 2.0
    items = (base[np.repeat(np.arange(len(sizes)), sizes)]
             + 0.25 * rng.normal(size=(sum(sizes), 16)))
    ta, tg = pt.ArrowSpaceBuilder.build(GP, items, device="cpu")
    ja = jx.ArrowSpace._from_build(
        data=jnp.asarray(ta._data.numpy()),
        data_unit=jnp.asarray(ta._data_unit.numpy()),
        lambdas=jnp.asarray(ta._lambdas.numpy()),
        e_raw=jnp.asarray(ta._e_raw.numpy()),
        lap_f=jnp.asarray(ta._lap_f.numpy()),
        w_f=jnp.asarray(ta._w_f.numpy()),
        tau_star=jnp.asarray(ta._tau_star.numpy()),
        params=jx.GraphParams(**GP))
    queries = np.concatenate([items[rng.choice(128, 8, replace=False)],
                              items[2048 + rng.choice(512, 8,
                                                      replace=False)]]) * 1.02
    return ta, tg, ja, queries


def test_certified_bf16_topk65_matches_jax(spaces, monkeypatch):
    """Certified serving over bf16 slabs at topk 65 from n_probe 4: the
    base pool of 260, then widening rounds at pools 520 and 1,040 (all
    wide on the card) that certify the large component's block; scores
    within 1e-6 of the JAX package's, ids equal outside near-ties of
    1e-6."""
    ta, tg, ja, queries = spaces
    ta.enable_ivf(n_clusters=64, slab_dtype=torch.bfloat16)
    ja.enable_ivf(n_clusters=64, slab_dtype=jnp.bfloat16)
    assert ta._ensure_ivf_blocked().cap == 128
    pools = []
    scan = tis.ivf_scan

    def spy(*args, **kw):
        pools.append(kw["k"])
        return scan(*args, **kw)

    monkeypatch.setattr(tis, "ivf_scan", spy)
    ti, tv = ta.search_batch(queries, tg, TAU, topk=65, mode="certified",
                             n_probe=4, n_widen=2)
    ji, jv = ja.search_batch(queries, None, TAU, topk=65, mode="certified",
                             n_probe=4, n_widen=2)
    assert pools == [260, 520, 1040]
    assert all(k6.route_name(k) == "wide" for k in pools)
    ji, jv = np.asarray(ji), np.asarray(jv, np.float64)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=TOL)
    assert topk_disagreements(tv, ti, jv, ji, TOL) == []
    _, _, cert = ta.search_batch(queries, tg, TAU, topk=65,
                                 mode="ivf_block", n_probe=16, certify=True,
                                 m_pool=1040)
    assert cert.all()


def test_ivf_block_topk300_matches_jax(spaces):
    """ivf_block at topk 300 (n_probe 8 over float32 slabs: lists past
    256, wide on the card): ids equal the JAX package's, scores within
    1e-6."""
    ta, tg, ja, queries = spaces
    ta.enable_ivf(n_clusters=64)
    ja.enable_ivf(n_clusters=64)
    ti, tv = ta.search_batch(queries, tg, TAU, topk=300, mode="ivf_block",
                             n_probe=8)
    ji, jv = ja.search_batch(queries, None, TAU, topk=300,
                             mode="ivf_block", n_probe=8)
    assert ti.shape == (16, 300)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(tv, np.asarray(jv, np.float64), rtol=0,
                               atol=TOL)
