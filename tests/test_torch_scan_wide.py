"""K2's and K7's lists past their narrow limits on the CPU: the descending
key of csrc/knn_wide.cuh (score descending, id ascending, -0.0 equal to
+0.0 and kept), numpy models of the two wide routes (K2: survivors
buffered, staged, sorted and merged into partial lists, the splits
filtering against a shared bound, the split lists merged in split order;
K7: survivors staged by query, each staging row sorted and merged when it
could not take another tile) bit for bit the plain versions, the split
planners with a wide list's staging rows, and search_batch at those list
lengths against the JAX package on the same numpy inputs (its Pallas
scans in interpret mode, as its own tests run them)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyarrowspace_tpu as jx
import pyarrowspace_tpu_torch as pt
from pyarrowspace_tpu.ops.pallas.scan_topk import (lambda_search_pallas,
                                                   lambda_search_quantized)
from pyarrowspace_tpu_torch.ops.cuda import scan_int8, scan_topk
from pyarrowspace_tpu_torch.ops.distance import unit_normalize

NEG = np.float32(-3e38)
TILE, BUF, STAGE = 128, 128, 896   # K2's tile, buffer and staging (cap)
SROW = scan_int8._SROW              # K7's staging row (keys)
TOL = 1e-6
M32 = np.uint64(0xFFFFFFFF)


# -- the descending key ----------------------------------------------------

def _order_key(v):
    """select.cuh's order_key: -0.0 folded into +0.0, NaN key 0."""
    v = np.asarray(v, np.float32)
    b = v.view(np.uint32).copy()
    b[v == 0] = 0
    b = np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)
    b[np.isnan(v)] = 0
    return b


def _dkey(s, ids):
    """The descending key: ~order_key(s) << 32 | id << 1 | (s is -0.0)."""
    s = np.atleast_1d(np.asarray(s, np.float32))
    ids = np.atleast_1d(np.asarray(ids, np.int64)).astype(np.uint64)
    hi = (~_order_key(s)).astype(np.uint64)
    neg0 = (s.view(np.uint32) == 0x80000000).astype(np.uint64)
    return (hi << np.uint64(32)) | (((ids << np.uint64(1)) & M32) | neg0)


def _unkey(k):
    """(scores, ids) of descending keys: the score's own bits back."""
    k = np.atleast_1d(np.asarray(k, np.uint64))
    hi = (~(k >> np.uint64(32)) & M32).astype(np.uint32)
    bits = np.where(hi & 0x80000000, hi & 0x7FFFFFFF, ~hi).astype(np.uint32)
    lo = (k & M32).astype(np.uint32)
    bits = np.where(lo & 1, np.uint32(0x80000000), bits).astype(np.uint32)
    return bits.view(np.float32), (lo >> 1).astype(np.int32)


def test_desc_key_orders_by_score_then_id_and_keeps_the_bits():
    """Ascending keys are (score desc, id asc); -0.0 and +0.0 tie and fall
    to the id; every survivor's key decodes to its own score bits and id;
    NaN sorts past everything, the empty slot past every real score."""
    s = np.array([0.5, -0.0, 0.0, 0.0, -0.0, -1.5, np.inf, -np.inf, 3e38,
                  -2.9e38, 1e-45, -1e-45], np.float32)
    ids = np.array([9, 4, 7, 2, 11, 0, 30, 31, 5, 6, 8, 3])
    keys = _dkey(s, ids)
    order = np.argsort(keys, kind="stable")
    want = sorted(range(len(s)), key=lambda j: (-float(s[j]), ids[j]))
    assert order.tolist() == want
    v, i = _unkey(keys)
    assert v.view(np.uint32).tolist() == s.view(np.uint32).tolist()
    assert i.tolist() == ids.tolist()
    assert _dkey(np.float32(np.nan), 0)[0] > _dkey(NEG, -1)[0] \
        > _dkey(np.float32(-2.9e38), 2**31 - 1)[0]


# -- models of the two wide routes -----------------------------------------

def _better(v, i, tv, ti):
    """tile_common.cuh MaxLex: (v, i) strictly beats (tv, ti); NaN never."""
    return (v > tv) | ((v == tv) & (i < ti))


def _merge(lv, li, sk):
    """merge_into's result: the k least keys of the list and the sorted
    survivor keys sk (none equal to a list key), survivors decoded."""
    k = len(lv)
    sv, si = _unkey(sk)
    allv = np.concatenate([lv, sv])
    alli = np.concatenate([li, si])
    order = np.argsort(np.concatenate([_dkey(lv, li), sk]), kind="stable")
    lv[:], li[:] = allv[order[:k]], alli[order[:k]]


def _split_merge(parts, k):
    """Launch 2: empty entries, then each split's entries that beat the
    kth, in split order."""
    ov, oi = np.full(k, NEG, np.float32), np.full(k, -1, np.int32)
    for lv, li in parts:
        m = int(np.sum(_dkey(lv, li) < _dkey(ov[-1], oi[-1])[0]))
        _merge(ov, oi, np.sort(_dkey(lv[:m], li[:m])))
    return ov, oi


def _k2_route(row, k, splits):
    """One query of K2's wide route: its 128-item tiles cut into ranges
    (every range holding a tile), run one after another.  Per range, each
    tile's survivors against the filter (the partial list's kth, or the
    best kth any range has reached when that is better) go to a buffer of
    128; a buffer that cannot take them spills to a staging row of about k
    keys (128 to 896), and a staging row that could not take another spill
    is merged, with the buffer, at the end of the tile, as is what is left
    at the end of the range.  Then launch 2."""
    n_tiles = -(-len(row) // TILE)
    per = -(-n_tiles // splits)
    cap = min(STAGE, max(BUF, k // BUF * BUF))
    bound = _dkey(NEG, -1)[0]
    parts = []
    for s0 in range(0, n_tiles, per):
        lv, li = np.full(k, NEG, np.float32), np.full(k, -1, np.int32)
        tv, ti = NEG, -1
        buf, staged = [], []

        def flush():
            nonlocal buf, staged, tv, ti, bound
            _merge(lv, li, np.sort(np.array(staged + buf, np.uint64)))
            buf, staged = [], []
            if _better(lv[-1], li[-1], tv, ti):
                tv, ti = lv[-1], li[-1]
            bound = min(bound, _dkey(lv[-1], li[-1])[0])

        for t in range(s0, min(n_tiles, s0 + per)):
            ids = np.arange(t * TILE, min(len(row), (t + 1) * TILE))
            v = row[ids]
            keep = _better(v, ids, tv, ti)
            surv = list(_dkey(v[keep], ids[keep]))
            due = False
            if surv and len(buf) + len(surv) > BUF:
                staged += buf
                buf = []
                due = len(staged) > cap - BUF
            buf += surv
            if due:
                flush()
            bv, bi = _unkey(bound)
            if _better(bv[0], bi[0], tv, ti):
                tv, ti = bv[0], bi[0]
        if staged or buf:
            flush()
        parts.append((lv, li))
    return _split_merge(parts, k)


def _k7_route(row, k, splits, tile):
    """One query of K7's wide route: tiles of `tile` items (128 on the
    tensor-core route, 64 on the SIMT route) cut into ranges; per tile the
    survivors against the query's filter are staged, and a staging row of
    more than SROW - tile keys is sorted and merged; what is left at the
    end of the range too.  Then launch 2."""
    n_tiles = -(-len(row) // tile)
    per = -(-n_tiles // splits)
    bound = _dkey(NEG, -1)[0]
    parts = []
    for s0 in range(0, n_tiles, per):
        lv, li = np.full(k, NEG, np.float32), np.full(k, -1, np.int32)
        tv, ti = NEG, -1
        staged = []

        def flush():
            nonlocal staged, tv, ti, bound
            _merge(lv, li, np.sort(np.array(staged, np.uint64)))
            staged = []
            if _better(lv[-1], li[-1], tv, ti):
                tv, ti = lv[-1], li[-1]
            bound = min(bound, _dkey(lv[-1], li[-1])[0])

        for t in range(s0, min(n_tiles, s0 + per)):
            bv, bi = _unkey(bound)
            if _better(bv[0], bi[0], tv, ti):
                tv, ti = bv[0], bi[0]
            ids = np.arange(t * tile, min(len(row), (t + 1) * tile))
            v = row[ids]
            keep = _better(v, ids, tv, ti)
            staged += list(_dkey(v[keep], ids[keep]))
            assert len(staged) <= SROW
            if len(staged) > SROW - tile:
                flush()
        if staged:
            flush()
        parts.append((lv, li))
    return _split_merge(parts, k)


def _k2_scores(xu, lam, qn, lam_q, tau):
    """scan_plain's scores, the values K2 offers (its masked ids >= n lie
    past the row)."""
    cos = torch.from_numpy(qn) @ torch.from_numpy(xu).T
    tau_t = torch.tensor(tau, dtype=torch.float32)
    prox = 1.0 / (1.0 + torch.abs(torch.from_numpy(lam)[None, :]
                                  - torch.from_numpy(lam_q)[:, None]))
    return (tau_t * cos + (1.0 - tau_t) * prox).numpy()


def _tied(rng, n, f=16):
    """Rows with four entries of +-0.5: exact products, ties at every
    rank, and orthogonal pairs (cosine +0.0)."""
    x = np.zeros((n, f), np.float32)
    for r in range(n):
        x[r, rng.choice(f, size=4, replace=False)] = rng.choice([-.5, .5], 4)
    return x


def _k2_case(data):
    """3,000 items (24 tiles, the last one part masked ids >= n) and 6
    queries.  "ties": tied rows, lambdas on a grid of 0.25, tau 0.5.
    "zeros": the same rows at tau 1.0, so the orthogonal items tie at
    +0.0 (reached at k 1,024).  "nan": lambdas +inf on two items in three
    and on query 2 (NaN scores: its list runs short of k 1,024), tau
    0.62."""
    rng = np.random.default_rng(7)
    n = 2990
    xu = _tied(rng, n)
    qn = _tied(rng, 6)
    lam = rng.choice([0.25, 0.5, 0.75], n).astype(np.float32)
    lam_q = rng.choice([0.25, 0.5], 6).astype(np.float32)
    tau = {"ties": 0.5, "zeros": 1.0, "nan": 0.62}[data]
    if data == "nan":
        lam[np.arange(n) % 3 != 0] = np.inf
        lam_q[2] = np.inf
    return xu, lam, qn, lam_q, tau


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("k", [129, 257, 1024])
@pytest.mark.parametrize("data", ["ties", "zeros", "nan"])
def test_k2_route_model_equals_plain(data, k, splits):
    xu, lam, qn, lam_q, tau = _k2_case(data)
    ip, sp = scan_topk.scan_plain(*(torch.from_numpy(a) for a in
                                    (xu, lam, qn, lam_q)), tau, k)
    scores = _k2_scores(xu, lam, qn, lam_q, tau)
    for q in range(qn.shape[0]):
        mv, mi = _k2_route(scores[q], k, splits)
        np.testing.assert_array_equal(mi, ip[q].numpy())
        assert mv.view(np.uint32).tolist() == \
            sp[q].numpy().view(np.uint32).tolist()
    if data == "nan":
        assert int((ip[2] < 0).sum()) == max(0, k - (xu.shape[0] + 2) // 3)
    if data == "zeros" and k == 1024:     # the kth among the +0.0 ties
        assert bool((sp[:, -1] == 0).any())


def _k7_case():
    """Int8 rows: 1,000 zero rows (lambda +inf, row scale +-1 in turn: at
    tau 1.5 they score +0.0 or -0.0), the rest 100 rows repeated 20 times
    (exact ties), queries among those rows (a few high scores, then the
    zeros, then the ties); query 4's lambda is +inf (NaN on the zero rows:
    its list runs short past 2,000)."""
    rng = np.random.default_rng(5)
    n, f = 3000, 32
    base = rng.integers(-127, 128, (100, f)).astype(np.int8)
    xq = np.zeros((n, f), np.int8)
    zero = np.arange(n) % 3 == 0
    xq[~zero] = np.repeat(base, 20, axis=0)
    srow = np.full(n, 1.0 / 127, np.float32)
    srow[zero] = np.where(np.arange(zero.sum()) % 2 == 0, 1.0, -1.0)
    lam = rng.uniform(0, 1, n).astype(np.float32)
    lam[zero] = np.inf
    lam[~zero] = np.repeat(rng.uniform(0, 1, 100).astype(np.float32), 20)
    qq = base[[3, 17, 40, 41, 99]].copy()
    qscale = np.full(5, 1.0 / 127 / 127 / f, np.float32)
    lamq = rng.uniform(0, 1, 5).astype(np.float32)
    lamq[4] = np.inf
    return xq, srow, lam, qq, qscale, lamq


def _k7_scores(xq, srow, lam, qq, qscale, lamq, tau):
    """scan_int8_plain's scores."""
    acc = (qq.astype(np.float64) @ xq.astype(np.float64).T).astype(np.int32)
    cos = torch.from_numpy(acc).float() * torch.from_numpy(qscale)[:, None] \
        * torch.from_numpy(srow)[None, :]
    tau_t = torch.tensor(tau, dtype=torch.float32)
    prox = 1.0 / (1.0 + torch.abs(torch.from_numpy(lam)[None, :]
                                  - torch.from_numpy(lamq)[:, None]))
    return (tau_t * cos + (1.0 - tau_t) * prox).numpy()


@pytest.mark.parametrize("tile", [128, 64])
@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("k", [129, 257, 1024])
def test_k7_route_model_equals_plain(k, splits, tile):
    """Ties across the kth, +-0.0 scores, NaN scores and a short list, on
    both routes' tiles."""
    case = _k7_case()
    tau = 1.5
    ip, sp = scan_int8.scan_int8_plain(*(torch.from_numpy(a) for a in case),
                                       tau, k)
    scores = _k7_scores(*case, tau)
    for q in range(case[3].shape[0]):
        mv, mi = _k7_route(scores[q], k, splits, tile)
        np.testing.assert_array_equal(mi, ip[q].numpy())
        assert mv.view(np.uint32).tolist() == \
            sp[q].numpy().view(np.uint32).tolist()
    zeros = sp[:4] == 0
    assert bool(torch.signbit(sp[:4][zeros]).any()) and \
        bool((~torch.signbit(sp[:4][zeros])).any())
    assert int((ip[4] < 0).sum()) == max(0, k - 2000)


# -- the split planners and the route predicates ---------------------------

@pytest.mark.parametrize("n,q,k", [(313_841, 1024, 1024), (313_841, 4096, 200),
                                   (6000, 70, 5000), (1_000_000, 16_384, 200),
                                   (3000, 200, 500)])
def test_k2_wide_plan_counts_the_staging_rows(monkeypatch, n, q, k):
    """A wide list's scratch (lists, staging rows of 896 keys, bounds)
    stays within the cap; every split holds a tile; the route names it."""
    monkeypatch.setattr(scan_topk, "sm_count", lambda index: 132)
    dev = torch.device("cuda", 0)
    splits, chunk = scan_topk.plan_splits(n, q, k, dev)
    n_tiles = -(-n // TILE)
    assert (splits - 1) * -(-n_tiles // splits) < n_tiles
    assert splits * min(q, chunk) * 8 * (k + STAGE) <= \
        scan_topk.SCRATCH_BYTES
    assert scan_topk.route_name(n, q, k, dev) == f"wide/S{splits}"
    words = scan_topk.scratch_words(splits, min(q, chunk), k, STAGE)
    assert words == splits * min(q, chunk) * (k + STAGE) + min(q, chunk)
    if (n, q, k) == (313_841, 1024, 1024):
        assert (splits, chunk) == (15, 1024)
    if (n, q, k) == (313_841, 4096, 200):
        assert (splits, chunk) == (4, 4096)


@pytest.mark.parametrize("f,k,wide", [
    (384, 130, False), (384, 131, True), (768, 82, False), (768, 83, True),
    (1024, 50, False), (1024, 51, True), (16, 162, False), (16, 163, True),
    (384, 60, False), (768, 200, True), (384, 400, True)])
def test_k7_wide_lists_at_the_shared_memory_limit(f, k, wide):
    """The tensor-core route's lists go wide where 128 narrow lists no
    longer fit its shared memory beside two stages; the SIMT route's past
    256 only."""
    assert scan_int8.wide_lists(k, f, True) is wide
    assert scan_int8.wide_lists(k, f, False) is (k > 256)


@pytest.mark.parametrize("n,q,k,f", [(313_841, 4096, 200, 384),
                                     (313_841, 4096, 400, 384),
                                     (1_000_000, 16_384, 200, 768),
                                     (6000, 70, 5000, 384)])
def test_k7_wide_plan_counts_the_staging_rows(monkeypatch, n, q, k, f):
    monkeypatch.setattr(scan_int8, "sm_count", lambda index: 132)
    dev = torch.device("cuda", 0)
    for tc in (True, False):
        wide = scan_int8.wide_lists(k, f, tc)
        splits, chunk = scan_int8.plan_splits(n, q, k, dev, tc, wide)
        tile = 128 if tc else 64
        n_tiles = -(-n // tile)
        assert (splits - 1) * -(-n_tiles // splits) < n_tiles
        assert splits * min(q, chunk) * 8 * (k + SROW * wide) <= \
            scan_topk.SCRATCH_BYTES
    xq = torch.zeros((n, f), dtype=torch.int8)
    qq = torch.zeros((q, f), dtype=torch.int8)
    tc_splits = scan_int8.plan_splits(n, q, k, dev, True, True)[0]
    assert scan_int8.lists_name(xq, qq, k) == f"wide/S{tc_splits}"
    if (n, q) == (313_841, 4096):
        assert tc_splits == 4


# -- search_batch at these list lengths against the JAX package ------------

@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(21)
    centers = rng.normal(size=(6, 16)) * 2.0
    items = centers[rng.integers(0, 6, 700)] + rng.normal(size=(700, 16))
    gp = {"eps": 0.9, "k": 6, "topk": 8, "p": 2.0, "sigma": 0.4}
    return (items, jx.ArrowSpaceBuilder.build(gp, items),
            pt.ArrowSpaceBuilder.build(gp, items, device="cpu"))


@pytest.mark.parametrize("mode,topk", [("exact", 129), ("exact", 200),
                                       ("int8", 40), ("int8", 100)])
def test_search_batch_wide_matches_reference(built, mode, topk):
    """Exact serving at topk 129 and 200 (K2's wide lists), int8 serving
    at topk 40 and 100 (K7's pools of 160 and 400, wide on the card):
    served ids equal, scores within 1e-6 (the rescore's products sum in
    other orders)."""
    items, (ja, jg), (ta, tg) = built
    queries = items[np.random.default_rng(4).choice(700, 12)] * 1.01
    i, s = ta.search_batch(queries, tg, 0.62, topk=topk, mode=mode)
    i_ref, s_ref = ja.search_batch(queries, jg, 0.62, topk=topk, mode=mode)
    assert i.shape == (12, topk)
    np.testing.assert_array_equal(i, np.asarray(i_ref))
    np.testing.assert_allclose(s, np.asarray(s_ref), rtol=0, atol=TOL)


@pytest.mark.parametrize("topk", [129, 300])
def test_k2_plain_wide_matches_pallas_interpret(topk):
    """scan_plain at lists past 128 against the Pallas scan in interpret
    mode on tie-free data: ids equal, scores within 1e-6."""
    rng = np.random.default_rng(topk)
    x = rng.normal(size=(900, 24)).astype(np.float32)
    xu = unit_normalize(torch.from_numpy(x)).numpy()
    qn = unit_normalize(torch.from_numpy(
        rng.normal(size=(7, 24)).astype(np.float32))).numpy()
    lam = rng.uniform(0, 1, 900).astype(np.float32)
    lam_q = rng.uniform(0, 1, 7).astype(np.float32)
    i, s = scan_topk.scan_plain(*(torch.from_numpy(a) for a in
                                  (xu, lam, qn, lam_q)), 0.62, topk)
    i_ref, s_ref = lambda_search_pallas(
        jnp.asarray(xu), jnp.asarray(lam), jnp.asarray(qn),
        jnp.asarray(lam_q), jnp.float32(0.62), topk, interpret=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("cand_k", [160, 400])
def test_k7_plain_wide_matches_pallas_interpret(cand_k):
    """scan_int8_plain at pools of 160 and 400 against the Pallas int8
    scan in interpret mode (distinct rows: no ties on the kth)."""
    rng = np.random.default_rng(cand_k)
    x = rng.normal(size=(800, 32)).astype(np.float32)
    xu = unit_normalize(torch.from_numpy(x))
    qn = unit_normalize(torch.from_numpy(
        rng.normal(size=(5, 32)).astype(np.float32)))
    lam = rng.uniform(0, 1, 800).astype(np.float32)
    lam_q = rng.uniform(0, 1, 5).astype(np.float32)
    from pyarrowspace_tpu_torch.ops.quantize import quantize_rows
    xq, sc = quantize_rows(xu)
    i, s = scan_int8.lambda_search_quantized(
        xq, sc, torch.from_numpy(lam), qn, torch.from_numpy(lam_q), 0.62,
        cand_k)
    from pyarrowspace_tpu.ops.quantize import quantize_rows as jquantize
    jq, js = jquantize(jnp.asarray(xu.numpy()))
    i_ref, s_ref = lambda_search_quantized(
        jq, js, jnp.asarray(lam), jnp.asarray(qn.numpy()),
        jnp.asarray(lam_q), jnp.float32(0.62), cand_k, interpret=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=0,
                               atol=TOL)
