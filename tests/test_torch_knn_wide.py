"""K1's and K1t's lists past 128 entries (the wide route of
csrc/knn_wide.cuh) on the CPU: the route's split planner; the port's k-NN
at k 129 to 300 under every ARROWSPACE_KNN_VARIANT against the JAX package
(its Pallas variants in interpret mode on tie-free data, its XLA scan on
tied data); the (distance, id) order with +-0.0 distances; and a numpy
model of the route (survivors buffered, staged, sorted and merged into
partial lists by the kernel's in-place pass, the splits filtering against
a shared bound, split lists merged into the seed) bit for bit the plain
version.  Inputs are made with numpy from a seed and
handed to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyarrowspace_tpu.ops.distance import knn_graph_candidates as jax_knn
from pyarrowspace_tpu.ops.distance import unit_normalize as jax_unit
from pyarrowspace_tpu.ops.pallas.knn import knn_graph_candidates_pallas
from pyarrowspace_tpu_torch.ops.cuda import knn, scan_topk
from pyarrowspace_tpu_torch.ops.distance import (VARIANTS,
                                                 knn_graph_candidates,
                                                 unit_normalize)

SMS = 132          # the H100's SMs
TILE, BUF, STAGE = 128, 128, 896   # the route's tile, buffer and staging
WIDE_KS = (129, 200, 300)


def _tie_free(seed):
    """Corpora of tests/test_graph.py's variant tests, 300 x 32 N(0, 1) rows
    (eps 0.9 masks the d = 1.0 plateau, so distances are tie-free).  Not
    its clustered corpus: at k >= 129 its lists reach distances closer than
    the two packages' products round apart, and such near-ties may trade
    places."""
    return np.random.default_rng(seed).normal(size=(300, 32)).astype(
        np.float32)


def _tied(n=400, f=16):
    """Rows with four entries of +-0.5, half of them duplicated: exact
    distance ties at every rank, the d = 1.0 plateau kept (eps >= 1)."""
    rng = np.random.default_rng(3)
    x = np.zeros((n, f))
    for r in range(n):
        x[r, rng.choice(f, size=4, replace=False)] = rng.choice([-.5, .5], 4)
    x[n // 2:] = x[:n - n // 2]
    return x.astype(np.float32)


# -- the split planner -----------------------------------------------------

@pytest.mark.parametrize("rows,n_cols,k", [
    (1, 300, 129), (130, 6000, 5000), (300, 900, 200), (2048, 313_841, 1024),
    (2048, 313_841, 200), (8, 313_841, 5000), (9416, 323_257, 200),
    (16_384, 313_841, 200), (313_841, 313_841, 129),
    (313_841, 313_841, 5000), (1_000_000, 1_000_000, 1024)])
def test_plan_splits_keeps_every_split_and_the_cap(monkeypatch, rows,
                                                    n_cols, k):
    """Every split holds a tile (the C launcher checks it), and the partial
    lists [splits, rows a launch, k] of 8 bytes, with a wide list's staging
    rows of 896 keys, fit the scratch cap."""
    monkeypatch.setattr(knn, "sm_count", lambda index: SMS)
    splits, chunk = knn.plan_splits(rows, n_cols, k, torch.device("cuda", 0))
    n_tiles = -(-n_cols // TILE)
    per_split = -(-n_tiles // splits)
    assert 1 <= splits <= n_tiles
    assert (splits - 1) * per_split < n_tiles
    assert 1 <= chunk <= rows
    staged = 896 if k > knn.WIDE_K else 0
    assert splits * min(rows, chunk) * 8 * (k + staged) <= \
        scan_topk.SCRATCH_BYTES


@pytest.mark.parametrize("rows,k,want", [
    (16_384, 200, 1), (65_536, 300, 1), (2048, 1024, 8), (2048, 200, 8),
    (1024, 300, 15), (16_384, 128, 1), (2048, 128, 8), (2048, 5, 8),
    (9416, 25, 5)])
def test_plan_splits_one_split_once_blocks_fill_a_wave(monkeypatch, rows, k,
                                                       want):
    """One split when the 128-row blocks fill a wave (16,384 rows: 128
    blocks, 97% of 132 SMs), more when they leave SMs idle (2,048 rows: 16
    blocks, 8 splits; the extend's 9,416 new rows: 74 blocks, 5 splits);
    narrow lists (k <= 128) split only where the kernel takes splits (K1,
    not K1t)."""
    monkeypatch.setattr(knn, "sm_count", lambda index: SMS)
    dev = torch.device("cuda", 0)
    assert knn.plan_splits(rows, 313_841, k, dev) == (want, rows)
    route = "narrow" if k <= knn.WIDE_K else "wide"
    assert knn.route_name(rows, 313_841, k, dev) == f"{route}/S{want}"
    if k <= knn.WIDE_K:
        assert knn.plan_splits(rows, 313_841, k, dev, narrow=False) == \
            (1, rows)


def test_plan_splits_chunks_rows_past_the_cap(monkeypatch):
    """313,841 rows at k 5,000 would take 12.6 GB of partial lists: one
    split, rows in launches of at most 1 GiB of lists and staging rows."""
    monkeypatch.setattr(knn, "sm_count", lambda index: SMS)
    splits, chunk = knn.plan_splits(313_841, 313_841, 5000,
                                    torch.device("cuda", 0))
    assert splits == 1
    assert chunk == scan_topk.SCRATCH_BYTES // (8 * (5000 + 896)) < 313_841


# -- the port against the JAX package at k 129 to 300 ------------------------

@pytest.mark.parametrize("seed", [57, 58])
@pytest.mark.parametrize("k", WIDE_KS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_wide_k_matches_pallas_interpret(seed, k, variant, monkeypatch):
    """Ids exact, distances within 1e-6 (the two products sum in different
    orders)."""
    monkeypatch.setenv("ARROWSPACE_KNN_SUB", "64")
    x = _tie_free(seed)
    d_ref, i_ref = knn_graph_candidates_pallas(
        jax_unit(jnp.asarray(x)), k, 0.9, interpret=True, variant=variant)
    d, i = knn_graph_candidates(unit_normalize(torch.from_numpy(x)), k, 0.9,
                                variant=variant)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("k", WIDE_KS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_wide_k_on_ties_matches_xla_scan(k, variant):
    """Tied data against the JAX package's XLA scan (not its Pallas merge,
    which evicts the smaller id at a kth tie): ids exact, and the distances,
    exact in float32 on these rows, equal."""
    x = _tied()
    d_ref, i_ref = jax_knn(jnp.asarray(x), k, 1.0)
    d, i = knn_graph_candidates(torch.from_numpy(x), k, 1.0, variant=variant)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))


# -- the (distance, id) order and a model of the route ----------------------

def _key(d, i):
    """The route's ascending key of (d, id): select.cuh's order_key of d
    (-0.0 folded into +0.0, NaN key 0) above the id with its sign bit
    flipped."""
    d = np.asarray(d, np.float32)
    b = d.view(np.uint32).copy()
    b[d == 0] = 0
    b = np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)
    b[np.isnan(d)] = 0
    lo = (np.asarray(i, np.int64) & 0xFFFFFFFF) ^ 0x80000000
    return (b.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def _merge_into(ld, li, sk, sd, si, u_=4):
    """merge_into: the m sorted src entries (keys sk) into the sorted list
    (ld, li) in place, in windows of 32 U slots from the top down, slot
    g + 32 u + l held by lane l, stopping below the first slot that
    changes.  A window is read before it is written, as the kernel's lanes
    read it one window ahead; the src entries below a window's first slot
    are written with the window below."""
    k, m, win = len(ld), len(sk), 32 * u_
    if m == 0:
        return
    g = (k - 1) // win * win
    pend = m
    while True:
        j = g + np.arange(win)              # slot of (u, lane), u-major
        inside = j < k
        jj = np.minimum(j, k - 1)
        e_d, e_i = ld[jj].copy(), li[jj].copy()
        hi = np.where(inside, np.searchsorted(sk, _key(e_d, e_i), "left"), m)
        top = int(hi[0])
        lo = np.concatenate([[0], hi[:-1]])  # the slot below's count
        lo[0] = 0 if g == 0 else hi[0]       # deferred to the next window
        for t in range(win):
            if inside[t] and j[t] + hi[t] < k:
                ld[j[t] + hi[t]], li[j[t] + hi[t]] = e_d[t], e_i[t]
            for s in range(lo[t], hi[t]):
                if s + j[t] < k:
                    ld[s + j[t]], li[s + j[t]] = sd[s], si[s]
        for s in range(hi[-1], pend):
            if s + g + win < k:
                ld[s + g + win], li[s + g + win] = sd[s], si[s]
        if top == 0 or g == 0:
            return
        pend = top
        g -= win


@pytest.mark.parametrize("k", [1, 31, 32, 127, 128, 129, 257, 1024])
@pytest.mark.parametrize("m", [1, 5, 128, 300])
def test_merge_model_keeps_the_k_least(k, m):
    """The in-place pass on lists ending in empty entries, distances tied
    at every value, every window size edge: the k least of list and src by
    (distance, id)."""
    rng = np.random.default_rng(1000 * k + m)
    ids = rng.permutation(4 * (k + m)).astype(np.int32)
    vals = np.array([0.0, 0.25, 0.5, 0.75], np.float32)
    n_real = k - int(rng.integers(0, k // 3 + 1))
    ld = np.concatenate([rng.choice(vals, n_real),
                         np.full(k - n_real, 2.0, np.float32)])
    li = np.concatenate([ids[:n_real], np.full(k - n_real, -1, np.int32)])
    order = np.argsort(_key(ld, li), kind="stable")
    ld, li = ld[order], li[order]
    sd, si = rng.choice(vals, m), ids[k:k + m]
    order = np.argsort(_key(sd, si), kind="stable")
    sd, si = sd[order], si[order]
    want = np.argsort(_key(np.concatenate([ld, sd]), np.concatenate([li, si])),
                      kind="stable")[:k]
    want_d, want_i = np.concatenate([ld, sd])[want], np.concatenate(
        [li, si])[want]
    _merge_into(ld, li, _key(sd, si), sd, si)
    np.testing.assert_array_equal(li, want_i)
    np.testing.assert_array_equal(ld, want_d)


def _flush(ld, li, keys):
    keys = sorted(keys, key=lambda e: e[0])
    _merge_into(ld, li, np.array([e[0] for e in keys], np.uint64),
                np.array([e[1] for e in keys], np.float32),
                np.array([e[2] for e in keys], np.int32))


def _route_model(drow, ids, k, tiles, splits, seed=None):
    """One row through both launches: its walk of 128-column tiles (tiles:
    column offsets in walk order) cut into `splits` ranges, run one after
    another.  Per range, each tile's survivors against the filter (the
    partial list's kth, or the lowest kth any range has reached when that
    is lower) go to a buffer of 128; a buffer that cannot take them spills
    to a staging row of about k keys (128 to 896), and a staging row that
    could not take another spill is merged, with the buffer, into the
    partial list at the end of the tile (sorted, one in-place pass), as is
    what is left at the end of the range.  Then the partial lists are merged, in split order, into the
    seed (or empty) list."""
    per = -(-len(tiles) // splits)
    cap = min(STAGE, max(BUF, k // BUF * BUF))
    out_d = np.full(k, 2.0, np.float32) if seed is None else seed[0].copy()
    out_i = np.full(k, -1, np.int32) if seed is None else seed[1].copy()
    parts, bound = [], _key(np.float32(2.0), -1)
    for s in range(splits):
        ld, li = np.full(k, 2.0, np.float32), np.full(k, -1, np.int32)
        buf, staged = [], []
        for c0 in tiles[s * per:(s + 1) * per]:
            thr = min(_key(ld[k - 1], li[k - 1]), bound)
            surv = [(_key(drow[c], ids[c]), drow[c], ids[c])
                    for c in range(c0, min(c0 + TILE, len(drow)))
                    if _key(drow[c], ids[c]) < thr]
            due = False
            if surv and len(buf) + len(surv) > BUF:
                staged += buf
                buf = []
                due = len(staged) > cap - BUF
            buf += surv
            if due:
                _flush(ld, li, staged + buf)
                buf, staged = [], []
                bound = min(bound, _key(ld[k - 1], li[k - 1]))
        if staged or buf:
            _flush(ld, li, staged + buf)
            bound = min(bound, _key(ld[k - 1], li[k - 1]))
        parts.append((ld, li))
    for ld, li in parts:
        sk = _key(ld, li)
        m = int(np.searchsorted(sk, _key(out_d[-1:], out_i[-1:]), "left")[0])
        _merge_into(out_d, out_i, sk[:m], ld[:m], li[:m])
    return out_d, out_i


def _masked(xu, rows, col_start=0, perm=None):
    """The plain version's masked distances of rows against the columns
    [col_start, N) (or, with perm, of the permuted corpus's rows against
    its columns, as the kernel walks them), and the ids they are offered
    under."""
    n = xu.shape[0]
    cos = knn._cosines(xu[rows], xu, col_start, 256)
    d = (1.0 - torch.clamp_min(cos, 0.0)).numpy()
    cols = np.arange(col_start, n)
    d[cols[None, :] == np.asarray(rows)[:, None]] = 2.0
    ids = cols if perm is None else perm[cols]
    return d, ids


@pytest.mark.parametrize("k", WIDE_KS + (1024,))
@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("data,n", [("tied", 700), ("unit", 700),
                                    ("unit", 2500)])
def test_route_model_equals_plain(k, splits, data, n):
    """At 2,500 columns a range's first tiles fill the staging row (at k
    1,024, 896 keys), which is merged mid-walk."""
    x = _tied(n) if data == "tied" else np.random.default_rng(k).normal(
        size=(n, 24)).astype(np.float32)
    xu = unit_normalize(torch.from_numpy(x))
    rows = np.array([0, 5, 129, 350, n - 1])
    eps = 1.0
    d, ids = _masked(xu, rows)
    d[d > eps] = 2.0
    tiles = list(range(0, n, TILE))
    dp, ip = knn.knn_plain(xu, k, eps, torch.from_numpy(rows))
    for r in range(len(rows)):
        md, mi = _route_model(d[r], ids, k, tiles, splits)
        np.testing.assert_array_equal(mi, ip[r].numpy())
        assert md.view(np.uint32).tolist() == \
            dp[r].numpy().view(np.uint32).tolist()


@pytest.mark.parametrize("option", ["seeded", "diag_start", "perm"])
def test_route_model_options_equal_plain(option):
    """The options at k 200 on tied rows: a seed list merged first (ids
    below col_start), a rotated walk (its tiles from the row block's own),
    a permuted corpus offering the original ids."""
    k, eps, n = 200, 1.0, 700
    x = _tied(n)
    xu = unit_normalize(torch.from_numpy(x))
    rows = np.array([2, 300, 440 if option == "seeded" else 650])
    if option == "seeded":
        c = 450
        seed = knn.knn_plain(xu[:c], k, eps, torch.from_numpy(rows))
        d, ids = _masked(xu, rows, col_start=c)
        tiles = list(range(0, n - c, TILE))
        want = knn.knn_plain(xu, k, eps, torch.from_numpy(rows))
    elif option == "perm":
        perm = np.random.default_rng(0).permutation(n)
        xp = xu[torch.from_numpy(perm)]
        # Rows of the permuted corpus whose original ids are `rows`.
        rows_p = np.argsort(perm)[rows]
        d, ids = _masked(xp, rows_p, perm=perm)
        tiles = list(range(0, n, TILE))
        want = knn.knn_plain(xu, k, eps, torch.from_numpy(rows))
    else:
        d, ids = _masked(xu, rows)
        want = knn.knn_plain(xu, k, eps, torch.from_numpy(rows))
    d[d > eps] = 2.0
    for r in range(len(rows)):
        if option == "diag_start":
            n_tiles = -(-n // TILE)
            t0 = (rows[r] // TILE) % n_tiles
            tiles = [((t0 + s) % n_tiles) * TILE for s in range(n_tiles)]
        sd = None
        if option == "seeded":
            sd = (seed[0][r].numpy(), seed[1][r].numpy())
        md, mi = _route_model(d[r], ids, k, tiles, 3, sd)
        np.testing.assert_array_equal(mi, want[1][r].numpy())
        np.testing.assert_array_equal(md, want[0][r].numpy())


def test_signed_zero_distances_tie_by_id():
    """+0.0 and -0.0 are one distance: the plain version orders them by id
    and keeps each value's bits, and the route's key, which folds -0.0 into
    +0.0, gives the same order.  A seed list holding (+0.0, 5) and (-0.0,
    9), then a duplicate row's +0.0 at a new column, id 12."""
    x = np.zeros((16, 4), np.float32)
    x[:, 0] = 1.0
    x[1:, 1] = np.linspace(0.1, 1.5, 15)
    x[12] = x[0]                         # d(0, 12) = +0.0
    xu = unit_normalize(torch.from_numpy(x))
    k = 6
    seed_d = torch.tensor([[0.0, -0.0, 2.0, 2.0, 2.0, 2.0]])
    seed_i = torch.tensor([[5, 9, -1, -1, -1, -1]], dtype=torch.int32)
    d, i = knn.knn_plain(xu, k, 1.0, slice(0, 1), col_start=10,
                         seed=(seed_d, seed_i))
    assert i[0, :3].tolist() == [5, 9, 12]
    assert [np.signbit(v) for v in d[0, :3].numpy()] == [False, True, False]
    vals = np.array([0.0, -0.0, 0.0, 0.25], np.float32)
    order = np.argsort(_key(vals, np.array([12, 9, 5, 1])), kind="stable")
    assert order.tolist() == [2, 1, 0, 3]
    assert _key(np.float32(-0.0), 3) == _key(np.float32(0.0), 3)
    assert _key(np.float32(np.nan), 3) < _key(np.float32(-np.inf), 3)
