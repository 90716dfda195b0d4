"""K1's symmetric route (csrc/knn.cu, route "sym") on the CPU: a numpy model
of the route (tests/_knn_sym_model.py: the upper-triangle walk, transposed
merges delivered in a random order of blocks and steps, each column's
filter possibly stale, the two partial lists of a row merged at the end)
bit for bit against the port's plain version and against the JAX
package's XLA scan; and ``route_name``, the one place that picks the
route.  Inputs are made with numpy from a seed and handed to both
packages."""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _knn_sym_model import sym_lists, walk
from pyarrowspace_tpu.ops.distance import knn_graph_candidates as jax_knn
from pyarrowspace_tpu_torch.ops.cuda import knn, knn_t, scan_topk

SMS = 132          # the H100's SMs
DEV = torch.device("cuda", 0)   # route_name only reads its index


def _rows(data, n, f=16, seed=0):
    """Unit rows: "unit" N(0, 1); "tied" four entries of +-0.5 (products
    exact in any order, so distances tie exactly), a third of the rows
    duplicated (distance +0.0); "quantized" N(0, 1) rounded to halves and
    normalized, half of them duplicated."""
    rng = np.random.default_rng(seed)
    if data == "unit":
        x = rng.normal(size=(n, f))
    elif data == "tied":
        x = np.zeros((n, f))
        for r in range(n):
            x[r, rng.choice(f, size=4, replace=False)] = rng.choice(
                [-.5, .5], 4)
        x[n - n // 3:] = x[:n // 3]
    else:
        x = np.round(rng.normal(size=(n, f)) * 2) / 2
        x[:, 0] += 0.5
        x[n // 2:] = x[:n - n // 2]
    x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-30)
    return x


def _masked(xu: torch.Tensor, eps: float) -> np.ndarray:
    """The plain version's masked distances [n, n] in its own products
    (knn._cosines, bitwise symmetric), self and d > eps at 2.0."""
    n = xu.shape[0]
    cos = torch.cat([knn._cosines(xu[s:s + 256], xu, 0, 256 * -(-n // 256))
                     for s in range(0, n, 256)])
    d = (1.0 - torch.clamp_min(cos, 0.0)).numpy()
    assert np.array_equal(d, d.T)
    d[d > eps] = 2.0
    np.fill_diagonal(d, 2.0)
    return d


def _bits(a):
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 100])
@pytest.mark.parametrize("data", ["unit", "tied", "quantized"])
@pytest.mark.parametrize("tile", [8, 16])
def test_model_equals_plain(n, data, tile):
    """Ragged n around the tile width, exact ties and duplicated rows; k
    past n - 1 keeps empty entries; eps 0.9 masks part of each row."""
    xu = torch.from_numpy(_rows(data, n, seed=n)).float()
    for k, eps in ((3, 1.0), (12, 0.9)):
        d, i = sym_lists(_masked(xu, eps), k, tile, seed=n + k)
        dp, ip = knn.knn_plain(xu, k, eps)
        np.testing.assert_array_equal(i, ip.numpy())
        np.testing.assert_array_equal(_bits(d), _bits(dp.numpy()))


@pytest.mark.parametrize("seed", range(4))
def test_model_any_arrival_order(seed):
    """The blocks reach a tile in another order under each seed, so the
    filters go stale at other points: the lists stay the plain version's,
    ties at the kth going to the smaller id."""
    xu = torch.from_numpy(_rows("tied", 70, f=8, seed=3)).float()
    dist = _masked(xu, 1.0)
    dp, ip = knn.knn_plain(xu, 6, 1.0)
    d, i = sym_lists(dist, 6, 8, seed=seed)
    np.testing.assert_array_equal(i, ip.numpy())
    np.testing.assert_array_equal(_bits(d), _bits(dp.numpy()))


@pytest.mark.parametrize("n_tiles", [1, 2, 3, 13, 2452, 7813])
def test_walk_visits_each_tile_once_from_the_diagonal(n_tiles):
    """The kernel's strided walk: every block its tiles b .. n_tiles - 1
    once, its diagonal first."""
    for b in {0, 1, n_tiles // 2, n_tiles - 2, n_tiles - 1}:
        if not 0 <= b < n_tiles:
            continue
        tiles = walk(b, n_tiles)
        assert tiles[0] == b and sorted(tiles) == list(range(b, n_tiles))


@pytest.mark.parametrize("n_tiles", [2452, 7813])   # 313,841 and 1M rows
def test_walks_part_after_they_meet(n_tiles):
    """No two blocks walk in step, which would queue them on one tile's
    lock: over 600 steps, a pair of the first wave (132 blocks from step 0)
    or of a later one (block 132 + i starting at step i, as blocks start
    when others end; ascending walks would share every tile) shares a tile
    in at most one step in 16."""
    w = np.array([walk(b, n_tiles)[:732] for b in range(264)])
    steps = np.arange(132, 732)
    first = w[:132, 1:601]
    later = np.stack([w[132 + i, steps - i] for i in range(132)])
    for wave in (first, later):
        for a in range(131):
            shared = (wave[a + 1:] == wave[a]).sum(axis=1)
            assert shared.max() <= wave.shape[1] / 16
    ascending = np.stack([132 + i + steps - i for i in range(132)])
    assert (ascending == ascending[0]).all()


def test_model_signed_zero_distances_keep_their_bits():
    """+0.0 and -0.0 are one distance: a row's list orders them by id and
    keeps each value's bits, as the plain version's stable sort does
    (the kernel's distances are never -0.0; the key folds it anyway)."""
    n = 20
    rng = np.random.default_rng(9)
    dist = np.round(rng.uniform(0, 1, (n, n)) * 4).astype(np.float32) / 4
    dist = np.minimum(dist, dist.T)
    zero = rng.uniform(size=(n, n)) < 0.3
    dist[zero | zero.T] = 0.0
    neg = np.triu(rng.uniform(size=(n, n)) < 0.5, 1)
    dist[(neg | neg.T) & (dist == 0)] = -0.0
    np.fill_diagonal(dist, 2.0)
    d, i = sym_lists(dist, 7, 4, seed=1)
    order = np.argsort(dist, axis=1, kind="stable")[:, :7]
    np.testing.assert_array_equal(i, order)
    np.testing.assert_array_equal(
        _bits(d), _bits(np.take_along_axis(dist, order, axis=1)))
    assert np.signbit(d).any() and (d == 0).sum() > np.signbit(d).sum()


@pytest.mark.parametrize("n,data", [(9, "tied"), (100, "tied"),
                                    (100, "unit")])
def test_model_equals_xla_scan(n, data):
    """Against the JAX package's XLA scan in float64: ids exact, distances
    within 1e-9 (the model's products are numpy's).  Tied rows (exact
    products, so exact ties) or tie-free ones: duplicated rows of inexact
    products would tie in one package and differ by an ulp in the other."""
    x = _rows(data, n, seed=n + 1)
    k, eps = 10, 0.95
    d_ref, i_ref = jax_knn(jnp.asarray(x), k, eps)
    k_eff = max(1, min(k, n - 1))
    dist = 1.0 - np.maximum(x @ x.T, 0.0)
    dist = np.minimum(dist, dist.T)          # one value a pair, as K1's
    dist[dist > eps] = 2.0
    np.fill_diagonal(dist, 2.0)
    d, i = sym_lists(dist, k_eff, 16, seed=2)
    pad = k - k_eff
    d = np.pad(d, ((0, 0), (0, pad)), constant_values=2.0)
    i = np.pad(i, ((0, 0), (0, pad)), constant_values=-1)
    np.testing.assert_array_equal(i, np.asarray(i_ref))
    np.testing.assert_allclose(d, np.asarray(d_ref), rtol=0, atol=1e-9)


# -- route_name: the one place that picks the route --------------------------

@pytest.fixture
def sms(monkeypatch):
    monkeypatch.setattr(knn, "sm_count", lambda index: SMS)


@pytest.mark.parametrize("n,k", [(1, 1), (129, 25), (313_841, 25),
                                 (1_000_000, 25), (313_841, 128),
                                 (1_000_000, 128)])
def test_route_name_sym_for_the_whole_corpus(sms, n, k):
    assert knn.route_name(n, n, k, DEV) == "sym"
    assert 8 * knn.sym_words(n, k) <= scan_topk.SCRATCH_BYTES


@pytest.mark.parametrize("launch", [
    dict(row_count=16_384, n_cols=313_841),                    # a row range
    dict(row_count=313_000, n_cols=313_841, row_start=841),    # a row range
    dict(row_count=9_416, n_cols=313_841, row_start=304_425),  # new rows
    dict(row_count=304_425, n_cols=9_416, col_start=304_425,   # seeded old
         seeded=True),
    dict(row_count=313_841, n_cols=313_841, seeded=True),
    dict(row_count=313_841, n_cols=313_841, diag_start=True),
    dict(row_count=313_841, n_cols=313_841, diag_start=True, perm=True),
    dict(row_count=313_841, n_cols=313_841, k=129),            # wide lists
    dict(row_count=313_841, n_cols=313_841, symmetric=False),
    dict(row_count=313_841, n_cols=313_841, narrow=False),     # K1t
    # knn_visit's ring steps: kernel ids shifted by n_loc.
    dict(row_count=156_921, n_cols=156_921, row_start=156_921,
         col_start=156_921),
    dict(row_count=156_921, n_cols=156_920, col_start=156_921,
         seeded=True)])
def test_route_name_keeps_every_other_walk(sms, launch):
    launch = dict(launch)
    rows, cols = launch.pop("row_count"), launch.pop("n_cols")
    k = launch.pop("k", 25)
    narrow = launch.pop("narrow", True)
    route = knn.route_name(rows, cols, k, DEV, narrow, **launch)
    splits = knn.plan_splits(rows, cols, k, DEV, narrow)[0]
    assert route == f"{'narrow' if k <= knn.WIDE_K else 'wide'}/S{splits}"


def test_route_name_full_walk_when_the_scratch_does_not_fit(sms,
                                                            monkeypatch):
    n, k = 313_841, 25
    monkeypatch.setattr(knn, "SCRATCH_BYTES", 8 * knn.sym_words(n, k) - 1)
    assert knn.route_name(n, n, k, DEV) == "narrow/S1"
    monkeypatch.setattr(knn, "SCRATCH_BYTES", 8 * knn.sym_words(n, k))
    assert knn.route_name(n, n, k, DEV) == "sym"


def test_sym_fallback_past_the_scratch_cap_is_counted(sms, monkeypatch,
                                                      caplog):
    """A self-join whose transposed lists pass SCRATCH_BYTES (1,100,000 rows
    at k 128: 1.13 GB) keeps the full walk; walk_route counts it in
    SYM_FALLBACKS and logs it once.  Within the cap, or on any other walk,
    it counts nothing."""
    n, k = 1_100_000, 128
    assert 8 * knn.sym_words(n, k) > scan_topk.SCRATCH_BYTES
    monkeypatch.setattr(knn, "SYM_FALLBACKS", 0)
    monkeypatch.setattr(knn, "_SYM_FALLBACK_LOGGED", False)
    full = f"narrow/S{knn.plan_splits(n, n, k, DEV)[0]}"
    with caplog.at_level(logging.WARNING, logger=knn.__name__):
        assert knn.walk_route(n, n, k, DEV) == full
        assert knn.walk_route(n, n, k, DEV) == full
    assert knn.SYM_FALLBACKS == 2
    logged = [r for r in caplog.records if "SCRATCH_BYTES" in r.getMessage()]
    assert len(logged) == 1
    assert knn.walk_route(313_841, 313_841, 25, DEV) == "sym"
    assert knn.walk_route(16_384, 313_841, 25, DEV).startswith("narrow/")
    assert knn.walk_route(n, n, k, DEV, symmetric=False) == full
    assert knn.walk_route(n, n, k, DEV, seeded=True) == full
    assert knn.SYM_FALLBACKS == 2


def test_route_name_names_the_loader(sms, monkeypatch):
    monkeypatch.setattr(scan_topk, "sm_count", lambda index: SMS)
    assert knn.route_name(313_841, 313_841, 25, DEV, loader="tma") == \
        "sym/tma"
    assert knn.route_name(16_384, 313_841, 25, DEV, loader="regs") == \
        knn.route_name(16_384, 313_841, 25, DEV) + "/regs"
    assert knn_t.route_name(313_841, 313_841, 25, DEV, "tma") == \
        "owners2/tma"
    assert scan_topk.route_name(313_841, 4096, 15, DEV, "tma") == \
        scan_topk.route_name(313_841, 4096, 15, DEV) + "/tma"


def test_k1t_keeps_its_walk(sms):
    """K1t's routes never name the symmetric one."""
    assert knn_t.route_name(313_841, 313_841, 25, DEV) == "owners2"
    assert knn_t.route_name(313_841, 313_841, 200, DEV).startswith("wide/")


def test_sym_words_counts_lists_and_locks():
    # 300 rows: 3 tiles, 2 words of int32 locks.
    assert knn.sym_words(300, 5) == 1500 + 2
    assert knn.sym_words(128, 1) == 128 + 1


def test_symmetric_keyword_on_the_cpu():
    """On a CPU tensor both walks are the plain version."""
    xu = torch.from_numpy(_rows("tied", 40, seed=4)).float()
    a = knn.knn_scan(xu, 5, 1.0)
    b = knn.knn_scan(xu, 5, 1.0, symmetric=False)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
