"""The routes of K3 and K5 (ops/cuda/subtile_max.py, gather_score.py) and
K5's buckets, on the CPU.

On the card K3 and K5 take the bf16 tensor-core kernels (one shared
product, csrc/wgmma_tile.cuh) or their SIMT kernels, by one predicate,
``tensor_core_route``; the block-max guarantee needs both kernels to take
the same route for a state.  The tensor-core K5 inverts the selection into
buckets, each subtile's (query, slot) pairs; ``buckets`` is that
construction and ``gather_score_buckets_plain`` the product computed
through it.  Tolerances: the buckets are exact (integers); the product
through the buckets equals gather_score_plain bit for bit on data whose
sums are exact in float32, and within 1e-6 (float32 sums in another order)
on random data."""

import numpy as np
import pytest
import torch

from pyarrowspace_tpu_torch.ops import subtile_scan as tss
from pyarrowspace_tpu_torch.ops.cuda import gather_score, subtile_max

TOL = 1e-6


# -- the route predicate ----------------------------------------------------------

@pytest.mark.parametrize("xdt,qdt,f,want", [
    (torch.bfloat16, torch.bfloat16, 8, True),
    (torch.bfloat16, torch.bfloat16, 384, True),
    (torch.bfloat16, torch.bfloat16, 768, True),
    (torch.bfloat16, torch.bfloat16, 100, False),      # F % 8 == 4
    (torch.bfloat16, torch.bfloat16, 33, False),
    (torch.bfloat16, torch.bfloat16, 7, False),
    (torch.float32, torch.float32, 384, False),        # a float32 state
    (torch.bfloat16, torch.float32, 384, False),
    (torch.float16, torch.float16, 384, False)])
def test_route_by_dtype_and_width(xdt, qdt, f, want):
    xu = torch.zeros((128, f), dtype=xdt)
    qn = torch.zeros((5, f), dtype=qdt)
    assert subtile_max.tensor_core_route(xu, qn) is want
    assert subtile_max.route_name(xu, qn) == ("tensor-core" if want
                                              else "simt")


@pytest.mark.parametrize("shift_x,shift_q", [(1, 0), (0, 1), (4, 0), (8, 8)])
def test_route_needs_16_byte_aligned_bases(shift_x, shift_q):
    """TMA's and cp.async's 16-byte rule: a base 2 bytes off (one bf16)
    takes the SIMT route; 16 bytes off (8 values) stays on the tensor
    cores."""
    f = 64
    bx = torch.zeros(shift_x + 128 * f, dtype=torch.bfloat16)
    bq = torch.zeros(shift_q + 3 * f, dtype=torch.bfloat16)
    xu = bx[shift_x:].view(128, f)
    qn = bq[shift_q:].view(3, f)
    aligned = xu.data_ptr() % 16 == 0 and qn.data_ptr() % 16 == 0
    assert aligned is (shift_x % 8 == 0 and shift_q % 8 == 0)
    assert subtile_max.tensor_core_route(xu, qn) is aligned


def test_k3_and_k5_share_the_route():
    """K5's wrapper routes with K3's own predicate, so the two kernels never
    route one state differently; the subtile serving state (bf16, any F a
    multiple of 8) is on the tensor cores for both."""
    assert gather_score.tensor_core_route is subtile_max.tensor_core_route
    rng = np.random.default_rng(0)
    for f in (8, 40, 384, 100):
        st = tss.build_subtile_state(
            torch.from_numpy(rng.standard_normal((300, f), np.float32)),
            torch.from_numpy(rng.uniform(0, 1, 300).astype(np.float32)))
        qn = torch.zeros((4, f)).to(st["xu_scan"].dtype).contiguous()
        assert subtile_max.tensor_core_route(st["xu_scan"], qn) is (
            f % 8 == 0)


# -- K5's buckets -------------------------------------------------------------------

def _naive_buckets(sel, n_sub):
    q, s_keep = sel.shape
    return [[qi * s_keep + sl for qi in range(q) for sl in range(s_keep)
             if sel[qi, sl] == s] for s in range(n_sub)]


def _sel(kind, rng):
    if kind == "empty_buckets":        # 3 of 40 subtiles selected
        return rng.choice([2, 17, 39], size=(50, 4)), 40
    if kind == "larger_than_chunk":    # one subtile in 600 queries' lists
        sel = rng.integers(0, 30, (600, 5))
        sel[:, 2] = 11
        return sel, 30
    if kind == "repeated":             # a subtile twice in one list
        sel = rng.integers(0, 9, (70, 6))
        sel[::3, 5] = sel[::3, 0]
        return sel, 9
    return rng.integers(0, 500, (33, 16)), 500


@pytest.mark.parametrize("kind", ["empty_buckets", "larger_than_chunk",
                                  "repeated", "random"])
def test_buckets_against_a_naive_loop(kind):
    rng = np.random.default_rng(len(kind))
    sel, n_sub = _sel(kind, rng)
    order, edges = gather_score.buckets(
        torch.from_numpy(sel.astype(np.int32)), n_sub)
    assert order.dtype == torch.int64 and edges.shape == (n_sub + 1,)
    order, edges = order.tolist(), edges.tolist()
    assert edges[0] == 0 and edges[-1] == sel.size
    got = [order[edges[s]:edges[s + 1]] for s in range(n_sub)]
    assert got == _naive_buckets(sel, n_sub)
    if kind == "larger_than_chunk":
        assert max(map(len, got)) > gather_score.CHUNK
    if kind == "empty_buckets":
        assert sum(1 for b in got if not b) == n_sub - 3


# -- the product through the buckets --------------------------------------------

@pytest.mark.parametrize("kind", ["empty_buckets", "larger_than_chunk",
                                  "repeated", "random"])
@pytest.mark.parametrize("chunk", [gather_score.CHUNK, 7])
def test_bucket_product_equals_plain_bitwise(kind, chunk):
    """Entries of -1, -0.5, 0, 0.5, 1 and F 24: every sum is exact in
    float32, so any order gives the same bits."""
    rng = np.random.default_rng(len(kind) + chunk)
    sel, n_sub = _sel(kind, rng)
    f = 24
    xu = torch.from_numpy((rng.integers(-2, 3, (n_sub * 64, f)) / 2)
                          .astype(np.float32))
    qn = torch.from_numpy((rng.integers(-2, 3, (sel.shape[0], f)) / 2)
                          .astype(np.float32))
    sel_t = torch.from_numpy(sel.astype(np.int32))
    got = gather_score.gather_score_buckets_plain(xu, qn, sel_t, chunk)
    want = gather_score.gather_score_plain(xu, qn, sel_t)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bucket_product_matches_plain(dtype):
    rng = np.random.default_rng(3)
    sel, n_sub = _sel("larger_than_chunk", rng)
    f = 96
    x = rng.standard_normal((n_sub * 64, f)).astype(np.float32)
    xu = torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True))
    qn = torch.from_numpy(rng.standard_normal((sel.shape[0], f))
                          .astype(np.float32))
    qn = qn / qn.norm(dim=1, keepdim=True)
    sel_t = torch.from_numpy(sel.astype(np.int32))
    got = gather_score.gather_score_buckets_plain(xu.to(dtype), qn.to(dtype),
                                                  sel_t)
    want = gather_score.gather_score(xu.to(dtype), qn.to(dtype), sel_t)
    torch.testing.assert_close(got, want, rtol=0, atol=TOL)


# -- the tensor-core kernel's cluster plan and walk -----------------------------

# The shape an H100 reports (subtile_max.tc_shape: 2 subtiles a tile,
# clusters of 2 blocks of 384 threads, 256 queries a tile, 66 clusters at
# once), a card that holds a single cluster, and a kernel of other widths:
# the plan reads every number from the shape it is given.
H100 = subtile_max.TensorCoreShape(2, 2, 384, 256, 66)
SHAPES = [H100, H100._replace(active=1),
          subtile_max.TensorCoreShape(2, 4, 256, 128, 30)]


@pytest.mark.parametrize("q", [1, 255, 256, 257, 6980])
@pytest.mark.parametrize("n_real,n_sub", [
    (1, 1), (64, 2), (100, 2), (130, 3), (300, 5), (320, 8), (1000, 17),
    (9000, 200), (1_000_000, 15_744)])
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_visits_every_tile_once(q, n_real, n_sub, shape):
    """The plan against subtile_max.walk_tensor_core, a transcription of
    csrc/subtile_max.cu's Walk (the gpu tests check the kernel itself):
    every (real subtile, query block) once; clusters of the shape's size at
    every size of corpus, a short one's partner taking only subtiles past
    the real ones; no more clusters than the device holds or than there are
    cluster tiles; the blocks of a cluster take the same number of tiles
    (each stage waits on every partner); dead subtiles only in the last
    column."""
    blocks = subtile_max.plan_tensor_core(n_real, n_sub, q, shape)
    real = -(-n_real // 64)
    pairs = -(-real // shape.pair)
    n_qt = -(-q // shape.query_block)
    assert blocks % shape.cluster == 0
    assert 1 <= blocks // shape.cluster <= shape.active
    assert blocks // shape.cluster <= -(-pairs // shape.cluster) * n_qt
    visits = subtile_max.walk_tensor_core(n_real, q, blocks, shape)
    live = sorted((s, j) for _, _, s, j in visits if s < real)
    assert live == [(s, j) for s in range(real) for j in range(n_qt)]
    span = -(-pairs // shape.cluster) * shape.cluster * shape.pair
    dead = [(s, j) for _, _, s, j in visits if s >= real]
    assert len(dead) == (span - real) * n_qt
    assert all(s < span for s, _ in dead)
    tiles = [0] * blocks
    for b, g, s, _ in visits:
        assert s % shape.pair == g
        tiles[b] += 1
    for c in range(blocks // shape.cluster):
        assert len(set(tiles[c * shape.cluster:(c + 1) * shape.cluster])) == 1


def test_plan_of_the_serve_cell():
    """msmarco1m.serve_auto's batch: 15,625 real subtiles of 15,744 (7,813
    pairs, the last half empty), 6,980 queries (28 blocks): clusters of 2
    on every SM of an H100."""
    blocks = subtile_max.plan_tensor_core(1_000_000, 15_744, 6980, H100)
    assert blocks == 132
    visits = subtile_max.walk_tensor_core(1_000_000, 6980, blocks, H100)
    assert len(visits) == 3907 * 2 * 2 * 28
    assert sum(1 for *_, s, _ in visits if s >= 15_625) == 3 * 28


@pytest.mark.parametrize("n_sub,q,want_blocks", [(1, 1, 2), (16, 3, 2),
                                                 (1000, 300, 132)])
def test_plan_with_no_real_subtile_fills_the_sentinels(n_sub, q,
                                                       want_blocks):
    """n_real 0: no tile, clusters of 2 all the same, enough of them for
    the sentinels' grid-stride fill (384 threads a block), at most the
    clusters the card holds."""
    assert subtile_max.plan_tensor_core(0, n_sub, q, H100) == want_blocks
    assert subtile_max.walk_tensor_core(0, q, want_blocks, H100) == []
