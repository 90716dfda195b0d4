"""The CUDA kernels of subtile serving — K3 (subtile max), K4b (top-S
select), K5 (gather and score) and K4a (pool cut) — against their plain
PyTorch versions on the card, at small and ragged shapes; subtile_search
on the kernels against subtile_search on the plain versions; and the wide
lists of K1 and K2 (k up to 256; the wide lists past 256 are held in
tests/test_torch_gpu_ivf.py).  K3 and K5 have two routes on the card
(subtile_max.tensor_core_route): the bf16 tensor-core kernels, which share
csrc/wgmma_tile.cuh's product, and the SIMT kernels, for float32 and
ragged F; both are held here, and the block-max guarantee on each.

Every test here needs an NVIDIA GPU with nvcc: they are marked ``gpu`` and
skip without one.  This file imports no jax; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_subtile.py
"""

import numpy as np
import pytest
import torch

from pyarrowspace_tpu_torch import ArrowSpaceBuilder
from pyarrowspace_tpu_torch.ops import subtile_scan as tss
from pyarrowspace_tpu_torch.ops.cuda import (extract, gather_score, knn,
                                             scan_topk, subtile_max)
from pyarrowspace_tpu_torch.ops.cuda.compare import topk_disagreements

pytestmark = pytest.mark.gpu

# Kernel and plain version sum the products in different orders.
TOL = 1e-5
TAU = 0.62


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _unit(rng, n, f):
    x = rng.standard_normal((n, f)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _dtype(name):
    return {"f32": torch.float32, "bf16": torch.bfloat16}[name]


def _corpus(dev, seed, n_pad, f, dtype, n_real=None):
    rng = np.random.default_rng(seed)
    x = np.zeros((n_pad, f), np.float32)
    n_real = n_pad if n_real is None else n_real
    x[:n_real] = _unit(rng, n_real, f)
    lam = np.full(n_pad, -2.0, np.float32)
    lam[:n_real] = rng.uniform(0.05, 0.3, n_real)
    return (rng, torch.from_numpy(x).to(dev).to(dtype),
            torch.from_numpy(lam).to(dev))


# -- the repair: lists wider than 64 --------------------------------------------

@pytest.mark.parametrize("n,f,k", [(300, 32, 100), (1000, 64, 200),
                                   (700, 48, 256)])
def test_knn_kernel_wide_lists(dev, n, f, k):
    xu = torch.from_numpy(_unit(np.random.default_rng(n), n, f)).to(dev)
    d, i = knn.knn_scan(xu, k, 1.5)
    torch.cuda.synchronize()
    dp, ip = knn.knn_plain(xu, k, 1.5)
    assert topk_disagreements(d.cpu(), i.cpu(), dp.cpu(), ip.cpu(), TOL) == []


@pytest.mark.parametrize("n,q,f,k", [(1000, 7, 64, 200), (5000, 130, 40, 256),
                                     (300, 65, 24, 129)])
def test_scan_kernel_wide_lists(dev, n, q, f, k):
    rng = np.random.default_rng(n + q)
    xu = torch.from_numpy(_unit(rng, n, f)).to(dev)
    qn = torch.from_numpy(_unit(rng, q, f)).to(dev)
    lam = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)).to(dev)
    lamq = torch.from_numpy(rng.uniform(0, 1, q).astype(np.float32)).to(dev)
    i, s = scan_topk.lambda_search(xu, lam, qn, lamq, TAU, k)
    torch.cuda.synchronize()
    ip, sp = scan_topk.scan_plain(xu, lam, qn, lamq, TAU, k)
    assert topk_disagreements(s.cpu(), i.cpu(), sp.cpu(), ip.cpu(),
                              TOL) == []


def test_wide_lists_refuse_past_256(dev):
    """The list limit, 256 when this test was written and 4,096 later, is
    gone: past both, the wrappers serve their plain versions' lists."""
    rng = np.random.default_rng(9)
    xu = torch.from_numpy(_unit(rng, 5000, 4)).to(dev)
    lam = torch.from_numpy(rng.uniform(0, 1, 5000).astype(np.float32)).to(dev)
    i, s = scan_topk.lambda_search(xu, lam, xu[:2], lam[:2], 0.5, 4097)
    ip, sp = scan_topk.scan_plain(xu, lam, xu[:2], lam[:2], 0.5, 4097)
    assert topk_disagreements(s.cpu(), i.cpu(), sp.cpu(), ip.cpu(),
                              TOL) == []
    score = torch.from_numpy(rng.uniform(size=(2, 5000)).astype(
        np.float32)).to(dev)
    assert torch.equal(extract.extract_ids(score, 4097),
                       extract.extract_ids_plain(score, 4097))


def test_search_batch_exact_topk_200_on_card(dev):
    rng = np.random.default_rng(2)
    items = rng.standard_normal((900, 20)).astype(np.float32) + 0.2
    gp = {"eps": 0.9, "k": 8, "topk": 6, "p": 2.0, "sigma": 0.4}
    a, gl = ArrowSpaceBuilder.build(gp, items)
    a_cpu, gl_cpu = ArrowSpaceBuilder.build(gp, items, device="cpu")
    idx, vals = a.search_batch(items[:9] * 1.01, gl, 0.62, topk=200)
    idx_c, vals_c = a_cpu.search_batch(items[:9] * 1.01, gl_cpu, 0.62,
                                       topk=200)
    assert idx.shape == (9, 200)
    assert topk_disagreements(vals, idx, vals_c, idx_c, TOL) == []


# -- K3 -------------------------------------------------------------------------

@pytest.mark.parametrize("n_pad,n_real,q,f", [
    (128, 100, 1, 33), (8192, 3000, 65, 100), (1024, 1024, 130, 64),
    (640, 1, 7, 384)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_subtile_max_kernel_matches_plain(dev, n_pad, n_real, q, f, dt):
    rng, xu, lam = _corpus(dev, n_pad + q, n_pad, f, _dtype(dt), n_real)
    qn = torch.from_numpy(_unit(rng, q, f)).to(dev).to(xu.dtype)
    lamq = torch.from_numpy(rng.uniform(0.05, 0.3, q).astype(np.float32))
    lamq = lamq.to(dev)
    got = subtile_max.subtile_max(xu, lam, qn, lamq, TAU, n_real)
    torch.cuda.synchronize()
    ref = subtile_max.subtile_max_plain(xu, lam, qn, lamq, TAU, n_real)
    real = -(-n_real // 64)
    assert got.shape == (q, n_pad // 64)
    torch.testing.assert_close(got[:, :real], ref[:, :real], rtol=0,
                               atol=TOL)
    assert torch.equal(got[:, real:], ref[:, real:])    # the sentinels


# -- K4b and K4a ----------------------------------------------------------------

def _tied_scores(rng, rows, cols, n_sentinel):
    s = (rng.integers(0, 24, (rows, cols)) / 8.0).astype(np.float32)
    for r in range(rows):
        at = rng.choice(cols, min(n_sentinel, cols), replace=False)
        s[r, at] = np.float32(-1.0e6) - at.astype(np.float32)
    return s


def _k4_scores(rng, rows, cols, case):
    """Rows of one kind: "tied" (a grid of eighths with sentinels), "zeros"
    (-0.0, +0.0 and +-0.5, so that the two zeros tie), "special" (the tied
    grid with +-inf and NaN entries, and a row of NaN only), "equal" (each
    row one value) or "random" (distinct values: no ties)."""
    if case == "tied":
        return _tied_scores(rng, rows, cols, cols // 8)
    if case == "zeros":
        return rng.choice(np.array([-0.0, 0.0, 0.5, -0.5], np.float32),
                          (rows, cols))
    if case == "special":
        s = _tied_scores(rng, rows, cols, cols // 16)
        for v in (np.inf, -np.inf, np.nan):
            s[rng.random((rows, cols)) < 0.05] = v
        s[-1] = np.nan
        return s
    if case == "equal":
        return np.repeat((np.arange(rows) / 8.0).astype(np.float32)[:, None],
                         cols, axis=1)
    return rng.standard_normal((rows, cols)).astype(np.float32)


K4_CASES = ["tied", "zeros", "special", "equal", "random"]
# Beside the path's shapes: m = 1 and m = len, m 1,024 and 5,000, odd len
# (rows not 16-byte aligned: no bulk copy) and a 70,000-column row, past
# shared memory (the device route).
K4_LONG = [(4, 4992, 1024), (2, 16384, 5000), (3, 1001, 1001),
           (7, 999, 30), (2, 70000, 16), (2, 70000, 700)]


def _routed(fn, score, m):
    """fn() after a check that its one launch took route_name's route and
    load_name's way in."""
    route = extract.route_name(score.shape[1], m)
    before = dict(extract.ROUTE_LAUNCHES)
    got = fn()
    torch.cuda.synchronize()
    after = dict(extract.ROUTE_LAUNCHES)
    assert after == dict(before, **{route: before[route] + 1})
    return got


@pytest.mark.parametrize("case", K4_CASES)
@pytest.mark.parametrize("rows,cols,m", [
    (1, 64, 1), (9, 1000, 16), (300, 4992, 16), (5, 16384, 64),
    (33, 700, 100), (8, 300, 256)] + K4_LONG)
def test_extract_ids_kernel_matches_plain(dev, rows, cols, m, case):
    rng = np.random.default_rng(rows * cols + m)
    score = torch.from_numpy(_k4_scores(rng, rows, cols, case)).to(dev)
    got = _routed(lambda: extract.extract_ids(score, m), score, m)
    assert torch.equal(got, extract.extract_ids_plain(score, m))


@pytest.mark.parametrize("case", K4_CASES)
@pytest.mark.parametrize("rows,cols,m", [
    (1, 64, 1), (9, 1024, 30), (300, 1024, 30), (17, 128, 48),
    (4, 4096, 200), (6, 300, 256)] + K4_LONG)
def test_extract_pool_kernel_matches_plain(dev, rows, cols, m, case):
    """Ids distinct within a row, in no order, negative ones among them; a
    masked entry's sentinel made from its id, as subtile_search makes it."""
    rng = np.random.default_rng(rows * cols + m + 1)
    score = _k4_scores(rng, rows, cols, case)
    cand = np.stack([rng.permutation(4 * cols)[:cols] - 2 * cols
                     for _ in range(rows)]).astype(np.int32)
    masked = (score < -1.0e5) & np.isfinite(score)
    score[masked] = np.float32(-1.0e6) - cand[masked].astype(np.float32)
    score_t = torch.from_numpy(score).to(dev)
    cand_t = torch.from_numpy(cand).to(dev)
    got = _routed(lambda: extract.extract_pool(score_t, cand_t, m), score_t,
                  m)
    assert torch.equal(got, extract.extract_pool_plain(score_t, cand_t, m))


def test_extract_routes_each_run(dev):
    """Every route and both ways in run at least once, and the narrow
    route's overflow (more tied candidates than its buffer) lands on the
    plain version's ids: a constant row makes every entry a candidate."""
    shapes = {"narrow": (300, 4992, 16), "radix": (4, 4992, 1024),
              "device": (2, 70000, 16)}
    for route, (rows, cols, m) in shapes.items():
        assert extract.route_name(cols, m) == route
        for width in (cols, cols - 1):          # bulk copy, then 4-byte loads
            rng = np.random.default_rng(width)
            score = torch.from_numpy(_k4_scores(rng, rows, width,
                                                "random")).to(dev)
            if route != "device":
                assert extract.load_name(score) == (
                    "bulk" if width == cols else "scalar")
            got = _routed(lambda: extract.extract_ids(score, m), score, m)
            assert torch.equal(got, extract.extract_ids_plain(score, m))
    flat = torch.full((3, 4096), 0.25, device=dev)
    assert extract.route_name(4096, 16) == "narrow"
    assert torch.equal(extract.extract_ids(flat, 16),
                       torch.arange(16, dtype=torch.int32,
                                    device=dev).expand(3, 16))


# -- K5 -------------------------------------------------------------------------

@pytest.mark.parametrize("n_sub,q,s_keep,f", [
    (2, 1, 1, 33), (128, 9, 3, 100), (130, 65, 16, 384), (64, 5, 5, 768)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_gather_score_kernel_matches_plain(dev, n_sub, q, s_keep, f, dt):
    rng, xu, _ = _corpus(dev, n_sub + q, n_sub * 64, f, _dtype(dt))
    qn = torch.from_numpy(_unit(rng, q, f)).to(dev).to(xu.dtype)
    sel = np.stack([rng.permutation(n_sub)[:s_keep] for _ in range(q)])
    sel = torch.from_numpy(sel.astype(np.int32)).to(dev)
    got = gather_score.gather_score(xu, qn, sel)
    torch.cuda.synchronize()
    ref = gather_score.gather_score_plain(xu, qn, sel)
    torch.testing.assert_close(got, ref, rtol=0, atol=TOL)


def _block_max(dev, xu, lam, qn, lamq, n_real, nan_free=False):
    """K3's maxima of the real subtiles and the best of phase b's blended
    scores (K5 + the PyTorch blend) over each subtile's real rows (those
    whose score is a number, when nan_free)."""
    q = qn.shape[0]
    sub = subtile_max.subtile_max(xu, lam, qn, lamq, TAU, n_real)
    real = -(-n_real // 64)
    sel = torch.arange(real, dtype=torch.int32, device=dev).expand(q, real)
    cos = gather_score.gather_score(xu, qn, sel.contiguous())
    tau = torch.tensor(TAU, dtype=torch.float32, device=dev)
    lam_b = lam.view(-1, 64)[sel.long()].reshape(q, -1)
    score = tau * cos + (1.0 - tau) * (1.0 / (1.0 + torch.abs(
        lam_b - lamq[:, None])))
    rows = sel.long()[:, :, None] * 64 + torch.arange(64, device=dev)
    score = score.masked_fill(rows.reshape(q, -1) >= n_real, float("-inf"))
    if nan_free:
        score = score.masked_fill(score.isnan(), float("-inf"))
    best = score.view(q, real, 64).amax(dim=2)
    return sub[:, :real].contiguous(), best


# bf16 at F 96 takes the tensor-core route, bf16 at F 97 (ragged) and
# float32 the SIMT route.
@pytest.mark.parametrize("dt,f", [("f32", 96), ("bf16", 96), ("bf16", 97),
                                  ("bf16", 384)])
def test_block_max_bitwise(dev, dt, f):
    """K3's maximum of a subtile equals, bit for bit, the best of phase b's
    blended scores over the subtile's real rows (K5 + the PyTorch blend)."""
    n_real, q = 3000, 300
    rng, xu, lam = _corpus(dev, 9, 8192, f, _dtype(dt), n_real)
    qn = torch.from_numpy(_unit(rng, q, f)).to(dev).to(xu.dtype)
    lamq = torch.from_numpy(rng.uniform(0.05, 0.3, q).astype(np.float32))
    lamq = lamq.to(dev)
    tc = subtile_max.TC_LAUNCHES, gather_score.TC_LAUNCHES
    sub, best = _block_max(dev, xu, lam, qn, lamq, n_real)
    on_tc = dt == "bf16" and f % 8 == 0
    assert (subtile_max.TC_LAUNCHES, gather_score.TC_LAUNCHES) == (
        tc[0] + on_tc, tc[1] + on_tc)
    assert torch.equal(best.view(torch.int32), sub.view(torch.int32))


def test_block_max_bitwise_query_order(dev):
    """A query's bits do not depend on its column in the tensor-core tile:
    K3 and K5 on the batch permuted give each query the same maxima and
    cosines bit for bit, and the guarantee holds."""
    n_real, q, f = 5000, 700, 768
    rng, xu, lam = _corpus(dev, 10, 8192, f, torch.bfloat16, n_real)
    qn = torch.from_numpy(_unit(rng, q, f)).to(dev).to(xu.dtype)
    lamq = torch.from_numpy(rng.uniform(0.05, 0.3, q).astype(np.float32))
    lamq = lamq.to(dev)
    perm = torch.from_numpy(rng.permutation(q)).to(dev)
    sub, best = _block_max(dev, xu, lam, qn, lamq, n_real)
    sub_p, best_p = _block_max(dev, xu, lam, qn[perm].contiguous(),
                               lamq[perm].contiguous(), n_real)
    assert torch.equal(best_p.view(torch.int32), sub_p.view(torch.int32))
    assert torch.equal(sub_p.view(torch.int32), sub[perm].view(torch.int32))
    assert torch.equal(best_p.view(torch.int32),
                       best[perm].view(torch.int32))


# -- the tensor-core route against the plain versions ---------------------------

@pytest.mark.parametrize("n_pad,n_real,q,f", [
    (64, 64, 1, 8), (64, 37, 5, 64), (640, 600, 257, 64),
    (8192, 8130, 300, 384), (8256, 8256, 513, 768), (16384, 9000, 1000, 96),
    (1024, 0, 3, 384)])
def test_subtile_max_tensor_core_matches_plain(dev, n_pad, n_real, q, f):
    rng, xu, lam = _corpus(dev, n_pad + q + f, n_pad, f, torch.bfloat16,
                           n_real)
    qn = torch.from_numpy(_unit(rng, q, f)).to(dev).to(xu.dtype)
    lamq = torch.from_numpy(rng.uniform(0.05, 0.3, q).astype(np.float32))
    lamq = lamq.to(dev)
    assert subtile_max.tensor_core_route(xu, qn)
    tc = subtile_max.TC_LAUNCHES
    got = subtile_max.subtile_max(xu, lam, qn, lamq, TAU, n_real)
    torch.cuda.synchronize()
    assert subtile_max.TC_LAUNCHES == tc + 1
    ref = subtile_max.subtile_max_plain(xu, lam, qn, lamq, TAU, n_real)
    real = -(-n_real // 64)
    torch.testing.assert_close(got[:, :real], ref[:, :real], rtol=0,
                               atol=TOL)
    assert torch.equal(got[:, real:], ref[:, real:])    # the sentinels


def test_subtile_max_tensor_core_division_exact(dev):
    """The tensor-core epilogue's reciprocal (no branch to a slow path)
    equals PyTorch's IEEE 1 / x bit for bit: tau 0 makes each maximum the
    proximity 1 / (1 + |lam_i - lam_q|) itself.  Subtile 0 (lam_i 0) takes
    every float x in [1, 2) (2^23 queries, lam_q = x - 1) and 2^20 x drawn
    in [2, 2^62); subtile 1 (lam_i -(2^62 - 2^38), the float of largest
    magnitude under 2^62) takes x in [2^62, 2^63).  Every lambda stays
    under 2^62 in magnitude, so all of it is the fast path."""
    f = 8
    k = torch.arange(1 << 23, device=dev, dtype=torch.float32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    wide = torch.exp2(torch.rand(1 << 20, generator=gen, device=dev) * 61
                      + 1.0)
    lamq = torch.cat([k * 2.0 ** -23, wide]).contiguous()
    assert float(lamq.max()) < 2.0 ** 62
    xu = torch.ones((128, f), device=dev, dtype=torch.bfloat16)
    qn = torch.ones((lamq.numel(), f), device=dev, dtype=torch.bfloat16)
    lam = torch.zeros(128, device=dev)
    lam[64:] = -(2.0 ** 62 - 2.0 ** 38)
    assert subtile_max.tensor_core_route(xu, qn)
    got = subtile_max.subtile_max(xu, lam, qn, lamq, 0.0, 128)
    want = 1.0 / (1.0 + torch.abs(lam[::64, None] - lamq[None, :])).T
    x_top = 1.0 + torch.abs(lam[64] - lamq)
    assert float(x_top.min()) >= 2.0 ** 62 - 2.0 ** 38
    assert float(x_top.max()) >= 2.0 ** 62.99
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# Lambdas the fast reciprocal does not take (2^62 or more in magnitude, or
# not finite): the warpgroups that meet one blend with tile::blend's IEEE
# division.  "huge": a row's lambda 1.5 * 2^62 in one subtile and a query's
# 2^100; "inf": a row's +inf and a query's -inf (their difference stays
# infinite, so each proximity is 0); "nan": a row's NaN, whose blended
# score is NaN on both sides.
@pytest.mark.parametrize("case", ["huge", "inf", "nan"])
@pytest.mark.parametrize("dt,f", [("bf16", 96), ("f32", 96)])
def test_block_max_bitwise_off_the_fast_path(dev, case, dt, f):
    """The block-max guarantee where a warpgroup's lambdas leave the fast
    reciprocal's range, on both routes.  K3's max is fmaxf's, which passes
    over a NaN score, so for "nan" phase b's best is taken over the scores
    that are numbers (a subtile keeps 63 of them)."""
    n_real, q = 3000, 300
    rng, xu, lam = _corpus(dev, 11, 8192, f, _dtype(dt), n_real)
    qn = torch.from_numpy(_unit(rng, q, f)).to(dev).to(xu.dtype)
    lamq = torch.from_numpy(rng.uniform(0.05, 0.3, q).astype(np.float32))
    lamq = lamq.to(dev)
    if case == "huge":
        lam[64 * 5 + 17] = 1.5 * 2.0 ** 62
        lamq[260] = 2.0 ** 100
    elif case == "inf":
        lam[64 * 5 + 17] = float("inf")
        lam[n_real - 1] = float("inf")         # in the partial last subtile
        lamq[260] = float("-inf")
    else:
        lam[64 * 5 + 17] = float("nan")
        lam[n_real - 1] = float("nan")
    tc = subtile_max.TC_LAUNCHES
    sub, best = _block_max(dev, xu, lam, qn, lamq, n_real,
                           nan_free=case == "nan")
    assert subtile_max.TC_LAUNCHES == tc + (dt == "bf16")
    assert torch.isfinite(sub).all()
    assert torch.equal(best.view(torch.int32), sub.view(torch.int32))


def _skewed_sel(rng, q, s_keep, n_sub, hot):
    """Each query's s_keep subtiles: the first `hot` from a few popular
    subtiles (buckets far larger than a 256-query chunk), the rest random,
    some repeated within a query; most subtiles stay unselected."""
    popular = rng.choice(n_sub, size=max(1, hot), replace=False)
    sel = rng.integers(0, n_sub, (q, s_keep))
    sel[:, :hot] = popular[None, :hot]
    sel[::7, -1] = sel[::7, 0]                   # a subtile twice in a row
    return sel.astype(np.int32)


@pytest.mark.parametrize("n_sub,q,s_keep,f,hot", [
    (2, 1, 1, 8, 0), (64, 300, 16, 384, 3), (130, 700, 16, 768, 16),
    (500, 65, 5, 64, 1), (4000, 1000, 16, 96, 2)])
def test_gather_score_tensor_core_matches_plain(dev, n_sub, q, s_keep, f,
                                                hot):
    rng, xu, _ = _corpus(dev, n_sub + q + f, n_sub * 64, f, torch.bfloat16)
    qn = torch.from_numpy(_unit(rng, q, f)).to(dev).to(xu.dtype)
    sel = torch.from_numpy(_skewed_sel(rng, q, s_keep, n_sub,
                                       min(hot, s_keep))).to(dev)
    tc = gather_score.TC_LAUNCHES
    got = gather_score.gather_score(xu, qn, sel)
    torch.cuda.synchronize()
    assert gather_score.TC_LAUNCHES == tc + 1
    ref = gather_score.gather_score_plain(xu, qn, sel)
    torch.testing.assert_close(got, ref, rtol=0, atol=TOL)


def test_simt_routes_serve_f32_and_ragged_f(dev):
    """A float32 state and a bf16 state of ragged F run the SIMT kernels
    (the tensor-core counters do not move) and agree with the plain
    versions."""
    for dtype, f in ((torch.float32, 384), (torch.bfloat16, 100),
                     (torch.float32, 33)):
        rng, xu, lam = _corpus(dev, f, 1024, f, dtype, 1000)
        qn = torch.from_numpy(_unit(rng, 9, f)).to(dev).to(dtype)
        lamq = torch.full((9,), 0.2, device=dev)
        assert not subtile_max.tensor_core_route(xu, qn)
        before = (subtile_max.LAUNCHES, subtile_max.TC_LAUNCHES,
                  gather_score.LAUNCHES, gather_score.TC_LAUNCHES)
        sub = subtile_max.subtile_max(xu, lam, qn, lamq, TAU, 1000)
        sel = extract.extract_ids(sub, 4)
        cos = gather_score.gather_score(xu, qn, sel)
        assert (subtile_max.LAUNCHES, subtile_max.TC_LAUNCHES,
                gather_score.LAUNCHES, gather_score.TC_LAUNCHES) == (
            before[0] + 1, before[1], before[2] + 1, before[3])
        ref = subtile_max.subtile_max_plain(xu, lam, qn, lamq, TAU, 1000)
        torch.testing.assert_close(sub, ref, rtol=0, atol=TOL)
        torch.testing.assert_close(
            cos, gather_score.gather_score_plain(xu, qn, sel), rtol=0,
            atol=TOL)


# -- subtile_search: kernels against plain versions -------------------------------

@pytest.mark.parametrize("n,f,q,kw", [
    (300, 32, 9, dict(topk=10)),                    # 5 real subtiles < s_keep
    (3000, 100, 65, dict(topk=15, pool_m=30)),      # a partial subtile
    (9000, 64, 33, dict(topk=30, pool_m=60)),       # the sort pool cut
    (8192, 48, 17, dict(topk=16, n_subtiles_keep=16)),
])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_subtile_search_kernels_match_plain(dev, n, f, q, kw, dt):
    rng = np.random.default_rng(n + q)
    xu = torch.from_numpy(_unit(rng, n, f))
    lam = torch.from_numpy(rng.uniform(0.05, 0.3, n).astype(np.float32))
    qn = torch.from_numpy(_unit(rng, q, f))
    lamq = torch.from_numpy(rng.uniform(0.05, 0.3, q).astype(np.float32))
    st = tss.build_subtile_state(xu, lam, scan_dtype=_dtype(dt))
    st_d = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in st.items()}
    counts = (subtile_max.LAUNCHES, extract.IDS_LAUNCHES,
              gather_score.LAUNCHES)
    gi, gv = tss.subtile_search(st_d["xu_scan"], st_d["xu_f32"],
                                st_d["lambdas"], qn.to(dev), lamq.to(dev),
                                TAU, n, **kw)
    torch.cuda.synchronize()
    assert (subtile_max.LAUNCHES, extract.IDS_LAUNCHES,
            gather_score.LAUNCHES) == tuple(c + 1 for c in counts)
    pi, pv = tss.subtile_search(st["xu_scan"], st["xu_f32"], st["lambdas"],
                                qn, lamq, TAU, n, **kw)
    gi, gv = gi.cpu().numpy(), gv.cpu().numpy()
    assert gi.max() < n
    assert all(len(set(row)) == kw["topk"] for row in gi)
    assert topk_disagreements(gv, gi, pv.numpy(), pi.numpy(), TOL) == []


def test_subtile_search_two_level_on_card(dev, monkeypatch):
    rng = np.random.default_rng(21)
    n, f, q = 20000, 64, 16         # 24 supertiles > s_keep: both levels
    xu = torch.from_numpy(_unit(rng, n, f))
    lam = torch.from_numpy(rng.uniform(0.05, 0.3, n).astype(np.float32))
    qn = torch.from_numpy(_unit(rng, q, f)).to(dev)
    lamq = torch.from_numpy(rng.uniform(0.05, 0.3, q).astype(np.float32))
    st = tss.build_subtile_state(xu.to(dev), lam.to(dev))
    args = (st["xu_scan"], st["xu_f32"], st["lambdas"], qn, lamq.to(dev),
            TAU, n)
    one_i, one_v = tss.subtile_search(*args, topk=10)
    monkeypatch.setattr(tss, "_SINGLE_LEVEL_MAX_NSUB", 8)
    pool = extract.POOL_LAUNCHES
    two_i, two_v = tss.subtile_search(*args, topk=10)
    assert extract.POOL_LAUNCHES == pool + 3     # sup, sub, pool cut
    assert torch.equal(one_i, two_i) and torch.equal(one_v, two_v)


def test_search_batch_subtile_and_auto_on_card(dev, monkeypatch):
    from pyarrowspace_tpu_torch.core import space as space_mod
    rng = np.random.default_rng(4)
    items = rng.standard_normal((2000, 24)).astype(np.float32) + 0.2
    gp = {"eps": 0.9, "k": 8, "topk": 10, "p": 2.0, "sigma": 0.4}
    a, gl = ArrowSpaceBuilder.build(gp, items)
    queries = items[:40] * 1.01
    exact = a.search_batch(queries, gl, TAU)
    before = (subtile_max.LAUNCHES, extract.IDS_LAUNCHES,
              gather_score.LAUNCHES, extract.POOL_LAUNCHES)
    sub = a.search_batch(queries, gl, TAU, mode="subtile")
    monkeypatch.setattr(space_mod, "AUTO_SUBTILE_MIN_ITEMS", 2000)
    auto = a.search_batch(queries, gl, TAU, mode="auto")
    after = (subtile_max.LAUNCHES, extract.IDS_LAUNCHES,
             gather_score.LAUNCHES, extract.POOL_LAUNCHES)
    assert all(b == a_ - 2 for a_, b in zip(after, before))
    assert np.array_equal(sub[0], auto[0]) and np.array_equal(sub[1], auto[1])
    assert topk_disagreements(sub[1], sub[0], exact[1], exact[0], TOL) == []


# -- the tensor-core schedule's tails (ping-pong warpgroups, clusters) ----------

def _dyadic_case(dev, seed, n_pad, n_real, q, f):
    """Entries in {-1, -0.5, 0, 0.5, 1}: exact in bf16, and every product
    sum exact in float32, so the plain version's matmul gives the tensor
    cores' bits in any order."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n_pad, f), np.float32)
    x[:n_real] = rng.integers(-2, 3, (n_real, f)) / 2
    lam = np.full(n_pad, -2.0, np.float32)
    lam[:n_real] = rng.uniform(0.05, 0.3, n_real)
    qn = (rng.integers(-2, 3, (q, f)) / 2).astype(np.float32)
    lamq = rng.uniform(0.05, 0.3, q).astype(np.float32)
    return (torch.from_numpy(x).to(dev).to(torch.bfloat16),
            torch.from_numpy(lam).to(dev),
            torch.from_numpy(qn).to(dev).to(torch.bfloat16),
            torch.from_numpy(lamq).to(dev))


def _launch_counted(xu, lam, qn, lamq, n_real):
    """K3 on the tensor cores, with the counters its one launch moved."""
    before = (subtile_max.TC_LAUNCHES, subtile_max.CLUSTER_LAUNCHES)
    got = subtile_max.subtile_max(xu, lam, qn, lamq, TAU, n_real)
    torch.cuda.synchronize()
    moved = (subtile_max.TC_LAUNCHES - before[0],
             subtile_max.CLUSTER_LAUNCHES - before[1])
    return got, moved


# Real subtiles 1 and 2 (one pair: the cluster's second block takes only
# subtiles past the real ones), 3 (two pairs, one cluster, the last pair
# half empty), 5 (the last cluster's second pair empty) and 131 (odd, more
# tiles than at small Q); n_real never a multiple of 64; two dead subtiles
# past the real ones.
@pytest.mark.parametrize("q", [1, 255, 256, 257, 6980])
@pytest.mark.parametrize("real", [1, 2, 3, 5, 131])
def test_subtile_max_schedule_tails_bitwise(dev, q, real):
    """K3's maxima equal the plain version's and phase b's best scores bit
    for bit, the sentinels too, at each tail of the schedule; the launch
    runs in clusters at every size."""
    f = 64
    n_real = real * 64 - 23
    n_pad = (real + 2) * 64
    xu, lam, qn, lamq = _dyadic_case(dev, real * 7 + q, n_pad, n_real, q, f)
    assert subtile_max.tensor_core_route(xu, qn)
    got, moved = _launch_counted(xu, lam, qn, lamq, n_real)
    assert moved == (1, 1)
    assert subtile_max.LAST_ROUTE == "tensor-core/cluster2"
    ref = subtile_max.subtile_max_plain(xu, lam, qn, lamq, TAU, n_real)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    sub, best = _block_max(dev, xu, lam, qn, lamq, n_real)
    assert torch.equal(best.view(torch.int32), sub.view(torch.int32))


def test_subtile_max_grid_smaller_than_the_card(dev):
    """Fewer cluster tiles than the card holds clusters: the grid shrinks
    to them, and the maxima hold."""
    real, q, f = 7, 300, 128
    n_real = real * 64 - 5
    xu, lam, qn, lamq = _dyadic_case(dev, 77, 1024, n_real, q, f)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shape = subtile_max.tc_shape(dev.index or 0)
    assert shape.cluster == 2 and shape.active > 0
    blocks = subtile_max.plan_tensor_core(n_real, 1024 // 64, q, shape)
    assert blocks < sms
    assert blocks == 2 * 2 * 2     # 2 columns of pairs x 2 query blocks
    got, moved = _launch_counted(xu, lam, qn, lamq, n_real)
    assert moved == (1, 1)
    ref = subtile_max.subtile_max_plain(xu, lam, qn, lamq, TAU, n_real)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def test_subtile_max_one_warpgroup_off_the_fast_path(dev):
    """600 real subtiles against 2 query blocks, each block taking many
    tiles: the warpgroup of subtile 101 (a row's lambda 1.5 * 2^62; its
    pair partner 100 on the other warpgroup), of subtile 350 (partner 351)
    and both of every tile of query block 1 (a query's 2^100) blend with
    tile::blend's division, while every other tile, the partners' included,
    takes the fast path.  K3 equals phase b bit for bit, and the plain
    version within TOL."""
    real, q, f = 600, 300, 96
    n_real = real * 64 - 9
    rng, xu, lam = _corpus(dev, 12, (real + 1) * 64, f, torch.bfloat16,
                           n_real)
    qn = torch.from_numpy(_unit(rng, q, f)).to(dev).to(xu.dtype)
    lamq = torch.from_numpy(rng.uniform(0.05, 0.3, q).astype(np.float32))
    lamq = lamq.to(dev)
    lam[64 * 101 + 3] = 1.5 * 2.0 ** 62
    lam[64 * 350 + 60] = 1.5 * 2.0 ** 62
    lamq[290] = 2.0 ** 100
    tc = subtile_max.CLUSTER_LAUNCHES
    sub, best = _block_max(dev, xu, lam, qn, lamq, n_real)
    assert subtile_max.CLUSTER_LAUNCHES == tc + 1
    assert torch.isfinite(sub).all()
    assert torch.equal(best.view(torch.int32), sub.view(torch.int32))
    ref = subtile_max.subtile_max_plain(xu, lam, qn, lamq, TAU, n_real)
    torch.testing.assert_close(sub, ref[:, :real], rtol=0, atol=TOL)


def test_cluster_launches_on_the_main_path(dev):
    """search_batch(mode="subtile") on a bf16 state of F 24 launches K3
    once, clustered, on a corpus of many subtiles and on one of a single
    real subtile."""
    rng = np.random.default_rng(5)
    gp = {"eps": 0.9, "k": 8, "topk": 5, "p": 2.0, "sigma": 0.4}
    for n in (2000, 60):
        items = rng.standard_normal((n, 24)).astype(np.float32) + 0.2
        a, gl = ArrowSpaceBuilder.build(gp, items)
        before = (subtile_max.TC_LAUNCHES, subtile_max.CLUSTER_LAUNCHES)
        a.search_batch(items[:30] * 1.01, gl, TAU, mode="subtile")
        assert (subtile_max.TC_LAUNCHES, subtile_max.CLUSTER_LAUNCHES) == (
            before[0] + 1, before[1] + 1)
        assert subtile_max.LAST_ROUTE == "tensor-core/cluster2"
