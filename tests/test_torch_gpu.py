"""The CUDA kernels K1 (k-NN scan) and K2 (blended top-k scan) against
their plain PyTorch versions on the card, at small and ragged shapes.

Every test here needs an NVIDIA GPU with nvcc: they are marked ``gpu`` and
skip without one.  This file imports no jax, so it also runs where JAX is
not installed; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from pyarrowspace_tpu_torch import ArrowSpaceBuilder
from pyarrowspace_tpu_torch.ops.cuda import knn, knn_t, scan_topk
from pyarrowspace_tpu_torch.ops.cuda.compare import (k5_blend, k5_distance,
                                                     topk_disagreements)

pytestmark = pytest.mark.gpu

# Kernel and plain version sum the products in different orders.
TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _unit(rng, n, f):
    x = rng.standard_normal((n, f)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _tied_unit(rng, n, f):
    """Rows with four entries of +-0.5: unit norm and dot products exact in
    float32 whatever the summation order, so distance ties are exact."""
    x = np.zeros((n, f), np.float32)
    for r in range(n):
        cols = rng.choice(f, size=4, replace=False)
        x[r, cols] = rng.choice([-0.5, 0.5], size=4)
    return x


# The tile edges of K1 (128-row blocks, 128-column tiles, 32-feature slabs
# read four features at a time) and its list layouts (k <= 64 and k <= 128
# in shared memory, longer lists in place in the output), with each launch
# option.
@pytest.mark.parametrize("n,f,k,eps,option", [
    (1, 8, 1, 0.9, None), (3, 3, 2, 1.0, None), (65, 33, 7, 0.9, None),
    (300, 32, 7, 0.9, None), (1000, 100, 25, 1.31, None),
    (130, 70, 64, 2.0, None), (127, 3, 64, 2.0, None),
    (128, 33, 65, 2.0, None), (129, 70, 128, 2.0, None),
    (255, 385, 129, 2.0, None), (257, 33, 256, 2.0, None),
    (257, 70, 257, 2.0, None), (255, 385, 25, 1.31, "seeded"),
    (129, 70, 65, 2.0, "seeded"), (257, 33, 64, 1.0, "diag_start"),
    (300, 385, 129, 2.0, "diag_start"), (257, 70, 25, 1.31, "perm"),
    (255, 33, 257, 2.0, "perm"), (300, 33, 100, 2.0, "perm"),
    (257, 70, 128, 2.0, "diag_start"), (255, 70, 100, 2.0, "seeded")])
def test_knn_kernel_matches_plain(dev, n, f, k, eps, option):
    rng = np.random.default_rng(n + f + k)
    xu = torch.from_numpy(_unit(rng, n, f)).to(dev)
    if option == "seeded":
        # Rows [0, c) seeded with their lists over the columns [0, c), then
        # scanned over [c, n): the full scan's lists.
        c = n - n // 3
        seed = knn.knn_plain(xu[:c].contiguous(), k, eps)
        d, i = knn.knn_scan(xu, k, eps, 0, c, col_start=c, seed=seed)
        dp, ip = knn.knn_plain(xu, k, eps, rows=slice(0, c))
    elif option == "perm":
        perm = torch.from_numpy(rng.permutation(n)).to(dev)
        d, i = knn.knn_scan(xu[perm].contiguous(), k, eps, diag_start=True,
                            perm=perm)
        dp, ip = knn.knn_plain(xu, k, eps)
    else:
        d, i = knn.knn_scan(xu, k, eps, diag_start=option == "diag_start")
        dp, ip = knn.knn_plain(xu, k, eps)
    torch.cuda.synchronize()
    assert d.shape == dp.shape and i.dtype == torch.int32
    assert topk_disagreements(d.cpu(), i.cpu(), dp.cpu(), ip.cpu(), TOL) == []


def test_knn_kernel_row_range(dev):
    xu = torch.from_numpy(_unit(np.random.default_rng(5), 700, 48)).to(dev)
    d, i = knn.knn_scan(xu, 9, 0.95, row_start=130, row_count=300)
    d_all, i_all = knn.knn_scan(xu, 9, 0.95)
    assert torch.equal(d, d_all[130:430]) and torch.equal(i, i_all[130:430])


def test_knn_kernel_exact_ties(dev):
    """Exact distance ties everywhere: the kernel must equal the plain
    version's lexicographic (distance, id) top-k bit for bit."""
    xu = torch.from_numpy(_tied_unit(np.random.default_rng(3), 400, 16))
    xu = xu.to(dev)
    for k, eps in ((5, 0.8), (20, 1.0)):
        d, i = knn.knn_scan(xu, k, eps)
        dp, ip = knn.knn_plain(xu, k, eps)
        assert torch.equal(i, ip) and torch.equal(d, dp)


def test_knn_kernel_distances_symmetric(dev):
    xu = torch.from_numpy(_unit(np.random.default_rng(8), 900, 96)).to(dev)
    d, i = (t.cpu().numpy() for t in knn.knn_scan(xu, 12, 1.0))
    where = {(r, int(c)): d[r, s] for r in range(900)
             for s, c in enumerate(i[r]) if c >= 0}
    pairs = [(a, b) for (a, b) in where if (b, a) in where]
    assert len(pairs) > 1000
    assert all(where[a, b] == where[b, a] for a, b in pairs)


# The tile edges of K2 (128-query blocks, 128-item tiles, 32-feature
# slabs) and its list layouts, over float32 and bfloat16 rows.
@pytest.mark.parametrize("n,q,f,k,dtype", [
    (3, 1, 3, 3, "float32"), (100, 1, 24, 10, "float32"),
    (1000, 7, 100, 15, "float32"), (5000, 130, 64, 15, "float32"),
    (777, 65, 33, 64, "float32"), (127, 1, 3, 64, "float32"),
    (128, 127, 33, 65, "float32"), (129, 129, 70, 128, "float32"),
    (255, 127, 385, 129, "float32"), (257, 129, 33, 256, "float32"),
    (1000, 129, 385, 257, "float32"), (5000, 1, 70, 15, "float32"),
    (257, 129, 70, 64, "bfloat16"), (1000, 127, 385, 129, "bfloat16"),
    (700, 129, 70, 100, "bfloat16")])
def test_scan_kernel_matches_plain(dev, n, q, f, k, dtype):
    rng = np.random.default_rng(n + q)
    xu = torch.from_numpy(_unit(rng, n, f)).to(dev).to(getattr(torch, dtype))
    qn = torch.from_numpy(_unit(rng, q, f)).to(dev)
    lam = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)).to(dev)
    lamq = torch.from_numpy(rng.uniform(0, 1, q).astype(np.float32)).to(dev)
    i, s = scan_topk.lambda_search(xu, lam, qn, lamq, 0.62, k)
    torch.cuda.synchronize()
    ip, sp = scan_topk.scan_plain(xu, lam, qn, lamq, 0.62, min(k, n))
    assert topk_disagreements(s.cpu(), i.cpu(), sp.cpu(), ip.cpu(),
                              TOL) == []


def test_scan_kernel_exact_ties(dev):
    """Duplicated corpus rows with equal lambdas tie exactly: ids must equal
    the plain version's (score desc, id asc) order."""
    rng = np.random.default_rng(11)
    base = _tied_unit(rng, 50, 16)
    xu = torch.from_numpy(np.repeat(base, 40, axis=0)).to(dev)   # 2000 rows
    lam = torch.full((2000,), 0.25, device=dev)
    qn = torch.from_numpy(base[:9]).to(dev)
    lamq = torch.full((9,), 0.25, device=dev)
    i, s = scan_topk.lambda_search(xu, lam, qn, lamq, 0.5, 30)
    ip, sp = scan_topk.scan_plain(xu, lam, qn, lamq, 0.5, 30)
    assert torch.equal(i, ip) and torch.equal(s, sp)


@pytest.mark.parametrize("k", [15, 200, 4990])
def test_scan_kernel_nan_scores_enter_no_list(dev, k):
    """Lambdas +inf on 52 items and on queries 3 and 100: inf - inf gives
    NaN scores, which enter no list in the kernel nor in the plain version;
    at k 4,990 those two queries' lists end in 42 unfilled slots (-3e38,
    -1)."""
    rng = np.random.default_rng(97)
    n, q, f = 5000, 130, 64
    xu = torch.from_numpy(_unit(rng, n, f)).to(dev)
    qn = torch.from_numpy(_unit(rng, q, f)).to(dev)
    lam = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)).to(dev)
    lamq = torch.from_numpy(rng.uniform(0, 1, q).astype(np.float32)).to(dev)
    lam[::97] = float("inf")
    lamq[[3, 100]] = float("inf")
    i, s = scan_topk.lambda_search(xu, lam, qn, lamq, 0.62, k)
    torch.cuda.synchronize()
    ip, sp = scan_topk.scan_plain(xu, lam, qn, lamq, 0.62, k)
    assert not torch.isnan(s).any() and not torch.isnan(sp).any()
    assert topk_disagreements(s.cpu(), i.cpu(), sp.cpu(), ip.cpu(),
                              TOL) == []
    tail = max(0, k - (n - 52))
    assert int((i < 0).sum()) == int((ip < 0).sum()) == 2 * tail


def test_kernel_wrappers_reject_unsupported(dev):
    xu = torch.ones((10, 4), device=dev)
    with pytest.raises(TypeError):
        knn.knn_scan(xu.double(), 3, 0.5)
    with pytest.raises(ValueError, match="k >= 1"):
        knn.knn_scan(xu, 0, 0.5)
    with pytest.raises(ValueError):
        knn.knn_scan(xu.T, 3, 0.5)
    lam = torch.zeros(10, device=dev)
    with pytest.raises(TypeError):
        scan_topk.lambda_search(xu.half(), lam, xu[:2].half(), lam[:2], 0.5,
                                3)


def test_build_and_search_on_card_count_launches(dev):
    rng = np.random.default_rng(2)
    items = rng.standard_normal((600, 20)).astype(np.float32) + 0.2
    gp = {"eps": 0.9, "k": 8, "topk": 6, "p": 2.0, "sigma": 0.4}
    k1, k2 = knn.LAUNCHES, scan_topk.LAUNCHES
    a, gl = ArrowSpaceBuilder.build(gp, items)
    assert a.device.type == "cuda" and knn.LAUNCHES == k1 + 1
    hits = a.search(items[4], gl, 0.8)
    idx, vals = a.search_batch(items[:5], gl, 0.8)
    assert scan_topk.LAUNCHES == k2 + 2
    assert [h[0] for h in hits] == idx[4].tolist()
    np.testing.assert_allclose([h[1] for h in hits], vals[4], atol=1e-6)
    a_cpu, gl_cpu = ArrowSpaceBuilder.build(gp, items, device="cpu")
    np.testing.assert_allclose(gl.to_dense(), gl_cpu.to_dense(), atol=1e-5)
    np.testing.assert_allclose(a.lambdas(), a_cpu.lambdas(), atol=1e-5)


# The bit-for-bit witnesses on the card.  K1t (csrc/knn_t.cu) and K5
# (csrc/gather_score.cu) keep tile_common.cuh's product, the one fmaf chain
# over ascending features that K1 and K2 keep on their own product
# (csrc/ffma_tile.cuh): K1's lists must be K1t's, and every score K2
# returns must be K5's cosine for its id blended in tile::blend's order.
@pytest.mark.parametrize("n,f,k,eps,data", [
    (1000, 100, 25, 1.31, "unit"), (257, 70, 64, 2.0, "unit"),
    (300, 385, 65, 1.2, "unit"), (400, 16, 5, 0.8, "tied"),
    (400, 16, 20, 1.0, "tied"), (700, 33, 100, 1.0, "tied")])
def test_knn_kernel_equals_k1t_bitwise(dev, n, f, k, eps, data):
    rng = np.random.default_rng(n + k)
    x = (_unit if data == "unit" else _tied_unit)(rng, n, f)
    xu = torch.from_numpy(x).to(dev)
    d, i = knn.knn_scan(xu, k, eps)
    dt, it = knn_t.knn_scan_t(xu, k, eps)
    assert torch.equal(i, it)
    assert torch.equal(d.view(torch.int32), dt.view(torch.int32))


# K1t now shares K1's product, so K5's SIMT route is K1's witness: every
# distance K1 returns equals 1 - max(0, cos) of K5's cosine for its id.
@pytest.mark.parametrize("n,f,k,eps,data", [
    (1000, 100, 25, 1.31, "unit"), (257, 70, 64, 2.0, "unit"),
    (300, 385, 65, 1.2, "unit"), (400, 16, 5, 0.8, "tied"),
    (400, 16, 20, 1.0, "tied"), (700, 33, 100, 1.0, "tied")])
def test_knn_kernel_equals_k5_distance_bitwise(dev, n, f, k, eps, data):
    rng = np.random.default_rng(n + k)
    x = (_unit if data == "unit" else _tied_unit)(rng, n, f)
    xu = torch.from_numpy(x).to(dev)
    d, i = knn.knn_scan(xu, k, eps)
    want = k5_distance(xu, slice(None), i)
    keep = i >= 0
    assert bool(keep.any())
    assert torch.equal(d.view(torch.int32)[keep], want.view(torch.int32)[keep])


# K1's and K1t's wide route (k > 128): the column walk split across blocks
# (checked by the split counters) and the threshold-select merge, bit for
# bit the plain version's lexicographic (distance, id) lists on data tied at
# every rank.
@pytest.mark.parametrize("k,n,rows", [(129, 700, 700), (200, 900, 300),
                                      (1024, 3000, 256), (5000, 6000, 130)])
@pytest.mark.parametrize("scan", ["knn", "knn_t"])
def test_wide_lists_bitwise_plain_on_ties(dev, scan, k, n, rows):
    xu = torch.from_numpy(_tied_unit(np.random.default_rng(k), n, 16))
    xu = xu.to(dev)
    mod = knn if scan == "knn" else knn_t
    run = knn.knn_scan if scan == "knn" else knn_t.knn_scan_t
    assert knn.plan_splits(rows, n, k, dev)[0] > 1
    before = mod.SPLIT_LAUNCHES
    d, i = run(xu, k, 1.0, 0, rows)
    assert mod.SPLIT_LAUNCHES == before + 1
    dp, ip = knn.knn_plain(xu, k, 1.0, rows=slice(0, rows))
    assert torch.equal(i, ip)
    assert torch.equal(d.view(torch.int32), dp.view(torch.int32))


@pytest.mark.parametrize("option", ["seeded", "diag_start", "perm"])
def test_wide_options_bitwise_plain_on_ties(dev, option):
    k, n, eps = 200, 900, 1.0
    rng = np.random.default_rng(77)
    xu = torch.from_numpy(_tied_unit(rng, n, 16)).to(dev)
    before = knn.SPLIT_LAUNCHES
    if option == "seeded":
        c = 600
        seed = knn.knn_plain(xu[:c].contiguous(), k, eps)
        d, i = knn.knn_scan(xu, k, eps, 0, c, col_start=c, seed=seed)
        dp, ip = knn.knn_plain(xu, k, eps, rows=slice(0, c))
    elif option == "perm":
        perm = torch.from_numpy(rng.permutation(n)).to(dev)
        d, i = knn.knn_scan(xu[perm].contiguous(), k, eps, diag_start=True,
                            perm=perm)
        dp, ip = knn.knn_plain(xu, k, eps)
    else:
        d, i = knn.knn_scan(xu, k, eps, diag_start=True)
        dp, ip = knn.knn_plain(xu, k, eps)
    assert knn.SPLIT_LAUNCHES == before + 1
    assert torch.equal(i, ip)
    assert torch.equal(d.view(torch.int32), dp.view(torch.int32))


@pytest.mark.parametrize("n,q,f,k,dtype", [
    (5000, 130, 64, 15, "float32"), (3000, 129, 385, 200, "float32"),
    (1000, 127, 70, 65, "float32"), (5000, 130, 64, 15, "bfloat16"),
    (3000, 33, 385, 200, "bfloat16")])
def test_scan_kernel_equals_k5_blend_bitwise(dev, n, q, f, k, dtype):
    rng = np.random.default_rng(n + q + k)
    xu = torch.from_numpy(_unit(rng, n, f)).to(dev).to(getattr(torch, dtype))
    qn = torch.from_numpy(_unit(rng, q, f)).to(dev)
    lam = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)).to(dev)
    lamq = torch.from_numpy(rng.uniform(0, 1, q).astype(np.float32)).to(dev)
    i, s = scan_topk.lambda_search(xu, lam, qn, lamq, 0.62, k)
    want = k5_blend(xu, lam, qn, lamq, 0.62, i)
    assert bool((i >= 0).all())
    assert torch.equal(s.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("hub_frac", [0.0, 0.5])
def test_symmetrize_chunked_equals_one_pass_on_card(dev, hub_frac):
    """The chunked symmetrize against the one-pass op on the card, bit for
    bit (ids, weights, degrees, drops), and against the one-pass op on the
    CPU (ids, weights and drops; a row sum may add in another order there):
    K1's lists of 65,536 unit rows at k 25, a fraction of the rows pointing
    their first entry at hub node 0, weights symmetric per pair."""
    from pyarrowspace_tpu_torch.ops.symmetrize import (
        symmetrize_to_ell, symmetrize_to_ell_chunked)
    n, k = 65_536, 25
    rng = np.random.default_rng(11)
    xu = torch.from_numpy(_unit(rng, n, 64)).to(dev)
    _, i = knn.knn_scan(xu, k, 1.31)
    i = i.cpu()
    if hub_frac:
        rows = torch.from_numpy(rng.choice(np.arange(1, n),
                                           int(hub_frac * n), replace=False))
        rows = rows[~(i[rows] == 0).any(dim=1)]
        i[rows, 0] = 0
    j = i.to(torch.int64)
    w = 0.1 + 0.9 * (((torch.arange(n)[:, None] + 1) * (j + 1)) % 97) / 97.0
    w = torch.where(i >= 0, w, 0.0).to(torch.float32)
    one = symmetrize_to_ell(i.to(dev), w.to(dev), 2 * k)
    got = symmetrize_to_ell_chunked(i.to(dev), w.to(dev), 2 * k)
    cpu = symmetrize_to_ell(i, w, 2 * k)
    assert got[4] == 0
    assert one[3] == got[3] == cpu[3]
    assert one[3] > 0 or not hub_frac
    for a, b in zip(one[:3], got[:3]):
        assert a.is_cuda and b.is_cuda and torch.equal(a, b)
    for a, c in zip(one[:2], cpu[:2]):
        assert torch.equal(a.cpu(), c)
