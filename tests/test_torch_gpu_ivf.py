"""Kernel K6 (the blocked-IVF probe scan) against its plain PyTorch
version on the card over float32, bfloat16 and float16 slabs, its lists
past 256 (csrc/knn_wide.cuh's staged, sorted merge) also against the
numpy model of tests/_ivf_wide_model.py, merge counts included; the wide
running lists (k > 256) of K1, K2, K4a and K4b against their plain
versions; and blocked-IVF and certified serving on the card against the
same serving on the CPU.

Every test here needs an NVIDIA GPU with nvcc: they are marked ``gpu`` and
skip without one.  This file imports no jax; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_ivf.py
"""

import numpy as np
import pytest
import torch

import _ivf_wide_model as model
from pyarrowspace_tpu_torch import ArrowSpaceBuilder
from pyarrowspace_tpu_torch.ops import ivf_scan as tis
from pyarrowspace_tpu_torch.ops.cuda import extract, ivf_scan, knn, scan_topk
from pyarrowspace_tpu_torch.ops.cuda.compare import topk_disagreements

pytestmark = pytest.mark.gpu

# Kernel and plain version sum the products in different orders.
TOL = 1e-5
TAU = 0.62
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _unit(rng, n, f):
    x = rng.standard_normal((n, f)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _slabs(rng, n_clusters, cap, f, dtype, dev, fill=0.8):
    """Random slabs with a share 1 - fill of padding rows (id -1, lambda
    +inf) and distinct ids in shuffled order."""
    rows = n_clusters * cap
    slabs = torch.from_numpy(_unit(rng, rows, f)).to(dtype)
    ids = rng.permutation(4 * rows)[:rows].astype(np.int32)
    ids[rng.uniform(size=rows) > fill] = -1
    lam = rng.uniform(0.05, 0.3, rows).astype(np.float32)
    lam[ids < 0] = np.inf
    return (slabs.to(dev), torch.from_numpy(lam).to(dev),
            torch.from_numpy(ids).to(dev))


def _queries(rng, n_blocks, qb, n_clusters, n_probe, f, dev):
    qn = torch.from_numpy(_unit(rng, n_blocks * qb, f)).to(dev)
    lamq = torch.from_numpy(rng.uniform(0.05, 0.3, n_blocks * qb)
                            .astype(np.float32)).to(dev)
    probe = np.stack([rng.permutation(n_clusters)[:n_probe]
                      for _ in range(n_blocks)]).astype(np.int32)
    return qn, lamq, torch.from_numpy(probe).to(dev)


def _scan_both(slabs, lam, ids, qn, lamq, probe, k, qb, cap, tau=TAU):
    launches, wide = ivf_scan.LAUNCHES, ivf_scan.WIDE_LAUNCHES
    s, i = ivf_scan.ivf_scan(slabs, lam, ids, qn, lamq, probe, tau, k=k,
                             q_block=qb, cap=cap,
                             tiles=ivf_scan.slab_tiles(ids, cap))
    torch.cuda.synchronize()
    assert ivf_scan.LAUNCHES == launches + 1
    assert ivf_scan.WIDE_LAUNCHES == wide + (k > 256)
    assert ivf_scan.route_name(k) == ("wide" if k > 256 else "narrow")
    sp, ip = ivf_scan.ivf_scan_plain(slabs, lam, ids, qn, lamq, probe, tau,
                                     k=k, q_block=qb, cap=cap)
    return s.cpu().numpy(), i.cpu().numpy(), sp.cpu().numpy(), \
        ip.cpu().numpy()


# -- K6 -------------------------------------------------------------------------

@pytest.mark.parametrize("k", [15, 60, 240, 1024])
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
def test_ivf_scan_kernel_matches_plain(dev, k, dt):
    rng = np.random.default_rng(k)
    n_clusters, cap, f, n_probe, qb = 24, 256, 96, 6, 16
    slabs, lam, ids = _slabs(rng, n_clusters, cap, f, DTYPES[dt], dev)
    qn, lamq, probe = _queries(rng, 9, qb, n_clusters, n_probe, f, dev)
    s, i, sp, ip = _scan_both(slabs, lam, ids, qn, lamq, probe, k, qb, cap)
    assert s.shape == (9 * qb, k) and i.dtype == np.int32
    np.testing.assert_allclose(s, sp, rtol=0, atol=TOL)
    assert topk_disagreements(s, i, sp, ip, TOL) == []


@pytest.mark.parametrize("f,qb,n_probe,cap,k,empty", [
    (33, 8, 1, 128, 10, False),     # unaligned rows: one value a load
    (768, 16, 8, 128, 64, False),   # the north-star width
    (384, 5, 3, 192, 300, False),   # an odd block, a wide list
    (64, 32, 2, 64, 128, False),    # the widest block
    (40, 8, 4, 128, 512, False),    # every slot of every probed slab
    (96, 16, 6, 256, 257, False),   # one past the narrow limit
    (768, 16, 8, 192, 1040, True),  # the certified pool of topk 65, x 4
    (768, 32, 8, 192, 1040, False),
    (768, 16, 6, 128, 257, True),   # an all-padding probed cluster
    (48, 8, 8, 640, 4096, True),    # most of every probed slab
])
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
def test_ivf_scan_kernel_shapes(dev, f, qb, n_probe, cap, k, empty, dt):
    """empty: cluster 0 holds padding only (tiles 0) and every block
    probes it first."""
    rng = np.random.default_rng(f + qb + k)
    n_clusters = max(n_probe, 5)
    slabs, lam, ids = _slabs(rng, n_clusters, cap, f, DTYPES[dt], dev)
    qn, lamq, probe = _queries(rng, 4, qb, n_clusters, n_probe, f, dev)
    if empty:
        ids[:cap] = -1
        lam[:cap] = float("inf")
        probe = torch.stack([torch.cat([torch.zeros_like(p[:1]),
                                        p[p != 0][:n_probe - 1]])
                             for p in probe])
        assert int(ivf_scan.slab_tiles(ids, cap)[0]) == 0
    s, i, sp, ip = _scan_both(slabs, lam, ids, qn, lamq, probe, k, qb, cap)
    np.testing.assert_allclose(s, sp, rtol=0, atol=TOL)
    assert topk_disagreements(s, i, sp, ip, TOL) == []
    # Unfilled slots are (-3e38, -1), as the TPU kernel leaves them.
    assert np.all((i < 0) == (s <= -3.0e38))


def _padding_heavy(rng, cap, f, dtype, dev):
    """Six clusters: one real row at the front (0), one real row in the
    last slot only (1), none (2), a full slab (3), 40 real rows and an
    overflow item in a tail slot (4), half a slab (5)."""
    rows = 6 * cap
    real = np.zeros(rows, bool)
    real[0] = real[2 * cap - 1] = real[5 * cap - 5] = True
    real[3 * cap:4 * cap] = real[4 * cap:4 * cap + 40] = True
    real[5 * cap:5 * cap + cap // 2] = True
    slabs = torch.from_numpy(_unit(rng, rows, f)).to(dtype)
    ids = np.where(real, rng.permutation(4 * rows)[:rows], -1)
    lam = rng.uniform(0.05, 0.3, rows).astype(np.float32)
    lam[~real] = np.inf
    return (slabs.to(dev), torch.from_numpy(lam).to(dev),
            torch.from_numpy(ids.astype(np.int32)).to(dev))


@pytest.mark.parametrize("k", [15, 300])
@pytest.mark.parametrize("qb", [8, 16, 32])
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
def test_ivf_scan_kernel_padding_heavy(dev, k, qb, dt):
    """Slabs that are mostly padding: the kernel walks only the tiles up to
    each cluster's last real row, and its lists are the plain version's
    over whole slabs; walking every tile gives the same bits."""
    rng = np.random.default_rng(k + qb)
    cap, f = 256, 96
    slabs, lam, ids = _padding_heavy(rng, cap, f, DTYPES[dt], dev)
    tiles = ivf_scan.slab_tiles(ids, cap)
    assert tiles.tolist() == [1, 4, 0, 4, 4, 2]
    qn, lamq, _ = _queries(rng, 4, qb, 6, 6, f, dev)
    probe = torch.from_numpy(np.stack([rng.permutation(6) for _ in range(4)])
                             .astype(np.int32)).to(dev)
    s, i, sp, ip = _scan_both(slabs, lam, ids, qn, lamq, probe, k, qb, cap)
    np.testing.assert_allclose(s, sp, rtol=0, atol=TOL)
    assert topk_disagreements(s, i, sp, ip, TOL) == []
    assert np.all((i < 0) == (s <= -3.0e38))
    every = torch.full_like(tiles, cap // 64)
    s2, i2 = ivf_scan.ivf_scan(slabs, lam, ids, qn, lamq, probe, TAU, k=k,
                               q_block=qb, cap=cap, tiles=every)
    assert np.array_equal(i2.cpu().numpy(), i)
    assert np.array_equal(s2.cpu().numpy().view(np.int32), s.view(np.int32))


@pytest.mark.parametrize("qb,dt", [(8, "f16"), (16, "f32"), (32, "bf16")])
def test_ivf_scan_kernel_padding_heavy_f4096(dev, qb, dt):
    rng = np.random.default_rng(qb)
    cap, f = 128, 4096
    slabs, lam, ids = _padding_heavy(rng, cap, f, DTYPES[dt], dev)
    qn, lamq, _ = _queries(rng, 2, qb, 6, 6, f, dev)
    probe = torch.from_numpy(np.stack([rng.permutation(6)[:4]
                                       for _ in range(2)])
                             .astype(np.int32)).to(dev)
    s, i, sp, ip = _scan_both(slabs, lam, ids, qn, lamq, probe, 15, qb, cap)
    np.testing.assert_allclose(s, sp, rtol=0, atol=TOL)
    assert topk_disagreements(s, i, sp, ip, TOL) == []


def _tied_unit(rng, n, f):
    """Rows with four entries of +-0.5: unit norm and dot products exact in
    float32 whatever the summation order."""
    x = np.zeros((n, f), np.float32)
    for r in range(n):
        x[r, rng.choice(f, size=4, replace=False)] = rng.choice([-0.5, 0.5],
                                                                size=4)
    return x


def test_ivf_scan_kernel_exact_ties(dev):
    """Duplicated slab rows with equal lambdas tie exactly; MaxLex keeps
    the lexicographic (score desc, id asc) top-k, as the plain version."""
    rng = np.random.default_rng(3)
    n_clusters, cap, f, qb = 6, 128, 32, 8
    base = _tied_unit(rng, 16, f)
    slabs = torch.from_numpy(base[rng.integers(0, 16, n_clusters * cap)])
    ids = rng.permutation(n_clusters * cap).astype(np.int32)
    lam = np.full(n_clusters * cap, 0.2, np.float32)
    qn = torch.from_numpy(base[:2 * qb]).to(dev)
    lamq = torch.full((2 * qb,), 0.2, device=dev)
    probe = torch.tensor([[0, 3, 5], [4, 1, 2]], dtype=torch.int32,
                         device=dev)
    s, i, sp, ip = _scan_both(slabs.to(dev), torch.from_numpy(lam).to(dev),
                              torch.from_numpy(ids).to(dev), qn, lamq, probe,
                              40, qb, cap)
    assert np.array_equal(i, ip) and np.array_equal(s, sp)


@pytest.mark.parametrize("k", [60, 300, 1200])
def test_ivf_scan_kernel_nan_scores_enter_no_list(dev, k):
    """Lambdas +inf on every 13th slab row and on queries 3 and 40: inf -
    inf gives NaN scores, which enter no list in the kernel nor in the
    plain version; at k 1,200 lists run short of real rows and end in
    unfilled slots (-3e38, -1) on both sides."""
    rng = np.random.default_rng(13)
    n_clusters, cap, f, n_probe, qb = 24, 256, 96, 6, 16
    slabs, lam, ids = _slabs(rng, n_clusters, cap, f, torch.float32, dev)
    lam[::13] = float("inf")
    qn, lamq, probe = _queries(rng, 9, qb, n_clusters, n_probe, f, dev)
    lamq[[3, 40]] = float("inf")
    s, i, sp, ip = _scan_both(slabs, lam, ids, qn, lamq, probe, k, qb, cap)
    assert not np.isnan(s).any() and not np.isnan(sp).any()
    np.testing.assert_allclose(s, sp, rtol=0, atol=TOL)
    assert topk_disagreements(s, i, sp, ip, TOL) == []
    assert np.array_equal(i < 0, ip < 0)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_ivf_scan_kernel_wide_prefix_is_the_narrow_list(dev, dt):
    """At k 300 (the wide route) the first 256 entries are the narrow
    route's k 256 list on the same inputs, bit for bit."""
    rng = np.random.default_rng(300)
    n_clusters, cap, f, n_probe, qb = 24, 256, 96, 6, 16
    slabs, lam, ids = _slabs(rng, n_clusters, cap, f, DTYPES[dt], dev)
    qn, lamq, probe = _queries(rng, 9, qb, n_clusters, n_probe, f, dev)
    tiles = ivf_scan.slab_tiles(ids, cap)
    kw = dict(q_block=qb, cap=cap, tiles=tiles)
    s_n, i_n = ivf_scan.ivf_scan(slabs, lam, ids, qn, lamq, probe, TAU,
                                 k=256, **kw)
    s_w, i_w = ivf_scan.ivf_scan(slabs, lam, ids, qn, lamq, probe, TAU,
                                 k=300, **kw)
    assert ivf_scan.route_name(256) == "narrow"
    assert ivf_scan.route_name(300) == "wide"
    assert torch.equal(i_w[:, :256], i_n)
    assert torch.equal(s_w[:, :256].contiguous().view(torch.int32),
                       s_n.view(torch.int32))


def _tied_case(rng, n_clusters, cap, f, qb, n_blocks, n_probe, dev):
    """Tied slab rows (ids shuffled, a fifth of them padding) and queries,
    lambdas on a grid of 0.25: exact products and ties at every rank."""
    rows = n_clusters * cap
    slabs = _tied_unit(rng, rows, f)
    ids = rng.permutation(3 * rows)[:rows].astype(np.int32)
    ids[rng.uniform(size=rows) > 0.8] = -1
    lam = rng.choice([0.25, 0.5, 0.75], rows).astype(np.float32)
    lam[ids < 0] = np.inf
    qn = _tied_unit(rng, n_blocks * qb, f)
    lamq = rng.choice([0.25, 0.5], n_blocks * qb).astype(np.float32)
    probe = np.stack([rng.permutation(n_clusters)[:n_probe]
                      for _ in range(n_blocks)]).astype(np.int32)
    return slabs, lam, ids, qn, lamq, probe


@pytest.mark.parametrize("k,qb", [(257, 8), (300, 16), (1040, 16),
                                  (1040, 32), (2500, 8)])
def test_ivf_scan_kernel_wide_equals_model(dev, k, qb):
    """The wide route on tied data equals the numpy model bit for bit, ids,
    scores and each query's count of merges (a staging row that could not
    take the next step's 256 rows, and the rest at the end)."""
    rng = np.random.default_rng(k + qb)
    cap, f = 256, 32
    case = _tied_case(rng, 14, cap, f, qb, 5, 10, dev)
    slabs, lam, ids, qn, lamq, probe = case
    tiles = ivf_scan.slab_tiles(torch.from_numpy(ids), cap).numpy()
    ms, mi, mm = model.scan(slabs, lam, ids, qn, lamq, probe, 0.5, k, qb,
                            cap, tiles)
    t = [torch.from_numpy(a).to(dev) for a in case]
    merges = torch.full((len(qn),), -1, dtype=torch.int32, device=dev)
    s, i = ivf_scan.ivf_scan(*t, 0.5, k=k, q_block=qb, cap=cap,
                             tiles=torch.from_numpy(tiles).to(dev),
                             merges=merges)
    assert np.array_equal(i.cpu().numpy(), mi)
    assert np.array_equal(s.cpu().numpy().view(np.uint32), ms.view(np.uint32))
    assert np.array_equal(merges.cpu().numpy(), mm)


@pytest.mark.parametrize("k", [15, 300, 1040])
def test_ivf_scan_kernel_repeated_probe(dev, k):
    """A probe row naming a cluster twice walks it twice: its rows enter a
    list once for each probe, copies side by side (a list entry before an
    equal staged key in the wide merge), every slot written and the list
    sorted; the plain version's lists bit for bit on tied data."""
    rng = np.random.default_rng(k)
    cap, f, qb = 256, 32, 8
    case = _tied_case(rng, 10, cap, f, qb, 4, 6, dev)
    slabs, lam, ids, qn, lamq, probe = case
    probe[:, 3] = probe[:, 1]
    t = [torch.from_numpy(a).to(dev) for a in case]
    s, i, sp, ip = _scan_both(*t, k, qb, cap, tau=0.5)
    assert np.array_equal(i, ip)
    assert np.array_equal(s.view(np.uint32), sp.view(np.uint32))
    assert np.all(np.diff(s, axis=1) <= 0) and np.all(i >= -1)
    twice = [len(np.unique(r[r >= 0])) < (r >= 0).sum() for r in i]
    assert any(twice)


@pytest.mark.parametrize("k", [256, 1040])
def test_ivf_scan_kernel_zero_scores_tie_by_id(dev, k):
    """Orthogonal items at tau 1.5 with item lambdas +inf score tau * (+0.0)
    + (1 - tau) * 0 = +0.0 + -0.0 = +0.0 (at F 128 most rows are
    orthogonal to a query, so the zeros reach both lists): the zeros tie
    and fall to the smallest ids, on both routes as in the plain version.
    K6 never scores -0.0 (its product chain starts at +0.0, so both terms
    are never -0.0); the wide route's keys keep a -0.0 all the same
    (tests/test_torch_ivf_wide.py)."""
    rng = np.random.default_rng(k)
    cap, f, qb = 256, 128, 8
    case = _tied_case(rng, 10, cap, f, qb, 4, 6, dev)
    slabs, lam, ids, qn, lamq, probe = case
    lam[:] = np.inf
    t = [torch.from_numpy(a).to(dev) for a in case]
    s, i, sp, ip = _scan_both(*t, k, qb, cap, tau=1.5)
    assert np.array_equal(i, ip) and np.array_equal(s, sp)
    zero = s == 0
    assert zero.any() and not np.signbit(s[zero]).any()
    for r in range(s.shape[0]):
        z = i[r][zero[r]]
        assert np.all(np.diff(z) > 0)


def test_ivf_scan_kernel_rejects(dev):
    rng = np.random.default_rng(0)
    slabs, lam, ids = _slabs(rng, 40, 128, 16, torch.float32, dev)
    qn, lamq, probe = _queries(rng, 2, 8, 40, 33, 16, dev)
    tiles = ivf_scan.slab_tiles(ids, 128)
    with pytest.raises(ValueError, match="must be in"):
        ivf_scan.ivf_scan(slabs, lam, ids, qn, lamq, probe, TAU,
                          k=33 * 128 + 1, q_block=8, cap=128, tiles=tiles)
    with pytest.raises(TypeError):
        ivf_scan.ivf_scan(slabs.double(), lam, ids, qn, lamq, probe, TAU,
                          k=5, q_block=8, cap=128, tiles=tiles)
    with pytest.raises(ValueError, match="q_block"):
        qn2, lamq2, probe2 = _queries(rng, 1, 40, 40, 2, 16, dev)
        ivf_scan.ivf_scan(slabs, lam, ids, qn2, lamq2, probe2, TAU, k=5,
                          q_block=40, cap=128, tiles=tiles)
    with pytest.raises(ValueError, match="tiles"):
        ivf_scan.ivf_scan(slabs, lam, ids, qn, lamq, probe, TAU, k=5,
                          q_block=8, cap=128, tiles=tiles.long())


# -- the repair: lists wider than 256 --------------------------------------------

@pytest.mark.parametrize("n,f,k", [(1500, 32, 300), (3000, 48, 1024),
                                   (5000, 24, 4096)])
def test_knn_kernel_lists_past_256(dev, n, f, k):
    xu = torch.from_numpy(_unit(np.random.default_rng(n), n, f)).to(dev)
    d, i = knn.knn_scan(xu, k, 1.2, 0, 300)
    torch.cuda.synchronize()
    dp, ip = knn.knn_plain(xu, k, 1.2, rows=slice(0, 300))
    assert topk_disagreements(d.cpu(), i.cpu(), dp.cpu(), ip.cpu(), TOL) == []


@pytest.mark.parametrize("n,q,f,k", [(2000, 70, 32, 300),
                                     (6000, 65, 40, 1024),
                                     (5000, 9, 24, 4096)])
def test_scan_kernel_lists_past_256(dev, n, q, f, k):
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


def _tied_scores(rng, rows, cols):
    return (rng.integers(0, 64, (rows, cols)) / 8.0).astype(np.float32)


@pytest.mark.parametrize("rows,cols,m", [(9, 1000, 300), (5, 16384, 1024),
                                         (3, 5000, 2048), (2, 4096, 4096)])
def test_extract_kernels_lists_past_256(dev, rows, cols, m):
    rng = np.random.default_rng(rows + cols + m)
    score = torch.from_numpy(_tied_scores(rng, rows, cols)).to(dev)
    got = extract.extract_ids(score, m)
    torch.cuda.synchronize()
    assert torch.equal(got, extract.extract_ids_plain(score, m))
    cand = np.stack([rng.permutation(3 * cols)[:cols] for _ in range(rows)])
    cand = torch.from_numpy(cand.astype(np.int32)).to(dev)
    got = extract.extract_pool(score, cand, m)
    torch.cuda.synchronize()
    assert torch.equal(got, extract.extract_pool_plain(score, cand, m))


def test_search_batch_topk_1024_on_card(dev):
    rng = np.random.default_rng(2)
    items = rng.standard_normal((3000, 20)).astype(np.float32) + 0.2
    gp = {"eps": 0.9, "k": 8, "topk": 6, "p": 2.0, "sigma": 0.4}
    a, gl = ArrowSpaceBuilder.build(gp, items)
    a_cpu, gl_cpu = ArrowSpaceBuilder.build(gp, items, device="cpu")
    queries = items[:5] * 1.01
    for mode in ("exact", "subtile"):
        idx, vals = a.search_batch(queries, gl, TAU, topk=1024, mode=mode)
        idx_c, vals_c = a_cpu.search_batch(queries, gl_cpu, TAU, topk=1024,
                                           mode=mode)
        assert idx.shape == (5, 1024)
        assert topk_disagreements(vals, idx, vals_c, idx_c, TOL) == []


# -- blocked-IVF and certified serving on the card --------------------------------

def _mixture(seed=5, k_mix=24, n=3000, f=64, noise=0.35):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k_mix, f))
    x = centers[rng.integers(0, k_mix, size=n)] + noise * rng.normal(
        size=(n, f))
    return rng, (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(
        np.float32)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("certify", [False, True])
def test_blocked_ivf_search_card_matches_cpu(dev, dt, certify):
    from pyarrowspace_tpu_torch.reduction.pipeline import lloyd_reseed
    rng, xu = _mixture()
    n, f = xu.shape
    lam = rng.uniform(0.3, 0.5, n).astype(np.float32)
    sel = rng.choice(n, 24, replace=False)
    cents, assign = lloyd_reseed(torch.from_numpy(xu),
                                 torch.from_numpy(xu[sel]), 12, seed=0)
    rows = rng.choice(n, 64, replace=False)
    q = xu[rows] + (0.25 / np.sqrt(f)) * rng.standard_normal(
        (64, f)).astype(np.float32)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    out = {}
    for where in ("cpu", dev):
        xu_t = torch.from_numpy(xu).to(where)
        lam_t = torch.from_numpy(lam).to(where)
        ivf = tis.build_blocked_ivf(xu_t, lam_t, cents.to(where), assign,
                                    slab_dtype=DTYPES[dt])
        kw = dict(certify=certify)
        if certify and dt != "f32":
            kw.update(rescore_corpus=xu_t, rescore_lambdas=lam_t)
        res = tis.blocked_ivf_search(
            ivf, torch.from_numpy(qn).to(where), lam_t[rows], TAU, 15,
            n_probe=8, **kw)
        out[str(where)] = [r.cpu().numpy() for r in res]
    got, ref = out[str(dev)], out["cpu"]
    assert topk_disagreements(got[1], got[0], ref[1], ref[0], TOL) == []
    if certify:
        assert np.array_equal(got[2], ref[2]) and got[2].mean() >= 0.85


def test_certified_bf16_topk65_on_card(dev):
    """Certified serving over bf16 slabs at topk 65 from n_probe 4 with
    n_widen 2 (K6 at pools 260, 520 and 1,040, its wide route) on the card
    against the same serving on the CPU (tests/test_torch_ivf_wide.py's
    corpus)."""
    rng = np.random.default_rng(5)
    sizes = [128] * 16 + [512] * 4
    base = rng.normal(size=(len(sizes), 16)) * 2.0
    items = (base[np.repeat(np.arange(len(sizes)), sizes)]
             + 0.25 * rng.normal(size=(sum(sizes), 16))).astype(np.float32)
    gp = {"eps": 0.9, "k": 6, "topk": 10, "p": 2.0, "sigma": 0.3}
    queries = np.concatenate([items[rng.choice(128, 8, replace=False)],
                              items[2048 + rng.choice(512, 8,
                                                      replace=False)]]) * 1.02
    out = {}
    for where in ("cpu", "cuda"):
        a, gl = ArrowSpaceBuilder.build(gp, items, device=where)
        a.enable_ivf(n_clusters=64, slab_dtype=torch.bfloat16)
        wide = ivf_scan.WIDE_LAUNCHES
        out[where] = a.search_batch(queries, gl, TAU, topk=65,
                                    mode="certified", n_probe=4, n_widen=2)
        if where == "cuda":
            assert ivf_scan.WIDE_LAUNCHES >= wide + 3
    (ci, cv), (gi, gv) = out["cpu"], out["cuda"]
    assert gi.shape == (16, 65)
    assert topk_disagreements(gv, gi, cv, ci, TOL) == []


def test_certified_and_stream_on_card(dev):
    rng = np.random.default_rng(77)
    base = rng.normal(size=(40, 32))
    items = (np.repeat(base, 50, axis=0)
             + 0.15 * rng.normal(size=(2000, 32))).astype(np.float32)
    gp = {"eps": 0.9, "k": 6, "topk": 10, "p": 2.0, "sigma": 0.3}
    a, gl = ArrowSpaceBuilder.build(gp, items)
    a.enable_ivf(n_clusters=40)
    queries = np.concatenate([items[rng.choice(2000, 24, replace=False)]
                              * 1.02, rng.normal(size=(8, 32))])
    launches = ivf_scan.LAUNCHES
    ci, cv = a.search_batch(queries, gl, TAU, mode="certified", n_probe=8)
    assert ivf_scan.LAUNCHES > launches
    ei, ev = a.search_batch(queries, gl, TAU, mode="exact")
    assert topk_disagreements(cv, ci, ev, ei, TOL) == []
    stream = a.serving_stream(gl, TAU, depth=2)
    for b in (queries[:16], queries[16:]):
        stream.submit(b)
    got = stream.finish()
    for (si, sv, _rate), b in zip(got, (queries[:16], queries[16:])):
        bi, bv = a.search_batch(b, gl, TAU, mode="certified")
        assert np.array_equal(si, bi) and np.array_equal(sv, bv)
