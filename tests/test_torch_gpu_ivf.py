"""Kernel K6 (the blocked-IVF probe scan) against its plain PyTorch
version on the card over float32, bfloat16 and float16 slabs; the wide
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


def _scan_both(slabs, lam, ids, qn, lamq, probe, k, qb, cap):
    launches = ivf_scan.LAUNCHES
    s, i = ivf_scan.ivf_scan(slabs, lam, ids, qn, lamq, probe, TAU, k=k,
                             q_block=qb, cap=cap)
    torch.cuda.synchronize()
    assert ivf_scan.LAUNCHES == launches + 1
    sp, ip = ivf_scan.ivf_scan_plain(slabs, lam, ids, qn, lamq, probe, TAU,
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


@pytest.mark.parametrize("f,qb,n_probe,cap,k", [
    (33, 8, 1, 128, 10),      # unaligned rows: one value a load
    (768, 16, 8, 128, 64),    # the north-star width
    (384, 5, 3, 192, 300),    # an odd block, a wide list
    (64, 32, 2, 64, 128),     # the widest block
    (40, 8, 4, 128, 512),     # every slot of every probed slab
])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_ivf_scan_kernel_shapes(dev, f, qb, n_probe, cap, k, dt):
    rng = np.random.default_rng(f + qb + k)
    n_clusters = max(n_probe, 5)
    slabs, lam, ids = _slabs(rng, n_clusters, cap, f, DTYPES[dt], dev)
    qn, lamq, probe = _queries(rng, 4, qb, n_clusters, n_probe, f, dev)
    s, i, sp, ip = _scan_both(slabs, lam, ids, qn, lamq, probe, k, qb, cap)
    np.testing.assert_allclose(s, sp, rtol=0, atol=TOL)
    assert topk_disagreements(s, i, sp, ip, TOL) == []
    # Unfilled slots are (-3e38, -1), as the TPU kernel leaves them.
    assert np.all((i < 0) == (s <= -3.0e38))


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


def test_ivf_scan_kernel_rejects(dev):
    rng = np.random.default_rng(0)
    slabs, lam, ids = _slabs(rng, 40, 128, 16, torch.float32, dev)
    qn, lamq, probe = _queries(rng, 2, 8, 40, 33, 16, dev)
    with pytest.raises(ValueError, match="must be in"):
        ivf_scan.ivf_scan(slabs, lam, ids, qn, lamq, probe, TAU,
                          k=33 * 128 + 1, q_block=8, cap=128)
    with pytest.raises(TypeError):
        ivf_scan.ivf_scan(slabs.double(), lam, ids, qn, lamq, probe, TAU,
                          k=5, q_block=8, cap=128)
    with pytest.raises(ValueError, match="q_block"):
        qn2, lamq2, probe2 = _queries(rng, 1, 40, 40, 2, 16, dev)
        ivf_scan.ivf_scan(slabs, lam, ids, qn2, lamq2, probe2, TAU, k=5,
                          q_block=40, cap=128)


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
