"""The CUDA kernels of subtile serving — K3 (subtile max), K4b (top-S
select), K5 (gather and score) and K4a (pool cut) — against their plain
PyTorch versions on the card, at small and ragged shapes; subtile_search
on the kernels against subtile_search on the plain versions; and the wide
lists of K1 and K2 (k up to 256; the wide lists past 256 are held in
tests/test_torch_gpu_ivf.py).

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


@pytest.mark.parametrize("rows,cols,m", [
    (1, 64, 1), (9, 1000, 16), (300, 4992, 16), (5, 16384, 64),
    (33, 700, 100), (8, 300, 256)])
def test_extract_ids_kernel_matches_plain(dev, rows, cols, m):
    rng = np.random.default_rng(rows * cols + m)
    score = torch.from_numpy(_tied_scores(rng, rows, cols, cols // 8)).to(dev)
    got = extract.extract_ids(score, m)
    torch.cuda.synchronize()
    assert torch.equal(got, extract.extract_ids_plain(score, m))


@pytest.mark.parametrize("rows,cols,m", [
    (1, 64, 1), (9, 1024, 30), (300, 1024, 30), (17, 128, 48),
    (4, 4096, 200), (6, 300, 256)])
def test_extract_pool_kernel_matches_plain(dev, rows, cols, m):
    rng = np.random.default_rng(rows * cols + m + 1)
    score = _tied_scores(rng, rows, cols, cols // 8)
    cand = np.stack([rng.permutation(4 * cols)[:cols] for _ in range(rows)])
    cand = cand.astype(np.int32)
    masked = score < -1.0e5
    score[masked] = np.float32(-1.0e6) - cand[masked].astype(np.float32)
    score_t = torch.from_numpy(score).to(dev)
    cand_t = torch.from_numpy(cand).to(dev)
    got = extract.extract_pool(score_t, cand_t, m)
    torch.cuda.synchronize()
    assert torch.equal(got, extract.extract_pool_plain(score_t, cand_t, m))


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


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_block_max_bitwise(dev, dt):
    """K3's maximum of a subtile equals, bit for bit, the best of phase b's
    blended scores over the subtile's real rows (K5 + the PyTorch blend)."""
    n_real, f, q = 3000, 96, 70
    rng, xu, lam = _corpus(dev, 9, 8192, f, _dtype(dt), n_real)
    qn = torch.from_numpy(_unit(rng, q, f)).to(dev).to(xu.dtype)
    lamq = torch.from_numpy(rng.uniform(0.05, 0.3, q).astype(np.float32))
    lamq = lamq.to(dev)
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
    best = score.view(q, real, 64).amax(dim=2)
    assert torch.equal(best.view(torch.int32),
                       sub[:, :real].contiguous().view(torch.int32))


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
