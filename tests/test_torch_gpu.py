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
from pyarrowspace_tpu_torch.ops.cuda import knn, scan_topk
from pyarrowspace_tpu_torch.ops.cuda.compare import topk_disagreements

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


@pytest.mark.parametrize("n,f,k,eps", [
    (1, 8, 1, 0.9), (3, 3, 2, 1.0), (65, 33, 7, 0.9), (300, 32, 7, 0.9),
    (1000, 100, 25, 1.31), (130, 70, 64, 2.0)])
def test_knn_kernel_matches_plain(dev, n, f, k, eps):
    xu = torch.from_numpy(_unit(np.random.default_rng(n), n, f)).to(dev)
    d, i = knn.knn_scan(xu, k, eps)
    torch.cuda.synchronize()
    dp, ip = knn.knn_plain(xu, k, eps)
    assert d.shape == (n, k) and i.dtype == torch.int32
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


@pytest.mark.parametrize("n,q,f,k", [
    (3, 1, 3, 3), (100, 1, 24, 10), (1000, 7, 100, 15), (5000, 130, 64, 15),
    (777, 65, 33, 64)])
def test_scan_kernel_matches_plain(dev, n, q, f, k):
    rng = np.random.default_rng(n + q)
    xu = torch.from_numpy(_unit(rng, n, f)).to(dev)
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
