"""The k-NN variants on the card: K1t (csrc/knn_t.cu) and K1's seeded,
rotated and permuted walks (csrc/knn.cu) against their plain versions and
bit for bit against the default scan; the extend and the deterministic
Lloyd sums.

Every test here needs an NVIDIA GPU with nvcc: they are marked ``gpu`` and
skip without one.  This file imports no jax; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_variants.py
"""

import numpy as np
import pytest
import torch

from pyarrowspace_tpu_torch import ArrowSpaceBuilder
from pyarrowspace_tpu_torch.graph.suggest import suggest_graph_params
from pyarrowspace_tpu_torch.io import load_index, save_index
from pyarrowspace_tpu_torch.ops.cuda import knn, knn_t
from pyarrowspace_tpu_torch.ops.cuda.compare import topk_disagreements
from pyarrowspace_tpu_torch.ops.distance import (VARIANTS,
                                                 knn_graph_candidates,
                                                 projection_order)
from pyarrowspace_tpu_torch.reduction import pipeline
from pyarrowspace_tpu_torch.utils.stats import segment_sum

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
    """Rows with four entries of +-0.5 and duplicated rows: exact distance
    ties everywhere, the d = 1.0 plateau kept at eps >= 1."""
    x = np.zeros((n, f), np.float32)
    for r in range(n):
        x[r, rng.choice(f, size=4, replace=False)] = rng.choice([-.5, .5], 4)
    x[n // 2:] = x[: n - n // 2]
    return x


def _agree(d, i, dp, ip):
    return topk_disagreements(d.cpu(), i.cpu(), dp.cpu(), ip.cpu(), TOL) == []


@pytest.mark.parametrize("n,f,k,eps", [
    (1, 8, 1, 0.9), (65, 33, 7, 0.9), (300, 32, 7, 0.9),
    (1000, 100, 25, 1.31), (130, 70, 64, 2.0), (700, 24, 300, 1.5)])
def test_knn_t_matches_plain_and_k1(dev, n, f, k, eps):
    xu = torch.from_numpy(_unit(np.random.default_rng(n), n, f)).to(dev)
    before = knn_t.LAUNCHES
    d, i = knn_t.knn_scan_t(xu, k, eps)
    torch.cuda.synchronize()
    assert knn_t.LAUNCHES == before + 1
    assert d.shape == (n, k) and i.dtype == torch.int32
    assert _agree(d, i, *knn.knn_plain(xu, k, eps))
    d1, i1 = knn.knn_scan(xu, k, eps)
    assert torch.equal(d, d1) and torch.equal(i, i1)


def test_knn_t_row_range(dev):
    xu = torch.from_numpy(_unit(np.random.default_rng(5), 700, 48)).to(dev)
    d, i = knn_t.knn_scan_t(xu, 9, 0.95, row_start=130, row_count=300)
    d_all, i_all = knn.knn_scan(xu, 9, 0.95)
    assert torch.equal(d, d_all[130:430]) and torch.equal(i, i_all[130:430])


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("k,eps", [(5, 0.8), (20, 1.0), (300, 1.0)])
def test_variants_bitwise_on_exact_ties(dev, variant, k, eps):
    xu = torch.from_numpy(_tied_unit(np.random.default_rng(3), 600, 16))
    xu = xu.to(dev)
    d0, i0 = knn.knn_plain(xu, k, eps)
    d, i = knn_graph_candidates(xu, k, eps, variant=variant)
    assert torch.equal(i, i0) and torch.equal(d, d0), variant


@pytest.mark.parametrize("variant", VARIANTS)
def test_variants_bitwise_on_clusters(dev, variant):
    rng = np.random.default_rng(61)
    cents = rng.normal(size=(12, 32))
    x = (cents[rng.integers(0, 12, size=3000)]
         + 0.3 * rng.normal(size=(3000, 32))).astype(np.float32)
    xu = torch.nn.functional.normalize(torch.from_numpy(x), dim=1).to(dev)
    d0, i0 = knn_graph_candidates(xu, 10, 0.9, variant="rowmajor")
    d, i = knn_graph_candidates(xu, 10, 0.9, variant=variant)
    assert torch.equal(d, d0) and torch.equal(i, i0)
    assert _agree(d, i, *knn.knn_plain(xu, 10, 0.9))


def test_perm_partial_rows_and_plain(dev):
    xu = torch.from_numpy(_unit(np.random.default_rng(9), 900, 40)).to(dev)
    perm = projection_order(xu)
    xp = xu[perm].contiguous()
    d, i = knn.knn_scan(xp, 8, 0.95, 128, 300, diag_start=True, perm=perm)
    d0, i0 = knn.knn_scan(xu, 8, 0.95)
    rows = perm[128:428]
    assert torch.equal(d[rows], d0[rows]) and torch.equal(i[rows], i0[rows])
    dp, ip = knn.knn_plain_reordered(xu, 8, 0.95, perm)
    assert _agree(d[rows], i[rows], dp[rows], ip[rows])


@pytest.mark.parametrize("n_old,k", [(1, 5), (63, 5), (64, 7), (450, 9),
                                     (300, 280)])
def test_seeded_scan_equals_full_scan(dev, n_old, k):
    xu = torch.from_numpy(_unit(np.random.default_rng(n_old), 520, 24))
    xu = xu.to(dev)
    d_all, i_all = knn.knn_scan(xu, k, 1.2)
    seed = knn.knn_scan(xu[:n_old].contiguous(), k, 1.2)   # old x old
    before = knn.SEEDED_LAUNCHES
    d, i = knn.knn_scan(xu, k, 1.2, 0, n_old, col_start=n_old, seed=seed)
    assert knn.SEEDED_LAUNCHES == before + 1
    assert torch.equal(d, d_all[:n_old]) and torch.equal(i, i_all[:n_old])
    dp, ip = knn.knn_plain(xu, k, 1.2, slice(0, n_old), n_old, seed)
    assert _agree(d, i, dp, ip)


def test_extend_equals_rebuild_and_persists(dev, tmp_path):
    rng = np.random.default_rng(4)
    old = rng.standard_normal((5000, 32)).astype(np.float32) * 12
    new = rng.standard_normal((300, 32)).astype(np.float32) * 12
    gp = {"eps": 1.31, "k": 25, "topk": 15, "p": 2.0, "sigma": 0.535}
    a, g = ArrowSpaceBuilder.build(gp, old)
    ea, eg = ArrowSpaceBuilder.extend(a, g, new)
    ra, rg = ArrowSpaceBuilder.build(gp, np.concatenate([old, new]))
    for x, y in ((ea._knn_dist, ra._knn_dist), (ea._knn_idx, ra._knn_idx),
                 (eg.neighbor_indices, rg.neighbor_indices),
                 (eg.neighbor_weights, rg.neighbor_weights),
                 (ea._lambdas, ra._lambdas), (ea._tau_star, ra._tau_star)):
        assert torch.equal(x, y)
    path = str(tmp_path / "idx.npz")
    save_index(path, ea, eg)
    la, lg = load_index(path)
    assert la.device.type == "cuda"
    q = np.concatenate([old[:5], new[:5]]) * 1.01
    for mine, theirs in zip(la.search_batch(q, lg, 0.62),
                            ea.search_batch(q, eg, 0.62)):
        np.testing.assert_array_equal(mine, theirs)


def test_lloyd_sums_deterministic(dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    x = torch.randn((200_000, 64), generator=gen, device=dev)
    a = torch.randint(0, 300, (200_000,), generator=gen, device=dev)
    s1, s2 = segment_sum(x, a, 300), segment_sum(x, a, 300)
    assert torch.equal(s1, s2)
    ref = torch.zeros((300, 64), dtype=torch.float64, device=dev).index_add_(
        0, a, x.double())
    torch.testing.assert_close(s1.double(), ref, rtol=0, atol=1e-3)
    c = x[:300].clone()
    runs = [pipeline._lloyd(x, c, 3) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


def test_suggestions_run_on_the_card(dev):
    """An array with no device runs on the card and recommends what the
    same rows recommend as a CUDA tensor."""
    rng = np.random.default_rng(6)
    items = (rng.normal(size=(2000, 3)) @ rng.normal(size=(3, 64))
             + 0.01 * rng.normal(size=(2000, 64)))
    rec = suggest_graph_params(items, sample=1024)
    assert rec == suggest_graph_params(torch.from_numpy(items).to(dev),
                                       sample=1024)
    assert 2 <= rec["intrinsic_dim"] <= 5
