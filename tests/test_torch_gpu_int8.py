"""Kernel K7 (the int8 candidate scan) against its plain PyTorch version on
the card, bit for bit; K2 over a bfloat16 corpus; K6 at F 4,096 (the query
block staged a feature slab at a time); K1, K2, K4a, K4b and K6 at lists of
5,000; and the int8, gather-IVF, hybrid and energy searches on the card
against the same index served on the CPU.

Every test here needs an NVIDIA GPU with nvcc: they are marked ``gpu`` and
skip without one.  This file imports no jax; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_int8.py
"""

import numpy as np
import pytest
import torch

from pyarrowspace_tpu_torch import ArrowSpaceBuilder, GraphParams
from pyarrowspace_tpu_torch.io import state_from_numpy
from pyarrowspace_tpu_torch.ops.cuda import (extract, ivf_scan, knn,
                                             scan_int8, scan_topk)
from pyarrowspace_tpu_torch.ops.cuda.compare import topk_disagreements
from pyarrowspace_tpu_torch.ops.quantize import quantize_rows

pytestmark = pytest.mark.gpu

# Kernel and plain version sum float products in different orders (K7's
# int8 sums are exact: there the tolerance is 0).
TOL = 1e-5
TAU = 0.62
K_LONG = 5000


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _unit(rng, n, f):
    x = rng.standard_normal((n, f)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _scan_case(dev, seed, n, q, f):
    rng = np.random.default_rng(seed)
    xu = torch.from_numpy(_unit(rng, n, f)).to(dev)
    qn = torch.from_numpy(_unit(rng, q, f)).to(dev)
    lam = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)).to(dev)
    lamq = torch.from_numpy(rng.uniform(0, 1, q).astype(np.float32)).to(dev)
    return xu, qn, lam, lamq


# -- K7 -------------------------------------------------------------------------

@pytest.mark.parametrize("k", [15, 60, 300, K_LONG])
@pytest.mark.parametrize("f", [384, 385, 768])
def test_scan_int8_kernel_equals_plain(dev, k, f):
    xu, qn, lam, lamq = _scan_case(dev, k + f, 6000, 70, f)
    xq, sc = quantize_rows(xu)
    qq, qs = quantize_rows(qn)
    launches = scan_int8.LAUNCHES
    i, s = scan_int8.scan_int8(xq, sc, lam, qq, qs, lamq, TAU, k)
    torch.cuda.synchronize()
    assert scan_int8.LAUNCHES == launches + 1
    ip, sp = scan_int8.scan_int8_plain(xq, sc, lam, qq, qs, lamq, TAU, k)
    assert i.shape == (70, k) and i.dtype == torch.int32
    assert torch.equal(i, ip)
    assert torch.equal(s.view(torch.int32), sp.view(torch.int32))


def test_scan_int8_kernel_exact_ties_and_entry_point(dev):
    """Duplicated rows tie exactly: (score desc, id asc), as the plain
    version; lambda_search_quantized quantizes the queries on the card."""
    rng = np.random.default_rng(11)
    base = _unit(rng, 50, 32)
    xu = torch.from_numpy(np.repeat(base, 40, axis=0)).to(dev)
    lam = torch.full((2000,), 0.25, device=dev)
    qn = torch.from_numpy(base[:9]).to(dev)
    lamq = torch.full((9,), 0.25, device=dev)
    xq, sc = quantize_rows(xu)
    i, s = scan_int8.lambda_search_quantized(xq, sc, lam, qn, lamq, 0.5, 60)
    ip, sp = scan_int8.scan_int8_plain(xq, sc, lam, *quantize_rows(qn),
                                       lamq, 0.5, 60)
    assert torch.equal(i, ip) and torch.equal(s, sp)


# -- K2 over a bfloat16 corpus ---------------------------------------------------

@pytest.mark.parametrize("n,q,f,k", [(3000, 70, 384, 15), (777, 65, 33, 64),
                                     (5000, 9, 24, 300)])
def test_scan_kernel_bf16_matches_plain(dev, n, q, f, k):
    xu, qn, lam, lamq = _scan_case(dev, n + k, n, q, f)
    xb = xu.bfloat16()
    i, s = scan_topk.lambda_search(xb, lam, qn, lamq, TAU, k)
    torch.cuda.synchronize()
    ip, sp = scan_topk.scan_plain(xb, lam, qn, lamq, TAU, k)
    assert s.dtype == torch.float32
    assert topk_disagreements(s.cpu(), i.cpu(), sp.cpu(), ip.cpu(),
                              TOL) == []


# -- K6 at F 4,096 ----------------------------------------------------------------

def _slabs(rng, n_clusters, cap, f, dtype, dev):
    rows = n_clusters * cap
    slabs = torch.from_numpy(_unit(rng, rows, f)).to(dtype)
    ids = rng.permutation(4 * rows)[:rows].astype(np.int32)
    ids[rng.uniform(size=rows) > 0.8] = -1
    lam = rng.uniform(0.05, 0.3, rows).astype(np.float32)
    lam[ids < 0] = np.inf
    return (slabs.to(dev), torch.from_numpy(lam).to(dev),
            torch.from_numpy(ids).to(dev))


def _ivf_both(dev, rng, n_clusters, cap, f, dtype, qb, n_probe, k,
              n_blocks=3):
    slabs, lam, ids = _slabs(rng, n_clusters, cap, f, dtype, dev)
    qn = torch.from_numpy(_unit(rng, n_blocks * qb, f)).to(dev)
    lamq = torch.from_numpy(rng.uniform(0.05, 0.3, n_blocks * qb)
                            .astype(np.float32)).to(dev)
    probe = torch.from_numpy(np.stack(
        [rng.permutation(n_clusters)[:n_probe] for _ in range(n_blocks)])
        .astype(np.int32)).to(dev)
    args = (slabs, lam, ids, qn, lamq, probe, TAU)
    s, i = ivf_scan.ivf_scan(*args, k=k, q_block=qb, cap=cap)
    torch.cuda.synchronize()
    sp, ip = ivf_scan.ivf_scan_plain(*args, k=k, q_block=qb, cap=cap)
    return s.cpu(), i.cpu(), sp.cpu(), ip.cpu()


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qb,k", [(16, 15), (32, 300)])
def test_ivf_scan_kernel_f4096(dev, dt, qb, k):
    s, i, sp, ip = _ivf_both(dev, np.random.default_rng(qb + k), 8, 128,
                             4096, dt, qb, 4, k)
    np.testing.assert_allclose(s.numpy(), sp.numpy(), rtol=0, atol=TOL)
    assert topk_disagreements(s, i, sp, ip, TOL) == []


# -- lists of 5,000 ---------------------------------------------------------------

def test_knn_kernel_k5000(dev):
    xu = torch.from_numpy(_unit(np.random.default_rng(1), 6000, 24)).to(dev)
    d, i = knn.knn_scan(xu, K_LONG, 1.2, 0, 130)
    torch.cuda.synchronize()
    dp, ip = knn.knn_plain(xu, K_LONG, 1.2, rows=slice(0, 130))
    assert topk_disagreements(d.cpu(), i.cpu(), dp.cpu(), ip.cpu(), TOL) == []


def test_scan_kernel_k5000(dev):
    xu, qn, lam, lamq = _scan_case(dev, 2, 7000, 70, 32)
    i, s = scan_topk.lambda_search(xu, lam, qn, lamq, TAU, K_LONG)
    torch.cuda.synchronize()
    ip, sp = scan_topk.scan_plain(xu, lam, qn, lamq, TAU, K_LONG)
    assert topk_disagreements(s.cpu(), i.cpu(), sp.cpu(), ip.cpu(),
                              TOL) == []


def test_scan_kernel_query_chunks(dev, monkeypatch):
    """Partial lists past the scratch budget: fewer splits, then query
    chunks, one launch each; the lists stay the plain version's."""
    xu, qn, lam, lamq = _scan_case(dev, 3, 3000, 200, 16)
    monkeypatch.setattr(scan_topk, "SCRATCH_BYTES", 60 * 8 * 500)
    launches = scan_topk.LAUNCHES
    i, s = scan_topk.lambda_search(xu, lam, qn, lamq, TAU, 500)
    torch.cuda.synchronize()
    assert scan_topk.LAUNCHES - launches == 4
    ip, sp = scan_topk.scan_plain(xu, lam, qn, lamq, TAU, 500)
    assert topk_disagreements(s.cpu(), i.cpu(), sp.cpu(), ip.cpu(),
                              TOL) == []


def test_extract_kernels_m5000(dev):
    rng = np.random.default_rng(5)
    score = torch.from_numpy((rng.integers(0, 64, (5, 9000)) / 8.0)
                             .astype(np.float32)).to(dev)
    assert torch.equal(extract.extract_ids(score, K_LONG),
                       extract.extract_ids_plain(score, K_LONG))
    cand = np.stack([rng.permutation(27000)[:9000] for _ in range(5)])
    cand = torch.from_numpy(cand.astype(np.int32)).to(dev)
    assert torch.equal(extract.extract_pool(score, cand, K_LONG),
                       extract.extract_pool_plain(score, cand, K_LONG))


def test_ivf_scan_kernel_k5000(dev):
    s, i, sp, ip = _ivf_both(dev, np.random.default_rng(7), 12, 1024, 32,
                             torch.float32, 16, 8, K_LONG, n_blocks=2)
    np.testing.assert_allclose(s.numpy(), sp.numpy(), rtol=0, atol=TOL)
    assert topk_disagreements(s, i, sp, ip, TOL) == []


# -- the modes on the card against the same index on the CPU ----------------------

@pytest.fixture
def both_devices(dev):
    """One index built on the CPU in float32 and carried to the card, so
    both devices serve from the same arrays."""
    rng = np.random.default_rng(17)
    centers = rng.standard_normal((10, 24)) * 2.0
    items = (centers[rng.integers(0, 10, 1500)]
             + rng.standard_normal((1500, 24))).astype(np.float32)
    gp = {"eps": 0.9, "k": 8, "topk": 10, "p": 2.0, "sigma": 0.4}
    cpu, gl = ArrowSpaceBuilder.build(gp, items, device="cpu")
    cpu.enable_ivf(n_clusters=10)          # the same clustering on both
    arrays = {key: getattr(cpu, "_" + key) for key in (
        "data", "data_unit", "lambdas", "e_raw", "lap_f", "w_f", "tau_star",
        "centroids", "assignments")}
    arrays.update(nbr_idx=gl.neighbor_indices, nbr_w=gl.neighbor_weights,
                  degrees=gl.degrees)
    arrays = {key: v.numpy() for key, v in arrays.items()}
    params = GraphParams(eps=0.9, k=8, topk=10, p=2.0, sigma=0.4)
    card, gl_card = state_from_numpy(arrays, params, dev)
    queries = items[rng.choice(1500, 40)] * 1.01
    return items, queries, cpu, gl, card, gl_card


def test_int8_ivf_hybrid_on_card_match_cpu(both_devices):
    _, queries, cpu, gl, card, gl_card = both_devices
    launches = scan_int8.LAUNCHES
    for mode in ("int8", "ivf"):
        i, s = card.search_batch(queries, gl_card, TAU, mode=mode)
        ic, sc = cpu.search_batch(queries, gl, TAU, mode=mode)
        assert topk_disagreements(s, i, sc, ic, TOL) == [], mode
    assert scan_int8.LAUNCHES == launches + 1
    i, s = card.search_hybrid_batch(queries, gl_card, TAU)
    ic, sc = cpu.search_hybrid_batch(queries, gl, TAU)
    assert topk_disagreements(s, i, sc, ic, TOL) == []
    i, s = card.as_serving().search_batch(queries, gl_card, TAU)
    ic, sc = cpu.as_serving().search_batch(queries, gl, TAU)
    assert topk_disagreements(s, i, sc, ic, TOL) == []


def test_energy_on_card_matches_cpu(both_devices):
    items, queries, *_ = both_devices
    ep = {"optical_tokens": 12}
    gp = {"eps": 0.9, "k": 8, "topk": 10, "p": 2.0, "sigma": 0.4}
    cpu, gl = ArrowSpaceBuilder.build_energy(items, ep, gp, device="cpu")
    card, gl_card = ArrowSpaceBuilder.build_energy(items, ep, gp)
    assert card.device.type == "cuda" and gl_card.nnodes == gl.nnodes
    np.testing.assert_allclose(card.lambdas(), cpu.lambdas(), atol=1e-4)
    for k in (10, 1500):       # routed, then the exact fallback
        i, s = card.search_energy_batch(queries, gl_card, k)
        ic, sc = cpu.search_energy_batch(queries, gl, k)
        assert i.shape == ic.shape == (40, k)
        assert np.all(np.isfinite(s)) and i.min() >= 0
        overlap = np.mean([len(set(a) & set(b)) / k for a, b in zip(i, ic)])
        assert overlap >= 0.9
