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

@pytest.mark.parametrize("k", [15, 60, 129, 200, 256, 257, 300, 1024,
                               K_LONG])
@pytest.mark.parametrize("f", [384, 385, 768])
def test_scan_int8_kernel_equals_plain(dev, k, f):
    """F 384 and 768 take the tensor-core route, F 385 the SIMT route; the
    lists are wide past 256, and on the tensor-core route past what fits
    beside its stages (130 at F 384, 82 at F 768)."""
    xu, qn, lam, lamq = _scan_case(dev, k + f, 6000, 70, f)
    xq, sc = quantize_rows(xu)
    qq, qs = quantize_rows(qn)
    tc = f % 16 == 0
    assert scan_int8.tensor_core_route(xq, qq) is tc
    wide = scan_int8.wide_lists(k, f, tc)
    assert wide == (k > (256 if not tc else 130 if f == 384 else 82))
    launches, tc_launches = scan_int8.LAUNCHES, scan_int8.TC_LAUNCHES
    wide_launches = scan_int8.WIDE_LAUNCHES
    i, s = scan_int8.scan_int8(xq, sc, lam, qq, qs, lamq, TAU, k)
    torch.cuda.synchronize()
    assert scan_int8.LAUNCHES == launches + 1
    assert scan_int8.TC_LAUNCHES == tc_launches + tc
    assert scan_int8.WIDE_LAUNCHES == wide_launches + wide
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


def _simt_view(x):
    """The same int8 rows as a view with a row stride past F: K7 takes its
    SIMT route on it."""
    wide = torch.zeros((x.shape[0], x.shape[1] + 16), dtype=x.dtype,
                       device=x.device)
    wide[:, :x.shape[1]] = x
    return wide[:, :x.shape[1]]


def _both_routes(xq, sc, lam, qq, qs, lamq, k):
    """K7 on its tensor-core route and on its SIMT route, and the plain
    version, on the same values."""
    assert scan_int8.route_name(xq, qq) == "tensor-core"
    xs = _simt_view(xq)
    assert scan_int8.route_name(xs, qq) == "simt"
    tc = scan_int8.TC_LAUNCHES
    got = scan_int8.scan_int8(xq, sc, lam, qq, qs, lamq, TAU, k)
    simt = scan_int8.scan_int8(xs, sc, lam, qq, qs, lamq, TAU, k)
    torch.cuda.synchronize()
    assert scan_int8.TC_LAUNCHES == tc + 1
    plain = scan_int8.scan_int8_plain(xq, sc, lam, qq, qs, lamq, TAU, k)
    return got, simt, plain


def _bitwise(a, b):
    return (torch.equal(a[0], b[0])
            and torch.equal(a[1].view(torch.int32), b[1].view(torch.int32)))


@pytest.mark.parametrize("k", [15, 60, 129, 200, 300, 1024, K_LONG])
@pytest.mark.parametrize("f", [384, 768])
def test_scan_int8_tensor_core_route_equals_simt(dev, k, f):
    xu, qn, lam, lamq = _scan_case(dev, 3 * k + f, 9000, 300, f)
    xq, sc = quantize_rows(xu)
    qq, qs = quantize_rows(qn)
    got, simt, plain = _both_routes(xq, sc, lam, qq, qs, lamq, k)
    assert _bitwise(got, plain) and _bitwise(got, simt)


def test_scan_int8_tensor_core_ties_at_the_kth(dev):
    """200 copies of each of 50 rows with equal lambdas: the kth slot cuts
    through a group of equal scores, across tiles and splits; the
    smallest ids win on both routes."""
    rng = np.random.default_rng(12)
    base = _unit(rng, 50, 384)
    xu = torch.from_numpy(np.repeat(base, 200, axis=0)).to(dev)
    lam = torch.full((10_000,), 0.25, device=dev)
    qn = torch.from_numpy(np.concatenate([base, base, base[:30]])).to(dev)
    lamq = torch.full((130,), 0.25, device=dev)
    xq, sc = quantize_rows(xu)
    qq, qs = quantize_rows(qn)
    for k in (60, 130, 131, 250, 257, 700):
        got, simt, plain = _both_routes(xq, sc, lam, qq, qs, lamq, k)
        assert _bitwise(got, plain) and _bitwise(got, simt)


def test_scan_int8_tensor_core_lambdas_off_the_fast_path(dev):
    """Lambdas of +-1.5 * 2^63 (1 + |lam_i - lam_q| past 2^64, beyond the
    fast reciprocal) and +-inf take tile::blend's division in the warps
    that meet them; the bits stay the plain version's.  (inf - inf:
    test_scan_int8_nan_scores_enter_no_list.)"""
    xu, qn, lam, lamq = _scan_case(dev, 5, 5000, 200, 384)
    lam[::97] = 1.5 * 2.0 ** 63
    lam[7::401] = -float("inf")
    lamq[3] = -1.5 * 2.0 ** 63
    lamq[150] = float("inf")
    xq, sc = quantize_rows(xu)
    qq, qs = quantize_rows(qn)
    got, simt, plain = _both_routes(xq, sc, lam, qq, qs, lamq, 60)
    assert _bitwise(got, plain) and _bitwise(got, simt)


@pytest.mark.parametrize("k", [60, 200, 4997])
def test_scan_int8_nan_scores_enter_no_list(dev, k):
    """Lambdas +inf on 52 items and on queries 3 and 150: inf - inf gives
    NaN scores, which enter no list on either route nor in the plain
    version; at k 4,997 those two queries' lists end in 49 unfilled slots
    (-3e38, -1)."""
    xu, qn, lam, lamq = _scan_case(dev, 5, 5000, 200, 384)
    lam[::97] = float("inf")
    lamq[[3, 150]] = float("inf")
    xq, sc = quantize_rows(xu)
    qq, qs = quantize_rows(qn)
    got, simt, plain = _both_routes(xq, sc, lam, qq, qs, lamq, k)
    assert _bitwise(got, plain) and _bitwise(got, simt)
    assert not torch.isnan(got[1]).any()
    tail = max(0, k - (5000 - 52))
    assert int((got[0] < 0).sum()) == 2 * tail


@pytest.mark.parametrize("k", [60, 200])
def test_scan_int8_tensor_core_query_chunks(dev, monkeypatch, k):
    """Partial lists past the scratch budget: one split, then chunks of
    130 queries (a partial 128-query block each), one launch each; a wide
    list's (k 200) staging rows count with its lists."""
    xu, qn, lam, lamq = _scan_case(dev, 8, 5000, 300, 384)
    xq, sc = quantize_rows(xu)
    qq, qs = quantize_rows(qn)
    staged = scan_int8._SROW if scan_int8.wide_lists(k, 384, True) else 0
    assert (staged > 0) == (k == 200)
    monkeypatch.setattr(scan_topk, "SCRATCH_BYTES", 130 * (k + staged) * 8)
    launches = scan_int8.TC_LAUNCHES
    got = scan_int8.scan_int8(xq, sc, lam, qq, qs, lamq, TAU, k)
    torch.cuda.synchronize()
    assert scan_int8.TC_LAUNCHES - launches == 3
    plain = scan_int8.scan_int8_plain(xq, sc, lam, qq, qs, lamq, TAU, k)
    assert _bitwise(got, plain)


@pytest.mark.parametrize("k", [60, 700])
def test_scan_int8_signed_zero_scores_tie_by_id(dev, k):
    """Zero corpus rows with lambda +inf and row scales +-1 at tau 1.5
    score (0 * qscale * srow) * 1.5 + (-0.5) * 0: +0.0 or -0.0, one score
    for the order, tied by id, each keeping its bits; k 700 cuts through
    them (wide lists on both routes)."""
    xu, qn, lam, lamq = _scan_case(dev, 13, 3000, 150, 384)
    xq, sc = quantize_rows(xu)
    qq, qs = quantize_rows(qn)
    zero = torch.arange(3000, device=dev) % 3 == 0
    xq[zero] = 0
    sc[zero] = torch.where(torch.arange(1000, device=dev) % 2 == 0, 1.0, -1.0)
    lam[zero] = float("inf")
    tc = scan_int8.TC_LAUNCHES
    got = scan_int8.scan_int8(xq, sc, lam, qq, qs, lamq, 1.5, k)
    simt = scan_int8.scan_int8(_simt_view(xq), sc, lam, qq, qs, lamq, 1.5, k)
    torch.cuda.synchronize()
    assert scan_int8.TC_LAUNCHES == tc + 1
    # On the CPU: a stable sort there keeps -0.0 and +0.0 in id order,
    # which torch.sort on the card does not promise.
    plain = scan_int8.scan_int8_plain(
        *(t.cpu() for t in (xq, sc, lam, qq, qs, lamq)), 1.5, k)
    got = tuple(t.cpu() for t in got)
    assert _bitwise(got, plain) and _bitwise(got, tuple(t.cpu() for t in simt))
    zeros = plain[1] == 0
    if k == 700:
        assert bool(torch.signbit(plain[1][zeros]).any())
        assert bool((~torch.signbit(plain[1][zeros])).any())


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
    s, i = ivf_scan.ivf_scan(*args, k=k, q_block=qb, cap=cap,
                             tiles=ivf_scan.slab_tiles(ids, cap))
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


def _tied_unit(rng, n, f):
    """Rows with four entries of +-0.5: unit norm and dot products exact in
    float32 and bfloat16 whatever the summation order, so scores tie
    exactly and kernel and plain version agree bit for bit."""
    x = np.zeros((n, f), np.float32)
    for r in range(n):
        x[r, rng.choice(f, size=4, replace=False)] = rng.choice([-.5, .5], 4)
    return x


@pytest.mark.parametrize("splits", ["wave", "one"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [129, 256, 257, 1024, K_LONG])
def test_scan_kernel_k5000(dev, monkeypatch, k, dtype, splits):
    """K2's wide route (k > 128): bit for bit the plain version on rows
    tied at every rank, lambdas on a grid of 0.25 (exact blends), +inf on
    items and on one query (NaN scores, a list short of k at k 5,000),
    over as many corpus splits as fill a wave, or one (the scratch cut
    to one split's lists)."""
    rng = np.random.default_rng(k)
    n, q = 6000, 70
    xu = torch.from_numpy(_tied_unit(rng, n, 16)).to(dev)
    xu = xu.to(getattr(torch, dtype))
    qn = torch.from_numpy(_tied_unit(rng, q, 16)).to(dev)
    lam = torch.from_numpy(rng.choice([0.25, 0.5, 0.75], n)
                           .astype(np.float32)).to(dev)
    lamq = torch.from_numpy(rng.choice([0.25, 0.5], q)
                            .astype(np.float32)).to(dev)
    lam[::5] = float("inf")
    lamq[3] = float("inf")
    if splits == "one":
        monkeypatch.setattr(scan_topk, "SCRATCH_BYTES",
                            q * 8 * (k + scan_topk._STAGE))
    want = scan_topk.plan_splits(n, q, k, dev)
    assert (want[0] == 1) == (splits == "one") and want[1] == q
    assert scan_topk.route_name(n, q, k, dev) == f"wide/S{want[0]}"
    wide = scan_topk.WIDE_LAUNCHES
    i, s = scan_topk.lambda_search(xu, lam, qn, lamq, TAU, k)
    torch.cuda.synchronize()
    assert scan_topk.WIDE_LAUNCHES == wide + 1
    ip, sp = scan_topk.scan_plain(xu, lam, qn, lamq, TAU, k)
    assert torch.equal(i, ip)
    assert torch.equal(s.view(torch.int32), sp.view(torch.int32))
    assert int((i[3] < 0).sum()) == max(0, k - (n - n // 5))


def test_scan_kernel_query_chunks(dev, monkeypatch):
    """Partial lists past the scratch budget: fewer splits, then query
    chunks, one launch each (a wide list's staging rows of 896 keys count
    with its lists); the lists stay the plain version's."""
    xu, qn, lam, lamq = _scan_case(dev, 3, 3000, 200, 16)
    monkeypatch.setattr(scan_topk, "SCRATCH_BYTES",
                        60 * 8 * (500 + scan_topk._STAGE))
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
