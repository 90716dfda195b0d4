"""The fp32 product of K1, K1t and K2 (csrc/ffma_tile.cuh) on the card: its
two loaders (TMA where F and alignment allow, else register-staged), every
list bit for bit K5's fmaf chain (ops/cuda/compare.py: k5_distance for K1,
k5_blend for K2) and within the tolerance of the plain version, at F that
take either loader, n and Q off the 128-row tiles, float32 and bf16 rows,
row ranges that end before n, and k across both list layouts, the wide
route and the symmetric route; each route's launch at every k <= 128, its
shared memory as the Python mirror plans it.

Every test needs an NVIDIA GPU with nvcc (marked ``gpu``; they skip
without one).  This file imports no jax; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_product.py
"""

import numpy as np
import pytest
import torch

from pyarrowspace_tpu_torch.ops.cuda import ffma_tile, knn, knn_t, scan_topk
from pyarrowspace_tpu_torch.ops.cuda.compare import (k5_blend, k5_distance,
                                                     topk_disagreements)

pytestmark = pytest.mark.gpu

TOL = 1e-5
FS = [1, 3, 4, 31, 32, 33, 384, 768, 1000]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _unit(rng, n, f):
    x = rng.standard_normal((n, f)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _want_loader(f, itemsize):
    return "tma" if (f * itemsize) % 16 == 0 else "regs"


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("k", [25, 64, 65, 128, 200])
@pytest.mark.parametrize("f", FS)
def test_k1_bitwise_k5_on_both_loaders(dev, f, k):
    """The whole corpus (the symmetric route up to k 128) and a row range
    ending before n (rows past it zero in either loader): every distance
    K5's, the lists the plain version's within TOL, the range's lists the
    whole scan's bit for bit."""
    n = 1000
    xu = torch.from_numpy(_unit(np.random.default_rng(f * 7 + k), n, f))
    xu = xu.to(dev)
    d, i = knn.knn_scan(xu, k, 2.0)
    loader = _want_loader(f, 4)
    assert knn.LAST_ROUTE.endswith("/" + loader), knn.LAST_ROUTE
    if k <= knn.WIDE_K:
        assert knn.LAST_ROUTE == f"sym/{loader}"
    keep = i >= 0
    want = k5_distance(xu, slice(None), i)
    assert torch.equal(_bits(d)[keep], _bits(want)[keep])
    dp, ip = knn.knn_plain(xu, k, 2.0)
    assert not topk_disagreements(d.cpu().numpy(), i.cpu().numpy(),
                                  dp.cpu().numpy(), ip.cpu().numpy(), TOL)
    d2, i2 = knn.knn_scan(xu, k, 2.0, 130, 500)
    assert knn.LAST_ROUTE.endswith("/" + loader)
    assert torch.equal(i2, i[130:630])
    assert torch.equal(_bits(d2), _bits(d[130:630]))


@pytest.mark.parametrize("k", [25, 65, 200])
@pytest.mark.parametrize("f", FS)
def test_k1t_bitwise_k1(dev, f, k):
    n = 700
    xu = torch.from_numpy(_unit(np.random.default_rng(f + k), n, f)).to(dev)
    d, i = knn.knn_scan(xu, k, 2.0, 0, 390)
    dt, it = knn_t.knn_scan_t(xu, k, 2.0, 0, 390)
    assert knn_t.LAST_ROUTE.endswith("/" + _want_loader(f, 4))
    assert torch.equal(i, it)
    assert torch.equal(_bits(d), _bits(dt))


@pytest.mark.parametrize("k", [25, 128, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("f", FS)
def test_k2_bitwise_k5_blend_on_both_loaders(dev, f, dtype, k):
    """Q 130 queries over n 3,000 rows (neither a multiple of 128): every
    score K5's cosine blended, the lists the plain version's within TOL."""
    n, q = 3000, 130
    rng = np.random.default_rng(f * 3 + k)
    xu = torch.from_numpy(_unit(rng, n, f)).to(dev).to(getattr(torch, dtype))
    qn = torch.from_numpy(_unit(rng, q, f)).to(dev)
    lam = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)).to(dev)
    lamq = torch.from_numpy(rng.uniform(0, 1, q).astype(np.float32)).to(dev)
    i, s = scan_topk.lambda_search(xu, lam, qn, lamq, 0.62, k)
    if dtype == "bfloat16" and f % 8 == 0:
        # bf16 rows TMA could read take the tensor-core route, where K5's
        # tensor-core route is the witness.
        assert scan_topk.LAST_ROUTE.startswith("tc/"), scan_topk.LAST_ROUTE
    else:
        assert scan_topk.LAST_ROUTE.endswith(
            "/" + _want_loader(f, xu.element_size())), scan_topk.LAST_ROUTE
    assert bool((i >= 0).all())
    want = k5_blend(xu, lam, qn, lamq, 0.62, i)
    assert torch.equal(_bits(s), _bits(want))
    ip, sp = scan_topk.scan_plain(xu, lam, qn, lamq, 0.62, k)
    assert not topk_disagreements(s.cpu().numpy(), i.cpu().numpy(),
                                  sp.cpu().numpy(), ip.cpu().numpy(), TOL)


def _route_launch(route, k, f, dev):
    """One launch of ``route`` with lists of k on a small corpus of width f;
    returns the kernel's route name."""
    rng = np.random.default_rng(k)
    xu = torch.from_numpy(_unit(rng, 300, f)).to(dev)
    if route == "knn":
        knn.knn_scan(xu, k, 2.0, 10, 200)
        return knn.LAST_ROUTE
    if route == "knn_sym":
        knn.knn_scan(xu, k, 2.0)
        return knn.LAST_ROUTE
    if route == "knn_t":
        knn_t.knn_scan_t(xu, k, 2.0, 0, 200)
        return knn_t.LAST_ROUTE
    dtype = torch.bfloat16 if route == "scan_topk_bf16" else torch.float32
    lam = torch.rand(300, device=dev)
    scan_topk.lambda_search(xu.to(dtype), lam, xu[:130].contiguous(),
                            lam[:130].contiguous(), 0.5, k)
    return scan_topk.LAST_ROUTE


@pytest.mark.parametrize("f", [32, 33])
@pytest.mark.parametrize("route", ["knn", "knn_sym", "knn_t", "scan_topk",
                                   "scan_topk_bf16"])
def test_every_route_launches_at_every_k(dev, route, f):
    """Each route launches at every k <= 128 (the launcher raises when its
    shared memory passes the card's 232,448 bytes a block), on the loader
    F picks (32: TMA, 33: register-staged)."""
    for k in range(1, 129):
        name = _route_launch(route, k, f, dev)
        if route == "scan_topk_bf16" and f % 8 == 0:
            # The tensor-core route, not the fp32 product's.
            assert name.startswith("tc/"), (k, name)
            continue
        itemsize = 2 if route == "scan_topk_bf16" else 4
        assert name.endswith("/" + _want_loader(f, itemsize)), (k, name)
        if route == "knn_sym":
            assert name.startswith("sym/"), (k, name)
    torch.cuda.synchronize()


@pytest.mark.parametrize("tma", [True, False])
def test_launcher_plans_equal_the_mirror(dev, tma):
    """The C launchers' shared-memory plans (knn_plan, knn_t_plan,
    scan_topk_plan) equal ops/cuda/ffma_tile.py's at every k <= 128 and on
    the wide route, within a block's 232,448 bytes."""
    for k in list(range(1, 129)) + [129, 200, 1024]:
        wide = k > ffma_tile.MAX_NARROW
        pairs = [(knn.kernel_plan(k, False, tma),
                  ffma_tile.route_plan("knn_wide" if wide else "knn", k,
                                       tma)),
                 (knn_t.kernel_plan(k, tma),
                  ffma_tile.route_plan("knn_wide" if wide else "knn_t", k,
                                       tma)),
                 (scan_topk.kernel_plan(k, tma),
                  ffma_tile.route_plan(
                      "scan_topk_wide" if wide else "scan_topk", k, tma))]
        if not wide:
            pairs.append((knn.kernel_plan(k, True, tma),
                          ffma_tile.route_plan("knn_sym", k, tma)))
        for got, want in pairs:
            assert got == want, (k, got, want)
            assert 0 < got["bytes"] <= ffma_tile.SMEM_LIMIT


def test_tma_on_an_unaligned_shape_fails_the_launch(dev):
    """The launcher takes the loader it is given: TMA asked for on F 3 (rows
    of 12 bytes) fails with cudaErrorInvalidValue, never another loader."""
    n, f, k = 300, 3, 5
    xu = torch.from_numpy(_unit(np.random.default_rng(3), n, f)).to(dev)
    out_d = torch.full((n, k), 2.0, device=dev)
    out_i = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    lib = knn._lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = [xu.data_ptr(), n, f, 0, n, 1.0, k, 0, 0, None, 0, 1, 0, None,
            out_d.data_ptr(), out_i.data_ptr()]
    assert lib.knn_launch(*args, 1, 0, stream) == 1
    assert lib.knn_launch(*args, 0, 0, stream) == 0
    torch.cuda.synchronize()
