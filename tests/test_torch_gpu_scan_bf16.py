"""K2 over bfloat16 rows on its tensor-core route (csrc/tc_scan.cuh with
scan_topk.cu's BlendTc) on the card: every score bit for bit K5's
tensor-core cosine blended (ops/cuda/compare.py::k5_blend), the lists the
plain version's within TOL, at F that keep the queries resident or stream
them, n and Q off the 128-row tiles, k across narrow and wide lists, NaN
lambdas; the route taken exactly where subtile_max.tensor_core_route holds
(an unaligned view, ragged F and float32 rows take the SIMT route, and keep
their own witness); the C launcher's plan equal to ops/cuda/tc_scan.py's.

Every test needs an NVIDIA GPU with nvcc (marked ``gpu``; they skip
without one).  This file imports no jax; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_scan_bf16.py
"""

import numpy as np
import pytest
import torch

from pyarrowspace_tpu_torch.ops.cuda import scan_int8, scan_topk, tc_scan
from pyarrowspace_tpu_torch.ops.cuda.compare import (k5_blend,
                                                     topk_disagreements)
from pyarrowspace_tpu_torch.ops.cuda.subtile_max import tensor_core_route

pytestmark = pytest.mark.gpu

# Kernel and plain version sum the same exact bf16 products in different
# orders (tensor core against a float32 matmul): a few float32 ulps of a
# score below 2.
TOL = 1e-5
TAU = 0.62
FS = [8, 64, 72, 384, 392, 768, 1024]
KS = [1, 15, 64, 65, 128, 129, 200, 1024]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _unit(rng, n, f):
    x = rng.standard_normal((n, f)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _case(dev, seed, n, q, f):
    rng = np.random.default_rng(seed)
    xu = torch.from_numpy(_unit(rng, n, f)).to(dev).bfloat16()
    qn = torch.from_numpy(_unit(rng, q, f)).to(dev)
    lam = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)).to(dev)
    lamq = torch.from_numpy(rng.uniform(0, 1, q).astype(np.float32)).to(dev)
    return xu, qn, lam, lamq


def _bits(t):
    return t.view(torch.int32)


def _check(xu, qn, lam, lamq, k, want_tc):
    """One launch: its route, every score K5's bit for bit, the lists the
    plain version's within TOL."""
    tc0, launches = scan_topk.TC_LAUNCHES, scan_topk.LAUNCHES
    i, s = scan_topk.lambda_search(xu, lam, qn, lamq, TAU, k)
    torch.cuda.synchronize()
    assert scan_topk.TC_LAUNCHES - tc0 == (scan_topk.LAUNCHES - launches
                                           if want_tc else 0)
    assert scan_topk.LAST_ROUTE.startswith("tc/") is want_tc, \
        scan_topk.LAST_ROUTE
    assert scan_topk.LAST_ROUTE == scan_topk.route_of(
        xu, qn.to(xu.dtype).contiguous(), i.shape[1])
    full = i >= 0
    want = k5_blend(xu, lam, qn, lamq, TAU, i.clamp_min(0))
    assert torch.equal(_bits(s)[full], _bits(want)[full])
    ip, sp = scan_topk.scan_plain(xu, lam, qn, lamq, TAU, i.shape[1])
    assert topk_disagreements(s.cpu().numpy(), i.cpu().numpy(),
                              sp.cpu().numpy(), ip.cpu().numpy(), TOL) == []
    return i, s


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("f", FS)
def test_tc_route_bitwise_k5_and_plain(dev, f, k):
    """n 2,000 + (F mod 7) rows and Q 130 queries (neither a multiple of
    128), on the route, lists and query placement tc_scan.plan gives."""
    n, q = 2000 + f % 7, 130
    xu, qn, lam, lamq = _case(dev, f * 31 + k, n, q, f)
    plan = tc_scan.plan(f, k, 2, True)
    wide = scan_topk.WIDE_LAUNCHES
    i, _ = _check(xu, qn, lam, lamq, k, True)
    assert bool((i >= 0).all())
    assert scan_topk.WIDE_LAUNCHES - wide == plan["wide"]
    assert scan_topk.LAST_ROUTE.endswith("/stream") is plan["stream"]


@pytest.mark.parametrize("f,k", [(384, 15), (768, 15), (64, 300)])
def test_tc_route_nan_lambdas(dev, f, k):
    """+inf lambdas on items and on query 1: its scores against them are
    NaN (inf - inf) and enter no list; the others score tau * cos."""
    n, q = 1500, 70
    xu, qn, lam, lamq = _case(dev, f + k, n, q, f)
    lam[::7] = float("inf")
    lamq[1] = float("inf")
    i, s = _check(xu, qn, lam, lamq, k, True)
    assert not bool(torch.isnan(s).any())
    assert not bool((i[1] % 7 == 0).any())


@pytest.mark.parametrize("f", [64, 384])
def test_unaligned_view_takes_the_simt_route(dev, f):
    """A bf16 view whose base is 2 bytes off 16 fails the shared predicate:
    the SIMT route, its scores K5's SIMT fmaf chain's."""
    n, q = 1000, 65
    xu, qn, lam, lamq = _case(dev, f, n, q, f)
    flat = torch.empty(n * f + 1, dtype=torch.bfloat16, device=dev)
    view = flat[1:].view(n, f)
    view.copy_(xu)
    assert not tensor_core_route(view, qn.bfloat16())
    _check(view, qn, lam, lamq, 15, False)
    scan_topk.lambda_search(xu, lam, qn, lamq, TAU, 15)
    assert scan_topk.LAST_ROUTE.startswith("tc/")


@pytest.mark.parametrize("f,dtype", [(70, torch.bfloat16),
                                     (385, torch.bfloat16),
                                     (64, torch.float32),
                                     (384, torch.float32)])
def test_ragged_and_float32_rows_take_the_simt_route(dev, f, dtype):
    n, q = 900, 33
    xu, qn, lam, lamq = _case(dev, f + 5, n, q, f)
    _check(xu.to(dtype), qn, lam, lamq, 15, False)


def test_tc_launches_at_every_k(dev):
    """The route launches at every k up to 300 at F 384 (resident) and 768
    (streamed), narrow and wide lists alike, within its shared memory."""
    rng = np.random.default_rng(3)
    for f in (384, 768):
        xu = torch.from_numpy(_unit(rng, 400, f)).to(dev).bfloat16()
        lam = torch.rand(400, device=dev)
        for k in list(range(1, 300, 7)) + [82, 83, 130, 131, 256, 257]:
            i, s = scan_topk.lambda_search(
                xu, lam, xu[:130].float(), lam[:130].contiguous(), 0.5, k)
            assert scan_topk.LAST_ROUTE.startswith("tc/"), (f, k)
            assert bool((i >= 0).all())
    torch.cuda.synchronize()


def test_launcher_plan_equals_the_mirror(dev):
    """scan_topk_tc_plan and scan_int8_tc_wide (C) equal tc_scan.plan
    (Python) at every F and k of the CPU tests' grid, within 232,448
    bytes."""
    lib8 = scan_int8._lib()
    for f in (8, 64, 72, 384, 392, 512, 640, 648, 768, 1024):
        for k in (1, 15, 64, 82, 83, 128, 129, 130, 131, 200, 256, 257,
                  1024):
            got = scan_topk.tc_kernel_plan(f, k)
            assert got == tc_scan.plan(f, k, 2, True), (f, k, got)
            assert got["bytes"] <= tc_scan.SMEM_LIMIT
            if f % 16 == 0:
                assert bool(lib8.scan_int8_tc_wide(f, k)) == \
                    scan_int8.wide_lists(k, f, True), (f, k)


def test_as_serving_view_takes_the_tc_route(dev):
    """Exact search over an as_serving view, through the entry point, on
    the tensor-core route."""
    from pyarrowspace_tpu_torch import ArrowSpaceBuilder
    rng = np.random.default_rng(8)
    items = torch.from_numpy(rng.standard_normal((3000, 64)).astype(
        np.float32)).to(dev)
    aspace, gl = ArrowSpaceBuilder.build(
        {"eps": 1.5, "k": 8, "topk": 10, "p": 2.0, "sigma": 0.5}, items)
    view = aspace.as_serving()
    tc0 = scan_topk.TC_LAUNCHES
    i, s = view.search_batch(items[:100] * 1.01, gl, TAU)
    assert scan_topk.TC_LAUNCHES == tc0 + 1
    assert i.shape == (100, 10) and np.isfinite(s).all()
