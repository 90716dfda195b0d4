"""K8, the routed energy scan (csrc/scan_energy.cu), on the card: its lists
the plain version's (ops/cuda/scan_energy.py::energy_plain, float32 with
TF32 off) within TOL, ids equal but where scores tie within TOL, at n, Q and
F off the 128-row tiles, on both loaders, narrow and wide lists, routed
and exact, with pools short of k; at the CVE deployment's shape (313,841 x
384, K 40 centroids and the tail, k 20) against the plain version and the
TF32 control that TOL must refuse; and search_energy_batch on a card-built
energy index against the same index served on the CPU, with K8 launched on
every call.

Every test needs an NVIDIA GPU with nvcc (marked ``gpu``; they skip
without one).  This file imports no jax; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_energy.py
"""

import numpy as np
import pytest
import torch

import pyarrowspace_tpu_torch as pt
from pyarrowspace_tpu_torch.graph.feature import build_feature_laplacian
from pyarrowspace_tpu_torch.io.convert import ENERGY_KEYS, state_from_numpy
from pyarrowspace_tpu_torch.ops.cuda import scan_energy
from pyarrowspace_tpu_torch.ops.cuda.compare import topk_disagreements
from pyarrowspace_tpu_torch.ops.rayleigh import rayleigh_batch

pytestmark = pytest.mark.gpu

# The kernel's cross term is one fmaf chain, the plain version's a float32
# matmul: D = e_q + e_i - 2 qL . x cancels terms of ~1e6 at the CVE shape,
# so D moves by a few units and D' = D / (D + tau*) by ~1e-6; a score
# (w_l + w_d at most) by less than TOL.  TF32 moves D' by ~1e-4.
TOL = 2e-5
W_L, W_D = 1.0, 0.5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _case(dev, seed, n, q, f, n_keys=41, scale=12.0):
    """Item and query terms of an energy search over a random binary
    feature Laplacian, and random routes (keys in [0, n_keys), bitmaps
    with about half the bits set and the last key's always)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, f), generator=g, device=dev) * scale
    q_rows = torch.randint(0, n, (q,), generator=g, device=dev)
    qs = x[q_rows] + 0.25 * scale * torch.randn((q, f), generator=g,
                                                device=dev)
    nodes = torch.randn((112, f), generator=g, device=dev)
    _, lap, _ = build_feature_laplacian(nodes, k_f=15)
    e = rayleigh_batch(x, lap)
    eq = rayleigh_batch(qs, lap)
    ql = qs @ lap
    lam = torch.rand((n,), generator=g, device=dev)
    lamq = torch.rand((q,), generator=g, device=dev)
    ts = torch.median(e)
    keys = torch.randint(0, n_keys, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    hit = torch.rand((q, scan_energy.bitmap_bytes(n_keys) * 8),
                     generator=g, device=dev) < 0.5
    hit[:, n_keys - 1] = True
    hit[:, n_keys:] = False
    w = 2 ** torch.arange(8, device=dev, dtype=torch.int32)
    bitmap = (hit.view(q, -1, 8).int() * w).sum(2).to(torch.uint8)
    return x, lam, e, ql, lamq, eq, ts, keys, bitmap


def _agree(got, ref, tol=TOL):
    """Rows whose lists disagree beyond near-ties; -1 slots must match."""
    gi, gv = (t.cpu().numpy() for t in got)
    ri, rv = (t.cpu().numpy() for t in ref)
    assert np.array_equal(gi < 0, ri < 0)
    assert np.all(np.isneginf(gv[gi < 0]))
    bad = []
    for r in range(gi.shape[0]):
        m = gi[r] >= 0
        if topk_disagreements(gv[r][m][None], gi[r][m][None], rv[r][m][None],
                              ri[r][m][None], tol):
            bad.append(r)
    return bad


@pytest.mark.parametrize("n,q,f", [(1000, 130, 384), (4097, 300, 64),
                                   (777, 65, 30), (129, 1, 8)])
@pytest.mark.parametrize("k", [1, 20, 65, 129, 300])
@pytest.mark.parametrize("routed", [False, True])
def test_energy_scan_matches_plain(dev, n, q, f, k, routed):
    x, lam, e, ql, lamq, eq, ts, keys, bitmap = _case(dev, n + k, n, q, f)
    route = (keys, bitmap) if routed else (None, None)
    launches = scan_energy.LAUNCHES
    got = scan_energy.energy_scan(x, lam, e, ql, lamq, eq, ts, W_L, W_D, k,
                                  *route)
    assert scan_energy.LAUNCHES > launches
    assert scan_energy.LAST_ROUTE.startswith("routed/" if routed
                                             else "exact/")
    assert scan_energy.LAST_ROUTE.endswith(
        "/tma" if (4 * f) % 16 == 0 else "/regs")
    ref = scan_energy.energy_plain(x, lam, e, ql, lamq, eq, ts, W_L, W_D,
                                   min(k, n), *route)
    assert got[0].shape == ref[0].shape == (q, min(k, n))
    assert _agree(got, ref) == []


@pytest.mark.parametrize("n_keys,lam_scale", [(100, 1.0), (41, 2.0 ** 62)])
def test_wide_bitmaps_and_large_lambdas(dev, n_keys, lam_scale):
    """Bitmaps of 100 keys (13 bytes a row); lambdas up to 2^62, where
    1 + |lam_i - lam_q| is still in recip_rn's range."""
    x, lam, e, ql, lamq, eq, ts, keys, bitmap = _case(dev, 9, 3000, 200, 384,
                                                      n_keys=n_keys)
    lam, lamq = lam * lam_scale, lamq * lam_scale
    got = scan_energy.energy_scan(x, lam, e, ql, lamq, eq, ts, W_L, W_D, 20,
                                  keys, bitmap)
    ref = scan_energy.energy_plain(x, lam, e, ql, lamq, eq, ts, W_L, W_D, 20,
                                   keys, bitmap)
    assert bitmap.shape[1] == -(-n_keys // 8)
    assert _agree(got, ref) == []


def test_all_ones_bitmap_is_the_exact_scan(dev):
    x, lam, e, ql, lamq, eq, ts, keys, bitmap = _case(dev, 7, 3000, 200,
                                                      384)
    exact = scan_energy.energy_scan(x, lam, e, ql, lamq, eq, ts, W_L, W_D,
                                    20)
    ones = scan_energy.energy_scan(x, lam, e, ql, lamq, eq, ts, W_L, W_D,
                                   20, keys, torch.full_like(bitmap, 255))
    assert torch.equal(exact[0], ones[0]) and torch.equal(exact[1], ones[1])


def test_ties_go_to_the_smaller_id(dev):
    """Duplicated rows score alike: each list holds the lower copy
    first."""
    x, lam, e, ql, lamq, eq, ts, keys, bitmap = _case(dev, 3, 2048, 64,
                                                      384)
    x[1024:] = x[:1024]
    lam[1024:] = lam[:1024]
    e[1024:] = e[:1024]
    keys[1024:] = keys[:1024]
    i, v = scan_energy.energy_scan(x, lam, e, ql, lamq, eq, ts, W_L, W_D,
                                   20, keys, bitmap)
    i, v = i.cpu().numpy(), v.cpu().numpy()
    tied = v[:, 1:] == v[:, :-1]
    assert tied.any() and np.all(np.diff(i, axis=1)[tied] > 0)


def test_cve_shape_against_plain_and_tf32(dev):
    """313,841 x 384, keys over 40 centroids and the tail, k 20: within
    TOL of the plain version in float32; the plain version in TF32 is not
    (the control)."""
    x, lam, e, ql, lamq, eq, ts, keys, bitmap = _case(dev, 11, 313_841, 512,
                                                      384)
    got = scan_energy.energy_scan(x, lam, e, ql, lamq, eq, ts, W_L, W_D, 20,
                                  keys, bitmap)
    assert scan_energy.LAST_ROUTE.startswith("routed/narrow/")
    m = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        ref = scan_energy.energy_plain(x, lam, e, ql, lamq, eq, ts, W_L,
                                       W_D, 20, keys, bitmap)
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32 = scan_energy.energy_plain(x, lam, e, ql, lamq, eq, ts, W_L,
                                        W_D, 20, keys, bitmap)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
    assert _agree(got, ref) == []
    gap = (got[1] - ref[1]).abs().max().item()
    tf32_gap = (tf32[1] - ref[1]).abs().max().item()
    print(f"K8 against plain: {gap:.3e}; TF32 against plain: "
          f"{tf32_gap:.3e}")
    assert gap <= TOL < tf32_gap


@pytest.mark.parametrize("k", [20, 3000])
def test_search_energy_batch_on_card_matches_cpu(dev, k):
    """A card-built energy index and the same index served on the CPU:
    routed (k 20) and past the pools (k 3,000: the exact scan through an
    all-ones bitmap), K8 launched once a call, routed every time."""
    rng = np.random.default_rng(4)
    items = (rng.normal(size=(6000, 64)) * 12).astype(np.float32)
    ep = {"optical_tokens": 16, "eta": 0.05, "steps": 4, "candidate_m": 4}
    gp = {"eps": 1.31, "k": 25, "topk": 15, "p": 2.0, "sigma": 0.535}
    card, gl = pt.ArrowSpaceBuilder.build_energy(items, ep, gp)
    queries = items[rng.choice(6000, 50)] + rng.normal(size=(50, 64)) * 3
    before = scan_energy.LAUNCHES
    i, s = card.search_energy_batch(queries, gl, k)
    assert scan_energy.LAUNCHES - before == 1
    assert scan_energy.LAST_ROUTE.startswith("routed/narrow/" if k == 20
                                             else "routed/wide/")
    arrays = {key: getattr(card, "_" + key) for key in (
        "data", "data_unit", "lambdas", "e_raw", "lap_f", "w_f", "tau_star",
        "centroids", "assignments")}
    arrays.update(nbr_idx=gl.neighbor_indices, nbr_w=gl.neighbor_weights,
                  degrees=gl.degrees)
    emaps = {key: getattr(card._energy_maps, key) for key in ENERGY_KEYS}
    host = {key: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for key, v in arrays.items()}
    cpu, gl_cpu = state_from_numpy(host, gl.params, "cpu", energy_maps={
        key: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
        for key, v in emaps.items()})
    ic, sc = cpu.search_energy_batch(queries, gl_cpu, k)
    assert topk_disagreements(s, i, sc, ic, TOL) == []
    assert i.min() >= 0 and np.all(np.isfinite(s))
