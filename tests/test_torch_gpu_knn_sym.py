"""K1's symmetric route (csrc/knn.cu, route "sym") on the card: against the
full walk and the plain version, bit for bit on ids and distances, at the
tile edges, over exact ties, an eps that masks part of each row, rows all
equal, and repeated launches; every other launch keeps its walk, and the C
launcher refuses the route outside the self-join of a whole corpus.

Every test here needs an NVIDIA GPU with nvcc: they are marked ``gpu`` and
skip without one.  This file imports no jax; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_knn_sym.py
"""

import numpy as np
import pytest
import torch

from pyarrowspace_tpu_torch.ops.cuda import ffma_tile, knn
from pyarrowspace_tpu_torch.ops.cuda.compare import topk_disagreements

pytestmark = pytest.mark.gpu

# Kernel and plain version sum the products in different orders.
TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _tied(rng, n, f):
    """Unit rows whose products are exact in any order (four entries of
    +-0.5, or one of +-1 below 4 features), a third of them duplicated:
    exact distance ties, +0.0 among them."""
    x = np.zeros((n, f), np.float32)
    m = 4 if f >= 4 else 1
    for r in range(n):
        x[r, rng.choice(f, size=m, replace=False)] = rng.choice(
            [-1.0 / np.sqrt(m), 1.0 / np.sqrt(m)], m)
    x[n - n // 3:] = x[:n // 3]
    return x


def _unit(rng, n, f):
    x = rng.standard_normal((n, f)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _sym_and_full(xu, k, eps):
    """The symmetric route's lists and the full walk's, each launch counted
    on its route."""
    before = knn.SYM_LAUNCHES
    assert knn.route_name(xu.shape[0], xu.shape[0], k, xu.device) == "sym"
    sym = knn.knn_scan(xu, k, eps)
    assert knn.SYM_LAUNCHES == before + 1
    full = knn.knn_scan(xu, k, eps, symmetric=False)
    assert knn.SYM_LAUNCHES == before + 1
    torch.cuda.synchronize()
    return sym, full


def _same_bits(a, b):
    return torch.equal(a[1], b[1]) and torch.equal(
        a[0].view(torch.int32), b[0].view(torch.int32))


@pytest.mark.parametrize("f", [3, 384, 768])
@pytest.mark.parametrize("k", [1, 25, 64, 65, 128])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 1000, 4097, 20_000])
def test_sym_equals_full_walk_and_plain(dev, n, k, f):
    """Tied rows: bit for bit the full walk and the plain version; N(0, 1)
    rows: bit for bit the full walk, within TOL of the plain version."""
    rng = np.random.default_rng(n + k + f)
    xu = torch.from_numpy(_tied(rng, n, f)).to(dev)
    sym, full = _sym_and_full(xu, k, 1.0)
    assert _same_bits(sym, full)
    assert _same_bits(sym, knn.knn_plain(xu, k, 1.0))
    xu = torch.from_numpy(_unit(rng, n, f)).to(dev)
    sym, full = _sym_and_full(xu, k, 1.31)
    assert _same_bits(sym, full)
    dp, ip = knn.knn_plain(xu, k, 1.31)
    assert topk_disagreements(sym[0].cpu(), sym[1].cpu(), dp.cpu(),
                              ip.cpu(), TOL) == []


@pytest.mark.parametrize("n,f,k", [(4097, 384, 25), (20_000, 96, 64),
                                   (1000, 8, 128)])
def test_sym_eps_masks_part_of_each_row(dev, n, f, k):
    """eps just under the least kth distance of the first 256 rows: lists
    end in (2.0, -1) entries, and keep their nearer ones."""
    rng = np.random.default_rng(n + f)
    for x in (_tied(rng, n, f), _unit(rng, n, f)):
        xu = torch.from_numpy(x).to(dev)
        kth = knn.knn_plain(xu, k, 2.0, rows=slice(0, 256))[0][:, -1].min()
        eps = float(np.nextafter(np.float32(kth.item()), np.float32(-1)))
        sym, full = _sym_and_full(xu, k, eps)
        assert _same_bits(sym, full)
        assert bool((sym[1] == -1).any()) and bool((sym[1] >= 0).any())
        dp, ip = knn.knn_plain(xu, k, eps)
        assert topk_disagreements(sym[0].cpu(), sym[1].cpu(), dp.cpu(),
                                  ip.cpu(), TOL) == []


@pytest.mark.parametrize("n,k", [(129, 25), (4097, 128), (20_000, 64)])
def test_sym_all_rows_equal(dev, n, k):
    """Every distance +0.0 but self: each row keeps the k smallest other
    ids, from its own walk and the blocks below it alike."""
    xu = torch.zeros((n, 48), device=dev)
    xu[:, 5] = 1.0
    sym, full = _sym_and_full(xu, k, 1.0)
    assert _same_bits(sym, full)
    rows = torch.arange(n, device=dev)[:, None]
    want = torch.arange(k, device=dev)[None, :]
    want = (want + (want >= rows)).to(torch.int32)
    assert torch.equal(sym[1], want)
    assert torch.equal(sym[0].view(torch.int32),
                       torch.zeros_like(sym[0]).view(torch.int32))


def test_sym_repeats_its_bits(dev):
    """Locks and the blocks' order of arrival change no result: five
    launches on tie-heavy data give the same bits."""
    xu = torch.from_numpy(_tied(np.random.default_rng(4), 20_000, 16)).to(dev)
    first = knn.knn_scan(xu, 25, 1.0)
    for _ in range(4):
        assert _same_bits(knn.knn_scan(xu, 25, 1.0), first)
    assert _same_bits(first, knn.knn_scan(xu, 25, 1.0, symmetric=False))


def test_other_launches_keep_their_walk(dev):
    """Row ranges, the extend's scans, diag_start, perm, lists past 128 and
    the ring's knn_visit launch no symmetric walk."""
    rng = np.random.default_rng(6)
    n, k = 1000, 25
    xu = torch.from_numpy(_tied(rng, n, 16)).to(dev)
    perm = torch.from_numpy(rng.permutation(n)).to(dev)
    seed = knn.knn_plain(xu[:700].contiguous(), k, 1.0)
    before = knn.SYM_LAUNCHES
    knn.knn_scan(xu, k, 1.0, 0, 500)
    knn.knn_scan(xu, k, 1.0, 700, 300)
    knn.knn_scan(xu, k, 1.0, 0, 700, col_start=700, seed=seed)
    knn.knn_scan(xu, k, 1.0, diag_start=True)
    knn.knn_scan(xu[perm].contiguous(), k, 1.0, diag_start=True, perm=perm)
    knn.knn_scan(xu, 129, 1.0)
    knn.knn_visit(xu, n, n, n, k, 1.0, row_id0=0, col_id0=0)
    torch.cuda.synchronize()
    assert knn.SYM_LAUNCHES == before


def test_launcher_refuses_sym_outside_the_self_join(dev):
    """knn_launch with sym set and a row range, a column start, a seed,
    diag_start, a split or a wide list: cudaErrorInvalidValue (1)."""
    n, f, k = 300, 16, 5
    xu = torch.from_numpy(_tied(np.random.default_rng(1), n, f)).to(dev)
    out_d = torch.full((n, 200), 2.0, device=dev)
    out_i = torch.full((n, 200), -1, dtype=torch.int32, device=dev)
    part = torch.empty((knn.sym_words(n, 200) * 4, 2), dtype=torch.int32,
                       device=dev)
    lib = knn._lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    tma = ffma_tile.loader_of(xu) == "tma"

    def launch(row_start=0, rows=n, kk=k, col_start=0, diag=0, seeded=0,
               splits=1):
        return lib.knn_launch(xu.data_ptr(), n, f, row_start, rows, 1.0, kk,
                              col_start, diag, None, seeded, splits, 1,
                              part.data_ptr(), out_d.data_ptr(),
                              out_i.data_ptr(), int(tma), 0, stream)

    assert launch() == 0
    for bad in (dict(row_start=1, rows=n - 1), dict(rows=n - 1),
                dict(col_start=128), dict(diag=1), dict(seeded=1),
                dict(splits=2), dict(kk=129)):
        assert launch(**bad) == 1, bad
    torch.cuda.synchronize()
