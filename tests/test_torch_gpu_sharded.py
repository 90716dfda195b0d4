"""The sharded path's kernel launches on the card: K1's ring step
(ops/cuda/knn.py::knn_visit) against its plain version and bit for bit
against one K1 scan of the whole corpus, from either rank's side of a
two-block ring (visiting ids above and below the rows, padded visiting
blocks, ties across blocks, lists past 128); and the card's Lloyd, whose
assignment products and fixed-point sums give the same bits for any split
of the rows (parallel/sharded.py's reduction).

Every test here needs an NVIDIA GPU with nvcc: they are marked ``gpu`` and
skip without one.  This file imports no jax; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_sharded.py
"""

import numpy as np
import pytest
import torch

from pyarrowspace_tpu_torch.ops.cuda import knn
from pyarrowspace_tpu_torch.ops.cuda.compare import topk_disagreements
from pyarrowspace_tpu_torch.reduction import pipeline

pytestmark = pytest.mark.gpu

TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _corpus(n, f, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(np.float32)
    x[n // 2: n // 2 + 40] = x[:40]          # ties across the two blocks
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("k", [7, 25, 200])
@pytest.mark.parametrize("rank", [0, 1])
def test_ring_step_lists_bitwise_one_scan(dev, k, rank):
    """Two ring steps (the self block, then the other block, seeded) give
    one K1 scan's lists bit for bit; rank 1's visiting ids lie below its
    rows (the MinLex merge of seeded launches); the second block holds 37
    padding rows."""
    n_loc, f = 640, 48
    n = 2 * n_loc - 37
    xu = _corpus(n, f)
    full_d, full_i = knn.knn_scan(torch.from_numpy(xu).to(dev), k, 1.2)
    blocks = np.zeros((2 * n_loc, f), np.float32)
    blocks[:n] = xu
    own = torch.from_numpy(blocks[rank * n_loc:(rank + 1) * n_loc]).to(dev)
    other = torch.from_numpy(blocks[(1 - rank) * n_loc:
                                    (2 - rank) * n_loc]).to(dev)
    rows = min(n_loc, n - rank * n_loc)
    cols = min(n_loc, n - (1 - rank) * n_loc)
    d0, i0 = knn.knn_visit(own.contiguous(), n_loc, rows, rows, k, 1.2,
                           row_id0=rank * n_loc, col_id0=rank * n_loc)
    buf = torch.cat([own, other]).contiguous()
    args = (buf, n_loc, rows, cols, k, 1.2)
    kw = dict(row_id0=rank * n_loc, col_id0=(1 - rank) * n_loc,
              seed=(d0, i0))
    d, i = knn.knn_visit(*args, **kw)
    dp, ip = knn.visit_plain(*args, **kw)
    assert topk_disagreements(d.cpu(), i.cpu(), dp.cpu(), ip.cpu(),
                              TOL) == []
    lo = rank * n_loc
    assert torch.equal(d.view(torch.int32),
                       full_d[lo:lo + rows].view(torch.int32))
    assert torch.equal(i, full_i[lo:lo + rows])


def test_lloyd_is_split_invariant(dev):
    """The assignment of a row and the fixed-point centroid sums do not
    depend on how the rows are split: the halves' int64 sums add up to
    the whole's, bit for bit."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    x = torch.randn((50_000, 64), generator=gen, device=dev) * 12.0
    c = x[:200].clone()
    a, d2 = pipeline._assign_argmin_dist(x, c)
    a1, d1 = pipeline._assign_argmin_dist(x[:21_000], c)
    a2, e2 = pipeline._assign_argmin_dist(x[21_000:], c)
    assert torch.equal(a, torch.cat([a1, a2]))
    assert torch.equal(d2.view(torch.int32), torch.cat([d1, e2]).view(
        torch.int32))
    scale = pipeline.fixed_point_scale(float(x.abs().max()), x.shape[0])
    whole = pipeline.fixed_point_sums(x, a, 200, scale)
    parts = (pipeline.fixed_point_sums(x[:21_000], a1, 200, scale)
             + pipeline.fixed_point_sums(x[21_000:], a2, 200, scale))
    assert torch.equal(whole, parts)
    new_c, _ = pipeline._centroid_update(x, a, c)
    cnts = torch.bincount(a.to(torch.int64), minlength=200)
    assert torch.equal(new_c, pipeline.centroids_from_sums(parts, cnts, c,
                                                           scale))
    ref = torch.zeros((200, 64), dtype=torch.float64, device=dev).index_add_(
        0, a.to(torch.int64), x.double())
    torch.testing.assert_close(
        new_c.double() * torch.clamp_min(cnts, 1)[:, None].double(),
        torch.where(cnts[:, None] > 0, ref,
                    c.double() * torch.clamp_min(cnts, 1)[:, None]),
        rtol=1e-6, atol=1e-3)
