"""The routes of K7, the int8 candidate scan (ops/cuda/scan_int8.py), on
the CPU.

On the card K7 takes its int8 tensor-core kernel (wgmma on s8, the
stages of csrc/wgmma_tile.cuh) or its SIMT kernel (__dp4a), by one
predicate, ``tensor_core_route``, from dtype, shape and alignment alone.
The tensor-core kernel reads the rows as they are, F zero-padded by TMA to
its 128-feature stages; the SIMT kernel reads them zero-padded to a
multiple of 4 features.  Zero features add nothing to an int32 sum, so
both equal the plain version bit for bit; here that is shown on the plain
version itself, with the kernel's split plan and a numpy model of the
tensor-core kernel's merge (each 128-item tile's scores filtered against
the query's kth as it stood before the tile, then offered in any order
under the (score desc, id asc) order).  Tolerances: none, every check is
exact."""

import numpy as np
import pytest
import torch

from pyarrowspace_tpu_torch.ops.cuda import scan_int8
from pyarrowspace_tpu_torch.ops.cuda.scan_topk import SCRATCH_BYTES
from pyarrowspace_tpu_torch.ops.quantize import quantize_rows

TAU = 0.62


def _case(seed, n, q, f):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(np.float32)
    qn = rng.standard_normal((q, f)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    qn /= np.linalg.norm(qn, axis=1, keepdims=True)
    xq, srow = quantize_rows(torch.from_numpy(x))
    qq, qscale = quantize_rows(torch.from_numpy(qn))
    lam = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))
    lamq = torch.from_numpy(rng.uniform(0, 1, q).astype(np.float32))
    return xq, srow, lam, qq, qscale, lamq


# -- the route predicate ----------------------------------------------------------

@pytest.mark.parametrize("f,want", [(384, True), (385, False), (768, True),
                                    (33, False), (16, True), (1024, True),
                                    (1040, False), (392, False)])
def test_route_by_width(f, want):
    xq = torch.zeros((256, f), dtype=torch.int8)
    qq = torch.zeros((5, f), dtype=torch.int8)
    assert scan_int8.tensor_core_route(xq, qq) is want
    assert scan_int8.route_name(xq, qq) == ("tensor-core" if want
                                            else "simt")


@pytest.mark.parametrize("shift_x,shift_q", [(1, 0), (0, 1), (8, 0),
                                             (16, 0), (0, 32), (16, 48)])
def test_route_needs_16_byte_aligned_bases(shift_x, shift_q):
    """TMA's 16-byte rule: a base 1 or 8 bytes off takes the SIMT route;
    a multiple of 16 bytes off stays on the tensor cores."""
    f = 384
    bx = torch.zeros(shift_x + 64 * f, dtype=torch.int8)
    bq = torch.zeros(shift_q + 3 * f, dtype=torch.int8)
    xq = bx[shift_x:].view(64, f)
    qq = bq[shift_q:].view(3, f)
    aligned = xq.data_ptr() % 16 == 0 and qq.data_ptr() % 16 == 0
    assert aligned is (shift_x % 16 == 0 and shift_q % 16 == 0)
    assert scan_int8.tensor_core_route(xq, qq) is aligned


def test_route_of_views_and_dtypes():
    f = 384
    xq = torch.zeros((64, f + 16), dtype=torch.int8)
    qq = torch.zeros((3, f), dtype=torch.int8)
    assert not scan_int8.tensor_core_route(xq[:, :f], qq)   # strided rows
    assert scan_int8.tensor_core_route(xq[:, :f].contiguous(), qq)
    assert not scan_int8.tensor_core_route(xq[:, :f].to(torch.uint8), qq)
    # Contiguous row slices keep 16-byte rows aligned.
    big = torch.zeros((100, f), dtype=torch.int8)
    assert scan_int8.tensor_core_route(big[3:], qq)


# -- zero features and the operands --------------------------------------------

@pytest.mark.parametrize("f,pad", [(24, 104), (385, 11), (384, 128),
                                   (37, 3)])
def test_zero_padding_leaves_the_plain_scan_bitwise(f, pad):
    xq, srow, lam, qq, qscale, lamq = _case(f, 700, 23, f)
    i0, s0 = scan_int8.scan_int8_plain(xq, srow, lam, qq, qscale, lamq,
                                       TAU, 40)
    xp = torch.nn.functional.pad(xq, (0, pad))
    qp = torch.nn.functional.pad(qq, (0, pad))
    i1, s1 = scan_int8.scan_int8_plain(xp, srow, lam, qp, qscale, lamq,
                                       TAU, 40)
    assert torch.equal(i0, i1)
    assert torch.equal(s0.view(torch.int32), s1.view(torch.int32))


def test_item_pairs_layout():
    n = 300
    srow = torch.arange(n, dtype=torch.float32) + 0.5
    lam = -torch.arange(n, dtype=torch.float32)
    pairs = scan_int8._item_pairs(srow, lam)
    assert pairs.shape == (384, 2) and pairs.dtype == torch.float32
    assert torch.equal(pairs[:n, 0], srow) and torch.equal(pairs[:n, 1], lam)
    assert not pairs[n:].any()
    # A thread's float4 j: (srow, lam) of items 2 p and 2 p + 1.
    quads = pairs.view(-1, 4)
    assert torch.equal(quads[7], torch.tensor([14.5, -14.0, 15.5, -15.0]))


# -- the split plan ----------------------------------------------------------------

@pytest.mark.parametrize("n,q,k,want", [(313_841, 4096, 60, 4),
                                        (1_000_000, 16_384, 60, 1),
                                        (1_000_000, 1024, 60, 15),
                                        (6000, 70, 5000, 47)])
def test_tensor_core_split_plan(monkeypatch, n, q, k, want):
    """The fewest splits whose grid of 128-query blocks fills its last wave
    of 132 SMs to 90% or more (one block an SM), each split non-empty."""
    monkeypatch.setattr(scan_int8, "sm_count", lambda index: 132)
    splits, q_chunk = scan_int8.plan_splits(n, q, k, torch.device("cpu"),
                                            tensor_core=True)
    n_tiles = -(-n // 128)
    per = -(-n_tiles // splits)
    assert (splits - 1) * per < n_tiles
    if want * q * k * 8 <= SCRATCH_BYTES:
        assert splits == want and q_chunk == q
    blocks = -(-min(q, q_chunk) // 128) * splits
    assert splits == n_tiles or 10 * blocks >= 9 * 132 * -(-blocks // 132)


# -- a model of the tensor-core kernel's merge -----------------------------------

def _tc_model(xq, srow, lam, qq, qscale, lamq, k, splits):
    """The tensor-core kernel's lists in numpy: per split, per 128-item
    tile, the scores of the plain version's epilogue; a score goes on only
    if it reaches the query's kth as it stood before the tile, then it is
    offered (in the kernel's column-pair order, not by id) under (score
    desc, id asc); the splits' lists are merged in split order."""
    n = xq.shape[0]
    acc = (qq.numpy().astype(np.int64) @ xq.numpy().astype(np.int64).T)
    f32 = np.float32
    cos = (acc.astype(f32) * qscale.numpy()[:, None]) * srow.numpy()[None, :]
    prox = f32(1.0) / (f32(1.0) + np.abs(lam.numpy()[None, :]
                                         - lamq.numpy()[:, None]))
    score = f32(TAU) * cos + (f32(1.0) - f32(TAU)) * prox
    n_tiles = -(-n // 128)
    per = -(-n_tiles // splits)
    # The kernel's order of a tile's 128 items for one row: column pairs
    # 8 j + 2 c + h, j = 0..15, the 4 lanes c, then h.
    order = np.array([8 * j + 2 * c + h for j in range(16) for c in range(4)
                      for h in range(2)])
    out_i, out_s = [], []
    for r in range(score.shape[0]):
        parts = []
        for sp in range(splits):
            vals = [(-3.0e38, -1)] * k
            for t in range(sp * per, min(n_tiles, (sp + 1) * per)):
                kth = vals[-1][0]
                for c in order + 128 * t:
                    if c >= n or not score[r, c] >= kth:
                        continue
                    cand = (float(score[r, c]), int(c))
                    if (cand[0] > vals[-1][0] or (cand[0] == vals[-1][0]
                                                  and cand[1] < vals[-1][1])):
                        vals = sorted(vals[:-1] + [cand],
                                      key=lambda e: (-e[0], e[1]))
            parts.append(vals)
        merged = sorted([e for p in parts for e in p if e[1] >= 0],
                        key=lambda e: (-e[0], e[1]))[:k]
        merged += [(-3.0e38, -1)] * (k - len(merged))
        out_i.append([e[1] for e in merged])
        out_s.append([e[0] for e in merged])
    return (np.array(out_i, dtype=np.int32), np.array(out_s, dtype=f32))


@pytest.mark.parametrize("n,k,splits", [(700, 15, 1), (700, 60, 3),
                                        (1000, 7, 8)])
def test_tensor_core_merge_model_equals_plain(n, k, splits):
    xq, srow, lam, qq, qscale, lamq = _case(n + k, n, 5, 48)
    i_m, s_m = _tc_model(xq, srow, lam, qq, qscale, lamq, k, splits)
    i_p, s_p = scan_int8.scan_int8_plain(xq, srow, lam, qq, qscale, lamq,
                                         TAU, k)
    np.testing.assert_array_equal(i_m, i_p.numpy())
    np.testing.assert_array_equal(s_m.view(np.int32),
                                  s_p.numpy().view(np.int32))


def test_tensor_core_merge_model_ties():
    """Duplicated rows tie exactly at the kth slot: the smallest ids win,
    whatever order the tile offers them in."""
    xq, srow, lam, qq, qscale, lamq = _case(3, 40, 4, 32)
    xq = xq.repeat(20, 1)
    srow, lam = srow.repeat(20), torch.full((800,), 0.25)
    lamq = torch.full((4,), 0.25)
    i_m, s_m = _tc_model(xq, srow, lam, qq, qscale, lamq, 30, 2)
    i_p, s_p = scan_int8.scan_int8_plain(xq, srow, lam, qq, qscale, lamq,
                                         TAU, 30)
    np.testing.assert_array_equal(i_m, i_p.numpy())
    np.testing.assert_array_equal(s_m, s_p.numpy())



# -- scores that enter no list -------------------------------------------------

def _nan_case(seed, n, q, f, nan_items):
    """Lambdas +inf on the items nan_items and on query 1: their scores for
    query 1 are NaN (inf - inf)."""
    xq, srow, lam, qq, qscale, lamq = _case(seed, n, q, f)
    lam[list(nan_items)] = float("inf")
    lamq[1] = float("inf")
    return xq, srow, lam, qq, qscale, lamq


@pytest.mark.parametrize("k", [10, 257, 261])
def test_nan_scores_enter_no_list(k):
    """A NaN score enters no list, as in both kernels (and the tensor-core
    model): query 1's list is the plain scan over the other items, then
    (-3e38, -1) where fewer than k are left."""
    n, nan_items = 261, [0, 5, 130, 260]
    xq, srow, lam, qq, qscale, lamq = _nan_case(9, n, 4, 48, nan_items)
    i_p, s_p = scan_int8.scan_int8_plain(xq, srow, lam, qq, qscale, lamq,
                                         TAU, k)
    assert not torch.isnan(s_p).any()
    i_m, s_m = _tc_model(xq, srow, lam, qq, qscale, lamq, k, 1)
    np.testing.assert_array_equal(i_m, i_p.numpy())
    np.testing.assert_array_equal(s_m.view(np.int32),
                                  s_p.numpy().view(np.int32))
    keep = torch.tensor([c for c in range(n) if c not in nan_items])
    kk = min(k, keep.numel())
    i_r, s_r = scan_int8.scan_int8_plain(xq[keep], srow[keep], lam[keep],
                                         qq[1:2], qscale[1:2], lamq[1:2],
                                         TAU, kk)
    assert torch.equal(i_p[1, :kk], keep[i_r[0].long()].to(torch.int32))
    assert torch.equal(s_p[1, :kk].view(torch.int32),
                       s_r[0].view(torch.int32))
    assert (i_p[1, kk:] == -1).all()
    assert (s_p[1, kk:] == scan_int8.NEG_SCORE).all()
    # The other queries meet no NaN: full lists of distinct items.
    for r in (0, 2, 3):
        assert (i_p[r] >= 0).all() and i_p[r].unique().numel() == k


def test_scores_at_the_floor_enter_no_list():
    """srow +inf on items 2 and 9: a positive product scores +inf and leads
    the list; a negative one scores -inf and, like any score at or below
    -3e38, never beats the unfilled slot (-3e38, -1)."""
    xq, srow, lam, qq, qscale, lamq = _case(4, 40, 3, 32)
    srow[[2, 9]] = float("inf")
    i_p, s_p = scan_int8.scan_int8_plain(xq, srow, lam, qq, qscale, lamq,
                                         TAU, 40)
    dots = qq.long() @ xq[[2, 9]].long().T
    assert (dots < 0).any() and (dots > 0).any() and (dots != 0).all()
    for r in range(3):
        top = [c for c, d in zip((2, 9), dots[r].tolist()) if d > 0]
        gone = 2 - len(top)
        assert i_p[r, :len(top)].tolist() == top
        assert (s_p[r, :len(top)] == float("inf")).all()
        assert (i_p[r, 40 - gone:] == -1).all()
        assert (s_p[r, 40 - gone:] == scan_int8.NEG_SCORE).all()
        assert sorted(i_p[r, :40 - gone].tolist()) == sorted(
            set(range(40)) - ({2, 9} - set(top)))
