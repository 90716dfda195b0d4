"""The selects' order on the CPU: the plain versions of K4b and K4a
(ops/cuda/extract.py) against the JAX package's Pallas kernels
(ops/pallas/subtile_scan.py, interpret mode) on rows inside those kernels'
contract, the plain versions' rule for NaN, +-0.0 and +-inf on its own
terms, the Pallas kernels' output on a NaN row pinned as a divergence, and
the same NaN rule in K2's and K6's plain versions.

The rule: a row's entries ordered by (value desc, id asc), ids compared as
signed int32, -0.0 equal to +0.0, -inf and +inf ordinary values, NaN below
every number (NaNs tie, by id).  Ids are compared exactly: the selects do
no arithmetic."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyarrowspace_tpu.ops.pallas import subtile_scan as jss
from pyarrowspace_tpu_torch.ops.cuda import extract, ivf_scan, scan_topk

INT_MAX = np.iinfo(np.int32).max


def _rule_key(value: float, ident: int):
    """The sort key of the rule, for sorted() ascending."""
    if math.isnan(value):
        return (1, 0.0, ident)
    return (0, -(value + 0.0), ident)      # + 0.0 folds -0.0 into +0.0


def _by_rule(row, ids, m):
    order = sorted(range(len(row)), key=lambda j: _rule_key(float(row[j]),
                                                            int(ids[j])))
    return [int(ids[j]) for j in order[:m]]


def _zero_ties(rng, rows, cols):
    """In-contract rows with many ties between -0.0 and +0.0 (and +-0.5)."""
    return rng.choice(np.array([-0.0, 0.0, 0.5, -0.5, 0.25], np.float32),
                      (rows, cols))


def _special(rng, rows, cols):
    """Rows of a grid of eighths with -0.0, +-inf and NaN entries, and a
    row of NaN only."""
    s = (rng.integers(-8, 8, (rows, cols)) / 8.0).astype(np.float32)
    for v in (-0.0, np.inf, -np.inf, np.nan):
        s[rng.random((rows, cols)) < 0.08] = v
    s[-1] = np.nan
    return s


# -- the plain versions against the Pallas kernels (their contract) -------------

@pytest.mark.parametrize("cols,m", [(64, 64), (300, 256), (500, 17)])
def test_extract_ids_plain_matches_pallas_on_zero_ties(cols, m):
    rng = np.random.default_rng(cols + m)
    score = _zero_ties(rng, 8, cols)
    ref = jss._extract_ids_pallas_t(jnp.asarray(score.T), m_pool=m,
                                    interpret=True)
    got = extract.extract_ids(torch.from_numpy(score), m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("cols,m", [(48, 48), (300, 256), (500, 30)])
def test_extract_pool_plain_matches_pallas_on_zero_ties(cols, m):
    """Ids distinct within a row, in no order, negative ones among them."""
    rng = np.random.default_rng(7 * cols + m)
    score = _zero_ties(rng, 8, cols)
    cand = np.stack([rng.permutation(4 * cols)[:cols] - 2 * cols
                     for _ in range(8)]).astype(np.int32)
    ref = jss._extract_pool_pallas(jnp.asarray(score), jnp.asarray(cand),
                                   m_pool=m, interpret=True)
    got = extract.extract_pool(torch.from_numpy(score),
                               torch.from_numpy(cand), m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# -- the rule on its own terms ---------------------------------------------------

@pytest.mark.parametrize("cols,m", [(1, 1), (40, 40), (333, 100), (64, 7)])
def test_extract_plain_rule_for_nan_zeros_and_infinities(cols, m):
    rng = np.random.default_rng(cols * 3 + m)
    score = _special(rng, 6, cols)
    cand = np.stack([rng.permutation(3 * cols)[:cols] - cols
                     for _ in range(6)]).astype(np.int32)
    ids = extract.extract_ids(torch.from_numpy(score), m).numpy()
    pool = extract.extract_pool(torch.from_numpy(score),
                                torch.from_numpy(cand), m).numpy()
    for r in range(6):
        assert ids[r].tolist() == _by_rule(score[r], np.arange(cols), m)
        assert pool[r].tolist() == _by_rule(score[r], cand[r], m)


def test_order_keys_order_the_specials():
    """-inf < -1 < -0.0 == +0.0 < 1 < +inf, and NaN (any sign) below all."""
    v = torch.tensor([float("nan"), -float("inf"), -1.0, -0.0, 0.0, 1.0,
                      float("inf"), -float("nan")])
    k = extract.order_keys(v).tolist()
    assert k[0] == k[7] < k[1] < k[2] < k[3] == k[4] < k[5] < k[6]
    k64 = extract.order_keys(v.double()).tolist()
    assert k64[0] == k64[7] < k64[1] < k64[2] < k64[3] == k64[4] < k64[5]


# -- the Pallas kernels on a NaN: a divergence the port does not copy ------------

def test_extract_nan_row_against_the_pallas_kernels():
    """The Pallas extraction takes the row's max, which is NaN for a row
    holding a NaN; no entry equals it, so every extraction returns INT_MAX.
    The port ranks the NaN last and returns the row's real ids."""
    score = np.array([[0.5, np.nan, 0.25, 1.0, -0.5, 0.0]], np.float32)
    cand = np.array([[9, -4, 7, 2, 30, -1]], np.int32)
    pallas_ids = np.asarray(jss._extract_ids_pallas_t(
        jnp.asarray(np.repeat(score, 8, axis=0).T), m_pool=4,
        interpret=True))[0]
    pallas_pool = np.asarray(jss._extract_pool_pallas(
        jnp.asarray(score), jnp.asarray(cand), m_pool=4, interpret=True))[0]
    assert pallas_ids.tolist() == [INT_MAX] * 4
    assert pallas_pool.tolist() == [INT_MAX] * 4
    assert extract.extract_ids(torch.from_numpy(score), 6)[0].tolist() == \
        [3, 0, 2, 5, 4, 1]
    assert extract.extract_pool(torch.from_numpy(score),
                                torch.from_numpy(cand), 6)[0].tolist() == \
        [2, 9, 7, -1, 30, -4]


# -- K2's and K6's plain versions drop a NaN score, as their kernels do ----------

def test_scan_plain_drops_nan_scores():
    """Lambdas +inf on an item and a query: its scores against that item
    are NaN (inf - inf) and enter no list; a list short of k ends in
    (-3e38, -1)."""
    rng = np.random.default_rng(5)
    xu = rng.standard_normal((40, 8)).astype(np.float32)
    xu /= np.linalg.norm(xu, axis=1, keepdims=True)
    lam = rng.uniform(0, 1, 40).astype(np.float32)
    lam[[3, 17]] = np.inf
    lamq = np.array([np.inf, 0.5], np.float32)
    idx, vals = scan_topk.scan_plain(torch.from_numpy(xu),
                                     torch.from_numpy(lam),
                                     torch.from_numpy(xu[:2]),
                                     torch.from_numpy(lamq), 0.62, 40)
    assert not torch.isnan(vals).any()
    assert 3 not in idx[0].tolist() and 17 not in idx[0].tolist()
    assert idx[0, -2:].tolist() == [-1, -1]
    assert vals[0, -2:].tolist() == [np.float32(-3.0e38)] * 2
    assert sorted(idx[1].tolist()) == list(range(40))


def test_ivf_scan_plain_drops_nan_scores():
    rng = np.random.default_rng(6)
    cap, f, qb = 64, 8, 4
    slabs = rng.standard_normal((2 * cap, f)).astype(np.float32)
    slabs /= np.linalg.norm(slabs, axis=1, keepdims=True)
    ids = np.arange(2 * cap, dtype=np.int32)
    ids[cap - 5:cap] = -1                      # padding
    lam = rng.uniform(0, 1, 2 * cap).astype(np.float32)
    lam[[2, 70]] = np.inf
    qn = slabs[:qb].copy()
    lamq = np.array([np.inf, 0.3, 0.3, 0.3], np.float32)
    probe = np.array([[0, 1]], np.int32)
    vals, idx = ivf_scan.ivf_scan_plain(
        torch.from_numpy(slabs), torch.from_numpy(lam),
        torch.from_numpy(ids), torch.from_numpy(qn), torch.from_numpy(lamq),
        torch.from_numpy(probe), 0.62, k=2 * cap, q_block=qb, cap=cap)
    assert not torch.isnan(vals).any()
    real = 2 * cap - 5
    assert sorted(idx[0, :real - 2].tolist()) == sorted(
        set(range(2 * cap)) - set(range(cap - 5, cap)) - {2, 70})
    assert idx[0, real - 2:].tolist() == [-1] * 7
    assert sorted(idx[1, :real].tolist()) == sorted(
        set(range(2 * cap)) - set(range(cap - 5, cap)))
