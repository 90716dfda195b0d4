"""K2, the blended cosine + lambda-proximity top-k scan: the PyTorch port's
plain version (what CPU tensors run) against the JAX package's Pallas
kernel in interpret mode (float32) and its XLA path (float64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyarrowspace_tpu.ops.pallas.scan_topk import lambda_search_pallas
from pyarrowspace_tpu.ops.search import lambda_aware_topk as jax_topk
from pyarrowspace_tpu.ops.search import lambda_aware_topk_batch as jax_batch
from pyarrowspace_tpu_torch.ops.cuda import scan_int8, scan_topk
from pyarrowspace_tpu_torch.ops.distance import unit_normalize
from pyarrowspace_tpu_torch.ops.search import (lambda_aware_topk,
                                               lambda_aware_topk_batch)


def _case(seed, n, q, f, dtype):
    rng = np.random.default_rng(seed)
    xu = rng.normal(size=(n, f))
    xu /= np.linalg.norm(xu, axis=1, keepdims=True)
    qs = rng.normal(size=(q, f)) + 0.4
    lam = rng.uniform(0.0, 1.0, n)
    lam_q = rng.uniform(0.1, 0.3, q)
    return tuple(a.astype(dtype) for a in (xu, qs, lam, lam_q))


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("n,q,topk", [(300, 7, 10), (1000, 33, 15),
                                      (130, 5, 64)])
def test_plain_matches_pallas_interpret_f32(n, q, topk):
    """N is not a multiple of the Pallas column tile: the padded tail must
    never be selected.  Equal id sets, scores within 1e-6."""
    xu, qs, lam, lam_q = _case(n, n, q, 24, np.float32)
    qn = qs / np.linalg.norm(qs, axis=1, keepdims=True)
    i_ref, s_ref = lambda_search_pallas(
        jnp.asarray(xu), jnp.asarray(lam), jnp.asarray(qn),
        jnp.asarray(lam_q), 0.62, topk, col_tile=128, interpret=True)
    i, s = scan_topk.lambda_search(*_t(xu, lam, qn, lam_q), 0.62, topk)
    assert i.dtype == torch.int32 and i.shape == (q, min(topk, n))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=1e-6)
    for a, b in zip(i.numpy(), np.asarray(i_ref)):
        assert set(a.tolist()) == set(b.tolist())


@pytest.mark.parametrize("tau", [1.0, 0.62, 0.2])
def test_plain_matches_xla_f64_exact(tau):
    xu, qs, lam, lam_q = _case(7, 777, 9, 32, np.float64)
    i_ref, s_ref = jax_batch(jnp.asarray(xu), jnp.asarray(lam),
                             jnp.asarray(qs), jnp.asarray(lam_q),
                             jnp.asarray(tau), 12)
    i, s = lambda_aware_topk_batch(*_t(xu, lam, qs, lam_q),
                                   torch.tensor(tau, dtype=torch.float64), 12)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=0,
                               atol=1e-12)


def test_tied_scores_go_to_the_smallest_id():
    """Duplicated corpus rows with equal lambdas tie exactly: ids in
    ascending order within each tie, as lax.top_k returns them.  Against
    the Pallas kernel the scores are equal and the sets agree except inside
    the tie on the kth boundary, where its merge evicts the earlier-seen
    tied entries first (scan_topk.py:_lazy_merge, pos = #(rs > m))."""
    rng = np.random.default_rng(11)
    base = np.zeros((40, 16))
    for r in range(40):
        base[r, rng.choice(16, 4, replace=False)] = rng.choice([-.5, .5], 4)
    xu = np.repeat(base, 25, axis=0)                     # 1000 rows
    lam = np.full(1000, 0.25)
    qn = base[:6]
    lam_q = np.full(6, 0.25)
    i_ref, s_ref = jax_batch(jnp.asarray(xu), jnp.asarray(lam),
                             jnp.asarray(qn), jnp.asarray(lam_q),
                             jnp.asarray(0.5), 30)
    i, s = lambda_aware_topk_batch(*_t(xu, lam, qn, lam_q),
                                   torch.tensor(0.5, dtype=torch.float64), 30)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    f32 = [a.astype(np.float32) for a in (xu, lam, qn, lam_q)]
    i_p, s_p = lambda_search_pallas(*map(jnp.asarray, f32), 0.5, 30,
                                    col_tile=128, interpret=True)
    i32, s32 = scan_topk.lambda_search(*_t(*f32), 0.5, 30)
    np.testing.assert_array_equal(s32.numpy(), np.asarray(s_p))
    for sa, ia, ib in zip(s32.numpy(), i32.numpy(), np.asarray(i_p)):
        inner = sa > sa[-1]
        assert set(ia[inner].tolist()) == set(ib[inner].tolist())


def test_single_query_matches_reference_f64():
    xu, qs, lam, lam_q = _case(3, 200, 1, 16, np.float64)
    i_ref, s_ref = jax_topk(jnp.asarray(xu), jnp.asarray(lam),
                            jnp.asarray(qs[0]), jnp.asarray(lam_q[0]),
                            jnp.asarray(0.7), 8)
    i, s = lambda_aware_topk(*_t(xu, lam, qs[0]),
                             torch.tensor(lam_q[0]), torch.tensor(0.7), 8)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=1e-12)


def test_cpu_wrapper_runs_plain_version_without_launching():
    xu, qs, lam, lam_q = _case(5, 90, 4, 8, np.float32)
    qn = unit_normalize(torch.from_numpy(qs))
    before = scan_topk.LAUNCHES
    i, s = scan_topk.lambda_search(*_t(xu, lam), qn,
                                   torch.from_numpy(lam_q), 0.4, 500)
    assert scan_topk.LAUNCHES == before
    assert i.shape == (4, 90)                    # k = min(topk, N)
    ip, sp = scan_topk.scan_plain(*_t(xu, lam), qn, torch.from_numpy(lam_q),
                                  0.4, 90, queries=slice(1, 3))
    assert torch.equal(i[1:3], ip) and torch.equal(s[1:3], sp)
    with pytest.raises(ValueError):
        scan_topk.lambda_search(*_t(xu, lam), qn[:, :5],
                                torch.from_numpy(lam_q), 0.4, 3)


def _k7_plan_before(n, q, k):
    """K7's split plan as it was before K2's tiles widened to 128: 64-query
    blocks over 64-item tiles, at least about two blocks per SM."""
    n_tiles, n_qblocks = -(-n // 64), -(-q // 64)
    want = min(n_tiles, max(1, -(-2 * 132 // n_qblocks)))
    splits = -(-n_tiles // -(-n_tiles // want))
    per_query = 8 * k
    if splits * q * per_query > scan_topk.SCRATCH_BYTES:
        per_split = -(-n_tiles // max(
            1, scan_topk.SCRATCH_BYTES // (q * per_query)))
        splits = -(-n_tiles // per_split)
    q_chunk = q if splits * q * per_query <= scan_topk.SCRATCH_BYTES else max(
        1, scan_topk.SCRATCH_BYTES // (splits * per_query))
    return splits, q_chunk


@pytest.mark.parametrize("n,q,k", [
    (3, 1, 3), (127, 1, 64), (129, 129, 128), (5000, 130, 64),
    (313_841, 1, 15), (313_841, 4096, 15), (313_841, 4096, 5000),
    (1_000_000, 16_384, 15), (1_000_000, 16_384, 5000), (1 << 20, 1, 1)])
def test_split_plans_keep_every_split_nonempty(monkeypatch, n, q, k):
    """The split plans of K2 (128-wide tiles, whole waves) and K7 (64-wide
    tiles) on a 132-SM card: every split holds a tile, as the C launchers
    check, the partial lists fit the scratch, and K7's plan is the one it
    had with 64-wide K2 tiles."""
    for mod in (scan_topk, scan_int8):
        monkeypatch.setattr(mod, "sm_count", lambda index: 132)
    device = torch.device("cuda", 0)
    for plan, tile in ((scan_topk.plan_splits, 128),
                       (scan_int8.plan_splits, 64)):
        splits, q_chunk = plan(n, q, k, device)
        n_tiles = -(-n // tile)
        per_split = -(-n_tiles // splits)
        assert 1 <= splits <= n_tiles
        assert (splits - 1) * per_split < n_tiles
        assert 1 <= q_chunk <= q
        assert splits * min(q, q_chunk) * 8 * k <= scan_topk.SCRATCH_BYTES
    assert scan_int8.plan_splits(n, q, k, device) == _k7_plan_before(n, q, k)
    if (n, q, k) == (313_841, 4096, 15):
        assert scan_topk.plan_splits(n, q, k, device) == (4, 4096)
