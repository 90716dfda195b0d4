"""The int8 serving mode of the PyTorch port — ops/quantize.py, the plain
version of kernel K7 (ops/cuda/scan_int8.py), the float32 rescore and the
int8 serving step (ops/search.py), search_batch(mode="int8") — against the
JAX package on the same numpy inputs.  The JAX package's K7 runs its Pallas
kernel in interpret mode on the CPU by itself.

Tolerances: the int8 values and scales are equal bit for bit; K7's scores
within 1e-6 of the Pallas kernel's (XLA may contract the blend into fmas),
its ids identical outside exact ties on the kth boundary, where the Pallas
merge evicts the earlier tied entries first (ROADMAP.md section 3, the
"Pallas tie fault"); served ids are equal and served scores within 1e-6
(the rescore's products sum in other orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyarrowspace_tpu as jx
import pyarrowspace_tpu_torch as pt
from pyarrowspace_tpu.ops import search as jsearch
from pyarrowspace_tpu.ops.pallas.scan_topk import lambda_search_quantized
from pyarrowspace_tpu.ops.quantize import quantize_rows as jquantize
from pyarrowspace_tpu_torch.ops import search as tsearch
from pyarrowspace_tpu_torch.ops.cuda import scan_int8
from pyarrowspace_tpu_torch.ops.quantize import quantize_rows

TOL = 1e-6
TAU = 0.62


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _unit(rng, n, f):
    x = rng.normal(size=(n, f))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _case(seed, n, q, f):
    rng = np.random.default_rng(seed)
    xu = _unit(rng, n, f)
    qn = _unit(rng, q, f)
    lam = rng.uniform(0.0, 1.0, n).astype(np.float32)
    lam_q = rng.uniform(0.1, 0.3, q).astype(np.float32)
    return xu, qn, lam, lam_q


def test_quantize_rows_bitwise():
    """Random rows, a zero row, and rows whose scaled values fall on .5
    exactly (round half to even)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(50, 37)).astype(np.float32)
    x[3] = 0.0
    x[7] = np.arange(37, dtype=np.float32) - 18.5     # absmax 18.5
    x[8, :4] = [127.0, 0.5, 1.5, -2.5]
    x[8, 4:] = 0.0
    xq, s = quantize_rows(_t(x))
    jq, js = jquantize(jnp.asarray(x))
    assert xq.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert not xq[3].any()
    assert xq[7, [0, 1, 36]].tolist() == [-127, -120, 120]


@pytest.mark.parametrize("n,q,f,cand_k", [(300, 7, 24, 20), (1000, 33, 25, 60),
                                          (130, 5, 16, 500)])
def test_k7_plain_matches_pallas_interpret(n, q, f, cand_k):
    """N off the Pallas column tile, F not a multiple of 4, cand_k past N."""
    xu, qn, lam, lam_q = _case(n + f, n, q, f)
    xq, sc = quantize_rows(_t(xu))
    before = scan_int8.LAUNCHES
    i, s = scan_int8.lambda_search_quantized(xq, sc, _t(lam), _t(qn),
                                             _t(lam_q), TAU, cand_k)
    assert scan_int8.LAUNCHES == before          # CPU: the plain version
    i_ref, s_ref = lambda_search_quantized(
        jnp.asarray(xq.numpy()), jnp.asarray(sc.numpy()), jnp.asarray(lam),
        jnp.asarray(qn), jnp.asarray(lam_q), TAU, cand_k)
    k = min(cand_k, n)
    assert i.shape == (q, k) and i.dtype == torch.int32
    s_ref, i_ref = np.asarray(s_ref), np.asarray(i_ref)
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=0, atol=TOL)
    # Ids identical outside exact ties on the kth boundary (none here).
    for a, b, sa in zip(i.numpy(), i_ref, s.numpy()):
        inner = sa > sa[-1]
        np.testing.assert_array_equal(a[inner], b[inner])
        assert set(a.tolist()) == set(b.tolist())


def test_k7_tied_scores_and_the_pallas_tie_fault():
    """Duplicated int8 rows with equal lambdas and scales tie exactly.  The
    port keeps the smallest ids in (score desc, id asc) order; the Pallas
    merge agrees above the kth score and, inside the tie on the boundary,
    evicts the earlier-seen tied entries first (pos = #(rs > m))."""
    rng = np.random.default_rng(11)
    base = np.zeros((40, 16), np.float32)
    for r in range(40):
        base[r, rng.choice(16, 4, replace=False)] = rng.choice([-.5, .5], 4)
    xu = np.repeat(base, 25, axis=0)                    # 1000 rows
    lam = np.full(1000, 0.25, np.float32)
    qn, lam_q = base[:6], np.full(6, 0.25, np.float32)
    xq, sc = quantize_rows(_t(xu))
    i, s = scan_int8.lambda_search_quantized(xq, sc, _t(lam), _t(qn),
                                             _t(lam_q), 0.5, 30)
    tied = s.numpy()[:, 1:] == s.numpy()[:, :-1]
    assert tied.any() and np.all(np.diff(i.numpy(), axis=1)[tied] > 0)
    i_ref, s_ref = lambda_search_quantized(
        jnp.asarray(xq.numpy()), jnp.asarray(sc.numpy()), jnp.asarray(lam),
        jnp.asarray(qn), jnp.asarray(lam_q), 0.5, 30)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    for sa, ia, ib in zip(s.numpy(), i.numpy(), np.asarray(i_ref)):
        inner = sa > sa[-1]
        assert set(ia[inner].tolist()) == set(ib[inner].tolist())


def test_rescore_candidates_matches_reference():
    xu, qn, lam, lam_q = _case(5, 400, 9, 20)
    rng = np.random.default_rng(6)
    cand = np.stack([rng.permutation(400)[:40] for _ in range(9)]
                    ).astype(np.int32)
    cand[2, 5] = -1
    cand[4, :3] = -1
    i, s = tsearch.rescore_candidates(_t(xu), _t(lam), _t(qn), _t(lam_q),
                                      TAU, _t(cand), topk=12, q_chunk=4)
    i_ref, s_ref = jsearch.rescore_candidates(
        jnp.asarray(xu), jnp.asarray(lam), jnp.asarray(qn),
        jnp.asarray(lam_q), jnp.float32(TAU), jnp.asarray(cand), topk=12)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=0,
                               atol=TOL)


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(21)
    centers = rng.normal(size=(6, 16)) * 2.0
    items = centers[rng.integers(0, 6, 700)] + rng.normal(size=(700, 16))
    gp = {"eps": 0.9, "k": 6, "topk": 8, "p": 2.0, "sigma": 0.4}
    return (items, jx.ArrowSpaceBuilder.build(gp, items),
            pt.ArrowSpaceBuilder.build(gp, items, device="cpu"))


def test_fused_query_pipeline_quantized_matches_reference(built):
    items, (ja, _), (ta, _) = built
    f32 = np.float32
    xu = np.asarray(ja._data_unit, f32)
    lam, lap, w = (np.asarray(a, f32) for a in (ja._lambdas, ja._lap_f,
                                                 ja._w_f))
    ts = np.asarray(ja._tau_star, f32)
    q = (items[:20] * 1.02 + 0.01).astype(f32)
    jq, js = jquantize(jnp.asarray(xu))
    i_ref, s_ref = jsearch.fused_query_pipeline_quantized(
        jnp.asarray(xu), jq, js, jnp.asarray(lam), jnp.asarray(lap),
        jnp.asarray(w), jnp.asarray(ts), jnp.asarray(q), jnp.float32(TAU),
        topk=8, rescore_m=32, rayleigh_normalized=False,
        tau_mix=ta._tau_mix)
    xq, sc = quantize_rows(_t(xu))
    i, s = tsearch.fused_query_pipeline_quantized(
        _t(xu), xq, sc, _t(lam), _t(lap), _t(w), _t(ts), _t(q), TAU,
        topk=8, rescore_m=32, rayleigh_normalized=False,
        tau_mix=ta._tau_mix)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("tau,topk", [(0.62, None), (1.0, 5), (0.3, 40)])
def test_search_batch_int8_matches_reference(built, tau, topk):
    items, (ja, jg), (ta, tg) = built
    queries = items[np.random.default_rng(3).choice(700, 25)] * 1.01
    i, s = ta.search_batch(queries, tg, tau, topk=topk, mode="int8")
    i_ref, s_ref = ja.search_batch(queries, jg, tau, topk=topk, mode="int8")
    assert i.dtype == np.int32 and s.dtype == np.float32
    np.testing.assert_array_equal(i, np.asarray(i_ref))
    np.testing.assert_allclose(s, np.asarray(s_ref), rtol=0, atol=TOL)
    # The pool holds the exact top-k here: the int8 mode serves exact's.
    e_i, e_s = ta.search_batch(queries, tg, tau, topk=topk)
    np.testing.assert_array_equal(i, e_i)
    np.testing.assert_allclose(s, e_s, rtol=0, atol=TOL)
    assert ta._quantized is not None


def test_k7_nan_scores_against_the_pallas_kernel():
    """Lambdas +inf on items 5 and 200 and on query 1 give query 1 two NaN
    scores.  The port drops those two entries (as its kernels do); the
    Pallas merge's tile maximum is NaN there, so query 1 takes nothing of
    the two 128-item tiles that hold them.  Held: the other queries' lists
    equal the Pallas kernel's; query 1's Pallas list is the port's over
    the NaN-free tile (items 256-299), and the port's is its own over
    every item but 5 and 200."""
    xu, qn, lam, lam_q = _case(0, 300, 4, 32)
    lam[[5, 200]] = np.inf
    lam_q[1] = np.inf
    xq, sc = quantize_rows(_t(xu))
    args = (xq, sc, _t(lam), _t(qn), _t(lam_q), TAU, 10)
    i, s = scan_int8.lambda_search_quantized(*args)
    i_ref, s_ref = lambda_search_quantized(
        jnp.asarray(xq.numpy()), jnp.asarray(sc.numpy()), jnp.asarray(lam),
        jnp.asarray(qn), jnp.asarray(lam_q), TAU, 10, col_tile=128)
    i_ref, s_ref = np.asarray(i_ref), np.asarray(s_ref)
    assert not np.isnan(s.numpy()).any()
    for r in (0, 2, 3):
        np.testing.assert_array_equal(i[r].numpy(), i_ref[r])
        np.testing.assert_allclose(s[r].numpy(), s_ref[r], rtol=0, atol=TOL)

    def sub(rows):
        rows = torch.as_tensor(rows)
        si, ss = scan_int8.lambda_search_quantized(
            xq[rows], sc[rows], _t(lam)[rows], _t(qn[1:2]), _t(lam_q[1:2]),
            TAU, 10)
        return rows[si[0].long()].numpy(), ss[0].numpy()

    tile_i, tile_s = sub(np.arange(256, 300))
    np.testing.assert_array_equal(i_ref[1], tile_i)
    np.testing.assert_allclose(s_ref[1], tile_s, rtol=0, atol=TOL)
    rest_i, rest_s = sub(np.setdiff1d(np.arange(300), [5, 200]))
    np.testing.assert_array_equal(i[1].numpy(), rest_i)
    np.testing.assert_array_equal(s[1].numpy(), rest_s)
