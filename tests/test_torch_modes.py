"""The PyTorch port's remaining serving modes against the JAX package on the
same numpy inputs: gather IVF (ops/ivf.py, search_batch(mode="ivf")),
hybrid search (single and batched), the bfloat16 serving view
(as_serving: kernel K2's plain version over a bfloat16 corpus, and the
view's other modes), spectral_summary and the index's array properties;
and that a build without a card raises unless the CPU is asked for.

Tolerances: float64 paths to 1e-9 with ids exact; the bfloat16 view's
float32 scores to 1e-6 (products summed in other orders) with ids exact."""

import numpy as np
import pytest
import torch

import pyarrowspace_tpu as jx
import pyarrowspace_tpu_torch as pt
from pyarrowspace_tpu.ops import ivf as jivf
from pyarrowspace_tpu_torch.graph import build as tbuild
from pyarrowspace_tpu_torch.ops import ivf as tivf
from pyarrowspace_tpu_torch.ops.cuda import scan_topk

TAU = 0.62
GP = {"eps": 0.9, "k": 6, "topk": 8, "p": 2.0, "sigma": 0.4}


@pytest.fixture(scope="module")
def pair():
    """A 12-component mixture, 600 x 16, built by both packages in
    float64 and clustered by both for IVF (reseeding Lloyd + tighten)."""
    rng = np.random.default_rng(31)
    centers = rng.normal(size=(12, 16)) * 2.0
    items = centers[rng.integers(0, 12, 600)] + 0.5 * rng.normal(
        size=(600, 16))
    (ja, jg) = jx.ArrowSpaceBuilder.build(GP, items)
    (ta, tg) = pt.ArrowSpaceBuilder.build(GP, items, device="cpu")
    ja.enable_ivf(n_clusters=12)
    ta.enable_ivf(n_clusters=12)
    queries = np.concatenate([
        items[rng.choice(600, 14)] * 1.01,
        rng.normal(size=(4, 16)) * 2.0])
    return items, queries, ja, jg, ta, tg


def test_ivf_postings_match(pair):
    _, _, ja, _, ta, _ = pair
    for a, b in zip(ta._ivf, ja._ivf):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("n_probe,topk", [(1, 8), (3, 5), (12, 40)])
def test_search_batch_ivf_matches_reference(pair, n_probe, topk):
    _, queries, ja, jg, ta, tg = pair
    i, s = ta.search_batch(queries, tg, TAU, topk=topk, mode="ivf",
                           n_probe=n_probe)
    i_ref, s_ref = ja.search_batch(queries, jg, TAU, topk=topk, mode="ivf",
                                   n_probe=n_probe)
    assert i.dtype == np.int32 and s.dtype == np.float64
    np.testing.assert_array_equal(i, np.asarray(i_ref))
    np.testing.assert_allclose(s, np.asarray(s_ref), rtol=0, atol=1e-9)


def test_ivf_lambda_search_chunks_and_tail(pair, monkeypatch):
    """A spilling capacity (a tail of overflow items) and query chunks of
    one: the results do not depend on the chunking."""
    _, queries, ja, _, ta, _ = pair
    t_ivf = tivf.build_ivf(ta._centroids, ta._assignments, ta.nitems, 0.5)
    j_ivf = jivf.build_ivf(ja._centroids, ja._assignments, ja.nitems, 0.5)
    assert int((t_ivf.tail >= 0).sum()) > 0
    qn = torch.nn.functional.normalize(torch.from_numpy(queries), dim=1)
    lam_q = torch.from_numpy(np.linspace(0.1, 0.4, len(queries)))
    monkeypatch.setattr(tivf, "GATHER_BYTES", 1)
    i, s = tivf.ivf_lambda_search(ta._data_unit, ta._lambdas, t_ivf, qn,
                                  lam_q, torch.tensor(TAU, dtype=torch.float64),
                                  n_probe=2, topk=10)
    i_ref, s_ref = jivf.ivf_lambda_search(
        ja._data_unit, ja._lambdas, j_ivf, qn.numpy(), lam_q.numpy(),
        np.float64(TAU), n_probe=2, topk=10)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("tau", [1.0, 0.62, 0.2])
def test_search_hybrid_matches_reference(pair, tau):
    _, queries, ja, jg, ta, tg = pair
    for q in queries[[0, 5, 16]]:
        got, ref = ta.search_hybrid(q, tg, tau), ja.search_hybrid(q, jg, tau)
        assert [h[0] for h in got] == [h[0] for h in ref]
        np.testing.assert_allclose([h[1] for h in got], [h[1] for h in ref],
                                   rtol=0, atol=1e-9)
    i, s = ta.search_hybrid_batch(queries, tg, tau, topk=12)
    i_ref, s_ref = ja.search_hybrid_batch(queries, jg, tau, topk=12)
    np.testing.assert_array_equal(i, np.asarray(i_ref))
    np.testing.assert_allclose(s, np.asarray(s_ref), rtol=0, atol=1e-9)
    single = ta.search_hybrid(queries[5], tg, tau)
    assert [h[0] for h in single] == i[5, :len(single)].tolist()


def test_as_serving_bf16_matches_reference(pair):
    """The bfloat16 view: exact search through K2's plain version with the
    queries rounded to bfloat16 (float32 scores), and the view's int8 and
    ivf modes, against the JAX package's view."""
    _, queries, ja, jg, ta, tg = pair
    tv, jv = ta.as_serving(), ja.as_serving()
    assert tv._data_unit.dtype == torch.bfloat16
    assert tv._lambdas is ta._lambdas and tv.nitems == ta.nitems
    before = scan_topk.LAUNCHES
    for mode in ("exact", "int8", "ivf"):
        i, s = tv.search_batch(queries, tg, TAU, topk=10, mode=mode)
        i_ref, s_ref = jv.search_batch(queries, jg, TAU, topk=10, mode=mode)
        np.testing.assert_array_equal(i, np.asarray(i_ref), err_msg=mode)
        np.testing.assert_allclose(s, np.asarray(s_ref), rtol=0, atol=1e-6,
                                   err_msg=mode)
    assert scan_topk.LAUNCHES == before
    # The plain version scores bf16(q) . x in float32.
    xu = tv._data_unit
    qn = torch.nn.functional.normalize(torch.from_numpy(queries[:3]).float(),
                                       dim=1)
    lam = ta._lambdas.float()
    i, s = scan_topk.lambda_search(xu, lam, qn, lam[:3], TAU, 5)
    cos = qn.bfloat16().float() @ xu.float().T
    ref = TAU * cos + (1 - TAU) / (1 + (lam[None, :] - lam[:3, None]).abs())
    assert s.dtype == torch.float32
    np.testing.assert_allclose(s.numpy(), torch.sort(
        ref, dim=1, descending=True).values[:, :5].numpy(), atol=1e-6)


def test_spectral_summary_and_properties(pair):
    _, _, ja, _, ta, _ = pair
    got, ref = ta.spectral_summary(), ja.spectral_summary()
    assert got.keys() == ref.keys()
    np.testing.assert_allclose(got["eigenvalues"], ref["eigenvalues"],
                               rtol=0, atol=1e-9)
    for key in ("spectral_radius", "algebraic_connectivity", "spectral_gap"):
        assert got[key] == pytest.approx(ref[key], abs=1e-9)
    assert got["n_components"] == ref["n_components"]
    assert ta.spectral_summary() is got                 # cached
    np.testing.assert_array_equal(ta.data, np.asarray(ja.data))
    np.testing.assert_allclose(ta.feature_laplacian, ja.feature_laplacian,
                               rtol=0, atol=1e-12)


def test_build_without_a_card_raises(monkeypatch):
    """resolve_device never picks the CPU by itself: with no card and no
    device it raises; device="cpu" or a CPU tensor build on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    items = np.random.default_rng(1).normal(size=(30, 5)) + 0.2
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbuild.resolve_device(items)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.ArrowSpaceBuilder.build(GP, items)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.ArrowSpaceBuilder.build_energy(items, {"optical_tokens": 4}, GP)
    assert tbuild.resolve_device(items, "cpu").type == "cpu"
    assert tbuild.resolve_device(torch.from_numpy(items)).type == "cpu"
