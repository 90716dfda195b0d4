"""Save / load of the PyTorch port (io/persist.py) on the CPU: the cases of
tests/test_persist.py, an index saved by either package loaded into the
other, the parameter suggestions and their suggested_eps.md artifact,
GraphLaplacian.matvec, and the fixed-order segment sums of the Lloyd
steps.  Inputs are made with numpy from a seed and handed to both
packages."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyarrowspace_tpu as jx
import pyarrowspace_tpu_torch as pt
from pyarrowspace_tpu.graph.suggest import \
    suggest_graph_params as jax_suggest
from pyarrowspace_tpu.io import load_index as jax_load
from pyarrowspace_tpu.io import save_index as jax_save
from pyarrowspace_tpu_torch.graph.suggest import (emit_build_suggestions,
                                                  suggest_graph_params)
from pyarrowspace_tpu_torch.io import load_index, save_index
from pyarrowspace_tpu_torch.utils.stats import segment_sum

GP = {"eps": 0.9, "k": 6, "topk": 5, "p": 2.0, "sigma": 0.3}


def _items(n=60, f=12, seed=17):
    return np.random.default_rng(seed).normal(size=(n, f)) + 0.3


def test_roundtrip(tmp_path):
    items = _items()
    aspace, gl = pt.ArrowSpaceBuilder.build(GP, items, device="cpu")
    path = str(tmp_path / "index.npz")
    save_index(path, aspace, gl)
    a2, gl2 = load_index(path, device="cpu")
    assert a2.nitems == aspace.nitems and a2.nfeatures == aspace.nfeatures
    assert a2._data.dtype == torch.float64
    np.testing.assert_array_equal(a2.lambdas(), aspace.lambdas())
    np.testing.assert_array_equal(gl2.to_dense(), gl.to_dense())
    assert gl2.graph_params == gl.graph_params
    q = items[3] * 1.07
    assert a2.search(q, gl2, 0.62) == aspace.search(q, gl, 0.62)
    assert a2.search_hybrid(q, gl2, 0.8) == aspace.search_hybrid(q, gl, 0.8)
    assert a2.search_energy(q, gl2, 5) == aspace.search_energy(q, gl, 5)


def test_load_needs_a_device_or_the_cpu(tmp_path, monkeypatch):
    path = str(tmp_path / "index.npz")
    save_index(path, *pt.ArrowSpaceBuilder.build(GP, _items(20, 8, 18),
                                                 device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_index(path)


def test_version_check(tmp_path):
    aspace, gl = pt.ArrowSpaceBuilder.build(GP, _items(20, 8, 18),
                                            device="cpu")
    path = str(tmp_path / "index.npz")
    save_index(path, aspace, gl)
    z = dict(np.load(path))
    m = json.loads(bytes(z["manifest"]).decode())
    m["format_version"] = 999
    z["manifest"] = np.frombuffer(json.dumps(m).encode(), dtype=np.uint8)
    with open(path, "wb") as fh:
        np.savez(fh, **z)
    with pytest.raises(ValueError, match="unsupported index format"):
        load_index(path, device="cpu")


def _energy_items():
    rng = np.random.default_rng(23)
    base = rng.normal(size=(20, 24))
    return (np.repeat(base, 30, axis=0)
            + 0.2 * rng.normal(size=(600, 24))) * 12


def test_energy_space_roundtrip(tmp_path):
    """An energy-built space keeps its EnergyMaps routing table."""
    items = _energy_items()
    aspace, gle = pt.ArrowSpaceBuilder.build_energy(
        items, {"optical_tokens": 20}, GP, device="cpu")
    path = str(tmp_path / "energy.npz")
    save_index(path, aspace, gle)
    a2, gle2 = load_index(path, device="cpu")
    assert a2._energy_maps is not None
    assert a2._energy_maps.candidate_m == aspace._energy_maps.candidate_m
    q = items[123] * 1.01
    assert a2.search_energy(q, gle2, 12) == aspace.search_energy(q, gle, 12)


def test_loaded_index_serves_certified(tmp_path):
    """save -> load -> mode="certified" serves the exact results (the
    blocked-IVF state rebuilt from the persisted clustering; K6's plain
    version on the CPU)."""
    rng = np.random.default_rng(23)
    base = rng.normal(size=(30, 24))
    items = np.repeat(base, 40, axis=0) + 0.1 * rng.normal(size=(1200, 24))
    gp = {"eps": 0.9, "k": 5, "topk": 10, "p": 2.0, "sigma": 0.3}
    aspace, gl = pt.ArrowSpaceBuilder.build(gp, items, device="cpu")
    aspace.enable_ivf(n_clusters=30)
    p = str(tmp_path / "idx.npz")
    save_index(p, aspace, gl)
    loaded, gl2 = load_index(p, device="cpu")
    assert loaded._ivf_cap_plan == aspace._ivf_cap_plan
    queries = items[rng.choice(1200, 6, replace=False)] * 1.02
    ci, _ = loaded.search_batch(queries, gl2, 0.62, mode="certified",
                                n_probe=6)
    ei, _ = loaded.search_batch(queries, gl2, 0.62, mode="exact")
    for r in range(6):
        assert set(ci[r].tolist()) == set(ei[r].tolist()), r


def _same_search(port, jax_pair, items):
    ta, tg = port
    ja, jg = jax_pair
    q = items[:9] * 1.03
    ti, ts = ta.search_batch(q, tg, 0.62)
    ji, js = ja.search_batch(q, jg, 0.62)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=1e-12)
    hits_t, hits_j = ta.search(q[2], tg, 0.8), ja.search(q[2], jg, 0.8)
    assert [h[0] for h in hits_t] == [h[0] for h in hits_j]
    np.testing.assert_allclose([h[1] for h in hits_t],
                               [h[1] for h in hits_j], rtol=0, atol=1e-12)


def test_jax_saved_index_loads_into_the_port(tmp_path):
    items = _items(90, 16, 31)
    jax_pair = jx.ArrowSpaceBuilder.build(GP, items)
    path = str(tmp_path / "jax.npz")
    jax_save(path, *jax_pair)
    ta, tg = load_index(path, device="cpu")
    assert ta._data.dtype == torch.float64
    np.testing.assert_array_equal(ta._knn_idx.numpy(),
                                  np.asarray(jax_pair[0]._knn_idx))
    assert tg.n_dropped_edges == jax_pair[1].n_dropped_edges
    _same_search((ta, tg), jax_pair, items)


def test_port_saved_index_loads_into_jax(tmp_path):
    items = _items(90, 16, 33)
    port = pt.ArrowSpaceBuilder.build(GP, items, device="cpu")
    path = str(tmp_path / "port.npz")
    save_index(path, *port)
    ja, jg = jax_load(path)
    np.testing.assert_array_equal(np.asarray(ja._lambdas),
                                  port[0]._lambdas.numpy())
    np.testing.assert_array_equal(np.asarray(jg.neighbor_indices),
                                  port[1].neighbor_indices.numpy())
    _same_search(port, (ja, jg), items)


def test_suggest_graph_params_matches_jax():
    """The data of tests/test_graph.py::test_suggest_graph_params."""
    rng = np.random.default_rng(6)
    latent = rng.normal(size=(2000, 3))
    proj = rng.normal(size=(3, 64))
    items = latent @ proj + 0.01 * rng.normal(size=(2000, 64))
    rec = suggest_graph_params(items, sample=1024, device="cpu")
    assert rec == jax_suggest(items, sample=1024)
    assert 2 <= rec["intrinsic_dim"] <= 5
    assert suggest_graph_params(torch.from_numpy(items), sample=1024) == rec


def test_suggestions_without_a_card_raise(monkeypatch, tmp_path):
    """An array with no device asks for the card, as a build does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    items = np.random.default_rng(2).normal(size=(50, 6))
    gp = pt.GraphParams(eps=0.5, k=4, topk=3, p=2.0, sigma=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        suggest_graph_params(items)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        emit_build_suggestions(items, gp, str(tmp_path))
    path = emit_build_suggestions(items, gp, str(tmp_path), device="cpu")
    assert open(path).read().startswith("# what is the suggested eps")


def test_suggested_eps_artifact_matches_jax(tmp_path, monkeypatch):
    """The build of tests/test_graph.py::test_suggested_eps_artifact under
    ARROWSPACE_SUGGEST_DIR: the port writes the JAX package's text."""
    rng = np.random.default_rng(6)
    latent = rng.normal(size=(1500, 3))
    items = latent @ rng.normal(size=(3, 64))
    gp = {"eps": 0.2, "k": 6, "topk": 4, "p": 2.0, "sigma": None}
    docs = []
    for name, build in (("jax", lambda: jx.ArrowSpaceBuilder.build(gp,
                                                                  items)),
                        ("port", lambda: pt.ArrowSpaceBuilder.build(
                            gp, items, device="cpu"))):
        monkeypatch.setenv("ARROWSPACE_SUGGEST_DIR", str(tmp_path / name))
        build()
        docs.append((tmp_path / name / "suggested_eps.md").read_text())
    assert docs[1] == docs[0]
    assert docs[1].startswith("# what is the suggested eps and sigma")
    assert "Build configuration: eps=0.2" in docs[1]


def test_matvec_matches_jax():
    items = _items(80, 10, 41)
    ta, tg = pt.ArrowSpaceBuilder.build(GP, items, device="cpu")
    ja, jg = jx.ArrowSpaceBuilder.build(GP, items)
    v = np.random.default_rng(5).normal(size=80)
    got = tg.matvec(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, np.asarray(jg.matvec(jnp.asarray(v))),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, tg.to_dense() @ v, rtol=0, atol=1e-12)


@pytest.mark.parametrize("shape", [(5000, 7), (3000,)])
def test_segment_sum_matches_index_add(shape):
    """The atomics-free segment sum on the CPU gives index_add_'s bits."""
    rng = np.random.default_rng(len(shape))
    x = torch.from_numpy(rng.normal(size=shape))
    seg = torch.from_numpy(rng.integers(0, 41, size=shape[0]))
    seg[seg == 3] = 4                           # an empty segment
    ref = torch.zeros((41, *shape[1:]), dtype=x.dtype).index_add_(0, seg, x)
    got = segment_sum(x, seg, 41)
    assert torch.equal(got, ref)
    assert float(got[3].abs().max()) == 0.0
