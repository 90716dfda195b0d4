"""The build and serving switches the port reads where the JAX package
reads them, each held against the JAX package under the same variable:
ARROWSPACE_K_SEARCH=0 (the closed-form K), ARROWSPACE_IVF_SLABS (the
blocked slabs' dtype, resolved at search time) and ARROWSPACE_PROFILE (a
trace of the build)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyarrowspace_tpu as jx
import pyarrowspace_tpu_torch as pt
from pyarrowspace_tpu.graph.build import BuildConfig as JaxBuildConfig
from pyarrowspace_tpu_torch.reduction.pipeline import (k_search_range,
                                                       select_k_searched)

K_GP = {"eps": 1.31, "k": 10, "topk": 8, "p": 2.0, "sigma": 0.45}
IVF_GP = {"eps": 0.9, "k": 4, "topk": 5, "p": 2.0, "sigma": 0.3}


@pytest.fixture(scope="module")
def k_corpus():
    """tests/test_k_search.py's corpus: 25 centres x 200 rows + 0.1 N(0, 1)."""
    rng = np.random.default_rng(11)
    base = rng.normal(size=(25, 32))
    return np.repeat(base, 200, axis=0) + 0.1 * rng.normal(size=(5000, 32))


def _jax_build(gp, items):
    """The JAX package's build with a narrower k-NN column tile (the same
    exact neighbours, a faster CPU scan)."""
    return (jx.ArrowSpaceBuilder.new()
            .with_lambda_graph(gp["eps"], gp["k"], gp["topk"], gp["p"],
                               gp["sigma"])
            .with_dims_reduction(True, gp["eps"]).with_seed(42)
            .with_build_config(JaxBuildConfig(col_tile=256))
            .build_rows(items))


def test_k_search_off_takes_the_closed_form_k(monkeypatch, k_corpus):
    """Under ARROWSPACE_K_SEARCH=0 both packages take the range's low end:
    the same K, centroids, assignments and lambdas."""
    xs = torch.from_numpy(k_corpus)
    lo, _ = k_search_range(5000, 3, 1.31)
    monkeypatch.setenv("ARROWSPACE_K_SEARCH", "0")
    assert select_k_searched(xs, 5000, 3, 1.31, seed=42) == lo
    ta, tg = pt.ArrowSpaceBuilder.build(K_GP, k_corpus, device="cpu")
    ja, jg = _jax_build(K_GP, k_corpus)
    assert ta._centroids.shape[0] == np.asarray(ja._centroids).shape[0]
    np.testing.assert_array_equal(ta._assignments.numpy(),
                                  np.asarray(ja._assignments))
    np.testing.assert_allclose(ta._centroids.numpy(),
                               np.asarray(ja._centroids), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(ta.lambdas(), ja.lambdas(), rtol=1e-9)


@pytest.fixture(scope="module")
def ivf_pair():
    """An index of each package on the same 400 x 16 rows."""
    items = np.random.default_rng(22).normal(size=(400, 16))
    return (items, pt.ArrowSpaceBuilder.build(IVF_GP, items, device="cpu"),
            jx.ArrowSpaceBuilder.build(IVF_GP, items))


def test_env_slab_dtype(monkeypatch, ivf_pair):
    """bf16 slabs from the variable, the JAX package's slabs bit for bit;
    every certified query's ids equal exact search's."""
    items, (ta, tg), (ja, jg) = ivf_pair
    monkeypatch.setenv("ARROWSPACE_IVF_SLABS", "bf16")
    for a in (ta, ja):
        a.enable_ivf(n_clusters=8)
    idx, _, cert = ta.search_batch(items[:4], tg, 0.62, mode="ivf_block",
                                   n_probe=8, certify=True)
    assert ta._ivf_blocked.slabs.dtype == torch.bfloat16
    jslabs = ja._ensure_ivf_blocked().slabs
    assert jslabs.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        ta._ivf_blocked.slabs.view(torch.int16).numpy(),
        np.asarray(jslabs).view(np.int16))
    ei, _ = ta.search_batch(items[:4], tg, 0.62)
    for r in np.flatnonzero(cert):
        assert set(idx[r].tolist()) == set(ei[r].tolist())


def test_env_slab_dtype_unknown_raises(monkeypatch, ivf_pair):
    """An unknown value raises at search time, with the reference's
    message, in both packages."""
    items, (ta, tg), (ja, jg) = ivf_pair
    for a in (ta, ja):
        a.enable_ivf(n_clusters=8)
    monkeypatch.setenv("ARROWSPACE_IVF_SLABS", "int8")
    for a, g in ((ta, tg), (ja, jg)):
        with pytest.raises(ValueError,
                           match="ARROWSPACE_IVF_SLABS='int8' is not a known"):
            a.search_batch(items[:4], g, 0.62, mode="ivf_block", n_probe=2)


def test_env_slab_dtype_change_rebuilds(monkeypatch, ivf_pair):
    """A change of the variable after the blocked index exists rebuilds
    the slabs; an explicit enable_ivf(slab_dtype=...) wins over it."""
    items, (ta, tg), _ = ivf_pair
    monkeypatch.setenv("ARROWSPACE_IVF_SLABS", "f32")
    ta.enable_ivf(n_clusters=8)
    ta.search_batch(items[:4], tg, 0.62, mode="ivf_block", n_probe=2)
    assert ta._ivf_blocked.slabs.dtype == torch.float32
    monkeypatch.setenv("ARROWSPACE_IVF_SLABS", "bf16")
    ta.search_batch(items[:4], tg, 0.62, mode="ivf_block", n_probe=2)
    assert ta._ivf_blocked.slabs.dtype == torch.bfloat16
    ta.enable_ivf(slab_dtype=torch.float16)
    ta.search_batch(items[:4], tg, 0.62, mode="ivf_block", n_probe=2)
    assert ta._ivf_blocked.slabs.dtype == torch.float16


def test_profile_writes_a_trace(monkeypatch, tmp_path):
    """ARROWSPACE_PROFILE=<dir>: a CPU build writes a Chrome trace there
    that holds the build's stage labels."""
    out = tmp_path / "trace"
    monkeypatch.setenv("ARROWSPACE_PROFILE", str(out))
    items = np.random.default_rng(4).normal(size=(60, 10))
    pt.ArrowSpaceBuilder.build({"eps": 0.8, "k": 5, "topk": 6, "p": 2.0,
                                "sigma": 0.3}, items, device="cpu")
    traces = list(out.glob("*.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())[
        "traceEvents"]}
    assert {"arrowspace:knn", "arrowspace:symmetrize",
            "arrowspace:lambdas"} <= names
