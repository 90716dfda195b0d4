"""The port's binding of the native C++ host engine (io/native.py): the
cases of tests/test_native.py pointed at the port.  ``knn_host`` is the
float64 golden of the port's CPU k-NN, ``symmetrize_host`` equals the
port's one-pass symmetrize, and an ARROWSPACE_SYMMETRIZE=host build equals
the default build bit for bit (and the JAX package's host build).  Each
test skips when the engine cannot be built (no g++)."""

import numpy as np
import pytest
import torch

import pyarrowspace_tpu as jx
import pyarrowspace_tpu_torch as pt
from pyarrowspace_tpu_torch.io import native
from pyarrowspace_tpu_torch.ops.distance import (kernel_weights,
                                                 knn_graph_candidates,
                                                 unit_normalize)
from pyarrowspace_tpu_torch.ops.symmetrize import symmetrize_to_ell


@pytest.fixture(autouse=True)
def engine():
    if not native.native_available():
        pytest.skip("native toolchain unavailable")


def test_library_builds_outside_the_source_tree():
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.parent.name == "build"


def test_library_name_follows_the_host_cpu(monkeypatch):
    # -march=native: a library built on one CPU is never loaded on another.
    here = native.library_path()
    monkeypatch.setattr(native, "_cpu_identity", lambda: "another cpu")
    there = native.library_path()
    assert there != here and there.parent == here.parent


def test_scan_validate():
    x = np.ones((10, 4))
    x[0, 0] = np.nan
    x[1, 1] = np.inf
    x[2, 2] = -np.inf
    assert native.scan_validate(x) == (1, 2)
    assert native.scan_validate(np.zeros((3, 3))) == (0, 0)


def test_knn_host_is_the_golden_of_the_port_knn():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(120, 16))
    nd, ni = native.knn_host(x, k=7, eps=0.8)
    td, ti = knn_graph_candidates(unit_normalize(torch.from_numpy(x)), 7,
                                  0.8)
    np.testing.assert_allclose(nd, td.numpy(), atol=1e-8)
    ti = ti.numpy()
    for r in range(120):
        assert (set(ni[r][ni[r] >= 0].tolist())
                == set(ti[r][ti[r] >= 0].tolist())), r


def test_blob_roundtrip(tmp_path):
    payload = np.arange(1000, dtype=np.float32).tobytes()
    path = str(tmp_path / "seg.asx")
    assert native.write_blob(path, payload)
    assert native.blob_size(path) == len(payload)
    assert native.read_blob(path) == payload


def test_blob_rejects_garbage(tmp_path):
    path = str(tmp_path / "bad.asx")
    with open(path, "wb") as fh:
        fh.write(b"not a blob")
    assert native.blob_size(path) is None
    assert native.read_blob(path) is None


@pytest.mark.parametrize("seed,n,k,eps", [(0, 333, 6, 0.9), (1, 500, 10, 1.9),
                                          (2, 200, 4, 0.05)])
def test_symmetrize_host_matches_one_pass(seed, n, k, eps):
    """Order, dedup, the both-endpoints cap and the drop count, bit for bit
    the port's one-pass op, across edge densities."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 24)) + 0.3
    xu = x / np.linalg.norm(x, axis=1, keepdims=True)
    d = 1.0 - np.maximum(xu @ xu.T, 0.0)
    np.fill_diagonal(d, np.inf)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    dd = np.take_along_axis(d, order, 1)
    keep = dd <= eps
    i = np.where(keep, order, -1).astype(np.int32)
    w = kernel_weights(torch.from_numpy(np.where(keep, dd, 2.0)), 0.3,
                       2.0).numpy()
    w = np.where(i >= 0, w, 0.0)
    ref = symmetrize_to_ell(torch.from_numpy(i), torch.from_numpy(w), 2 * k)
    got = native.symmetrize_host(i, w, 2 * k)
    assert got is not None
    np.testing.assert_array_equal(ref[0].numpy(), got[0])
    np.testing.assert_array_equal(ref[1].numpy(), got[1])
    assert ref[3] == got[2], (seed, ref[3], got[2])


def test_host_symmetrize_build_path(monkeypatch):
    """ARROWSPACE_SYMMETRIZE=host routes the build through the native
    engine: the default build's Laplacian and lambdas bit for bit, and the
    JAX package's host build."""
    rng = np.random.default_rng(5)
    items = rng.normal(size=(300, 24)) + 0.3
    gp = {"eps": 0.9, "k": 6, "topk": 8, "p": 2.0, "sigma": 0.3}
    calls = []
    host = native.symmetrize_host

    def spy(*args):
        calls.append(args[2])
        return host(*args)

    a1, gl1 = pt.ArrowSpaceBuilder.build(gp, items, device="cpu")
    monkeypatch.setattr(native, "symmetrize_host", spy)
    monkeypatch.setenv("ARROWSPACE_SYMMETRIZE", "host")
    a2, gl2 = pt.ArrowSpaceBuilder.build(gp, items, device="cpu")
    ja, jg = jx.ArrowSpaceBuilder.build(gp, items)
    assert calls == [gl1.neighbor_indices.shape[1]]
    assert torch.equal(gl1.neighbor_indices, gl2.neighbor_indices)
    assert torch.equal(gl1.neighbor_weights, gl2.neighbor_weights)
    assert torch.equal(gl1.degrees, gl2.degrees)
    assert gl1.n_dropped_edges == gl2.n_dropped_edges == jg.n_dropped_edges
    np.testing.assert_array_equal(a1.lambdas(), a2.lambdas())
    np.testing.assert_allclose(gl2.to_dense(), np.asarray(jg.to_dense()),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(a2.lambdas(), ja.lambdas(), rtol=1e-9)
