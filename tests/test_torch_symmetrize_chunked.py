"""The chunked (memory-bounded) symmetrize of the PyTorch port and the
build's ARROWSPACE_SYMMETRIZE modes.

``symmetrize_to_ell_chunked`` must equal the port's one-pass
``symmetrize_to_ell`` bit for bit (ids, weights, degrees, drops) for every
chunking, and the JAX package's chunked op on the same numpy inputs: ids,
weights, drops and the overflow count bit for bit, the degrees (a row sum,
which torch and XLA add in different orders) to 1e-14.  The build's modes
give the JAX package's graph under the same variable; a device OOM and the
chunk ladder's MemoryError raise and never reach the host engine."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyarrowspace_tpu as jx
import pyarrowspace_tpu_torch as pt
from pyarrowspace_tpu.ops.symmetrize import \
    symmetrize_to_ell_chunked as jax_chunked
from pyarrowspace_tpu_torch.graph import build as build_mod
from pyarrowspace_tpu_torch.io import native
from pyarrowspace_tpu_torch.ops.symmetrize import (symmetrize_to_ell,
                                                   symmetrize_to_ell_chunked)

GP = {"eps": 0.8, "k": 5, "topk": 4, "p": 2.0, "sigma": None}


def _random_knn(n, k, seed, hub_frac=0.0):
    """tests/test_symmetrize_chunked.py's directed k-NN-like lists: k - 2
    to k distinct ids a row, a fraction of the rows pointing their first
    entry at hub node 0, weights symmetric per undirected pair."""
    rng = np.random.default_rng(seed)
    idx = np.full((n, k), -1, np.int32)
    w = np.zeros((n, k))
    for i in range(n):
        kk = rng.integers(max(1, k - 2), k + 1)
        choices = rng.choice(n - 1, size=kk, replace=False)
        choices = np.where(choices >= i, choices + 1, choices)
        idx[i, :kk] = choices
        w[i, :kk] = rng.uniform(0.1, 1.0, kk)
    if hub_frac > 0:
        for i in rng.choice(np.arange(1, n), size=int(hub_frac * n),
                            replace=False):
            idx[i, 0] = 0
    for i in range(n):
        for s in range(k):
            j = idx[i, s]
            if j >= 0:
                w[i, s] = 0.1 + 0.9 * (((i + 1) * (j + 1)) % 97) / 97.0
    return idx, w


def _assert_chunked_exact(idx, w, m, **kw):
    """The port's chunked op against its one-pass op and the JAX
    package's chunked op; returns the port's chunked result."""
    ti, tw = torch.from_numpy(idx), torch.from_numpy(w)
    one = symmetrize_to_ell(ti, tw, m)
    got = symmetrize_to_ell_chunked(ti, tw, m, **kw)
    ref = jax_chunked(jnp.asarray(idx), jnp.asarray(w), m, **kw)
    assert got[4] == int(ref[4]) == 0, "unexpected overflow"
    for a, b in zip(one[:3], got[:3]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert one[3] == got[3] == int(ref[3])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]),
                               rtol=1e-14)
    return got


@pytest.mark.parametrize("n_chunks", [1, 3, 8])
@pytest.mark.parametrize("hub_frac", [0.0, 0.5])
def test_chunked_matches_one_pass_and_reference(n_chunks, hub_frac):
    idx, w = _random_knn(300, 6, seed=1, hub_frac=hub_frac)
    _assert_chunked_exact(idx, w, 12, n_chunks=n_chunks, cap_factor=6)


def test_chunked_overflow_flagged_like_reference():
    """A hub chunk beyond cap_factor * R * k entries flags overflow, with
    the JAX package's count."""
    idx, w = _random_knn(400, 5, seed=2, hub_frac=0.9)
    got = symmetrize_to_ell_chunked(torch.from_numpy(idx),
                                    torch.from_numpy(w), 10, n_chunks=16,
                                    cap_factor=1)
    ref = jax_chunked(jnp.asarray(idx), jnp.asarray(w), 10, n_chunks=16,
                      cap_factor=1)
    assert got[4] > 0 and got[4] == int(ref[4])


def test_chunked_symmetry_invariant():
    idx, w = _random_knn(257, 7, seed=3, hub_frac=0.3)
    nbr_idx, nbr_w, _, _, over = symmetrize_to_ell_chunked(
        torch.from_numpy(idx), torch.from_numpy(w), 9, n_chunks=4,
        cap_factor=8)
    assert over == 0
    n = idx.shape[0]
    dense = np.zeros((n, n))
    ni, nw = nbr_idx.numpy(), nbr_w.numpy()
    rows = np.repeat(np.arange(n), ni.shape[1])
    keep = ni.reshape(-1) >= 0
    dense[rows[keep], ni.reshape(-1)[keep]] = nw.reshape(-1)[keep]
    np.testing.assert_array_equal(dense, dense.T)


def test_chunked_no_spurious_overflow_on_ragged_n():
    """n % n_chunks != 0 at the default cap: the last row range must not
    count the invalid entries (row n) as its own."""
    idx, w = _random_knn(1000, 6, seed=7)
    _assert_chunked_exact(idx, w, 12, n_chunks=16)


@pytest.fixture(scope="module")
def items():
    return np.random.default_rng(0).normal(size=(200, 24)) * 2.0


@pytest.fixture(scope="module")
def default_build(items):
    return pt.ArrowSpaceBuilder.build(GP, items, device="cpu")


@pytest.mark.parametrize("mode", ["auto", "device", "device_fused",
                                  "no-such-mode"])
def test_build_env_modes_match_reference(monkeypatch, items, default_build,
                                         mode):
    """Each mode gives the JAX package's graph and lambdas under the same
    variable, and the default build's bits (an unknown name is auto, as in
    the reference)."""
    monkeypatch.setenv("ARROWSPACE_SYMMETRIZE", mode)
    ta, tg = pt.ArrowSpaceBuilder.build(GP, items, device="cpu")
    ja, jg = jx.ArrowSpaceBuilder.build(GP, items)
    assert tg.nnodes == 200
    np.testing.assert_allclose(tg.to_dense(), np.asarray(jg.to_dense()),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(ta.lambdas(), ja.lambdas(), rtol=1e-9)
    da, dg = default_build
    assert torch.equal(tg.neighbor_indices, dg.neighbor_indices)
    assert torch.equal(tg.neighbor_weights, dg.neighbor_weights)


@pytest.mark.parametrize("mode", ["auto", "device"])
def test_build_takes_chunked_op_when_one_pass_does_not_fit(
        monkeypatch, items, default_build, mode):
    """Past the memory trigger the build runs the chunked op, with the
    one-pass op's bits; device_fused keeps the one-pass op."""
    calls = []
    chunked = build_mod.symmetrize_to_ell_chunked

    def spy(*args, **kw):
        calls.append(kw)
        return chunked(*args, **kw)

    monkeypatch.setattr(build_mod, "one_pass_fits", lambda *a: False)
    monkeypatch.setattr(build_mod, "symmetrize_to_ell_chunked", spy)
    monkeypatch.setenv("ARROWSPACE_SYMMETRIZE", mode)
    _, tg = pt.ArrowSpaceBuilder.build(GP, items, device="cpu")
    assert calls == [{"n_chunks": 16, "cap_factor": 3}]
    _, dg = default_build
    assert torch.equal(tg.neighbor_indices, dg.neighbor_indices)
    assert torch.equal(tg.neighbor_weights, dg.neighbor_weights)
    assert torch.equal(tg.degrees, dg.degrees)
    monkeypatch.setenv("ARROWSPACE_SYMMETRIZE", "device_fused")
    pt.ArrowSpaceBuilder.build(GP, items, device="cpu")
    assert len(calls) == 1


def _no_host_engine(*args, **kw):
    raise AssertionError("the host engine must not run")


def test_ladder_memory_error_raises_without_host_fallback(monkeypatch,
                                                          items):
    """Overflow at both rungs of the ladder ((16, 3), then (16, 12)) raises
    MemoryError naming the host mode; the host engine never runs (the
    reference would rerun on it: a divergence the port keeps)."""
    rungs = []

    def overflowing(i, w, width, n_chunks, cap_factor):
        rungs.append((n_chunks, cap_factor))
        out = symmetrize_to_ell(i, w, width)
        return (*out, 1)

    monkeypatch.setattr(build_mod, "one_pass_fits", lambda *a: False)
    monkeypatch.setattr(build_mod, "symmetrize_to_ell_chunked", overflowing)
    monkeypatch.setattr(native, "symmetrize_host", _no_host_engine)
    with pytest.raises(MemoryError, match="ARROWSPACE_SYMMETRIZE=host"):
        pt.ArrowSpaceBuilder.build(GP, items, device="cpu")
    assert rungs == [(16, 3), (16, 12)]


def test_device_oom_raises_without_host_fallback(monkeypatch, items):
    def oom(*args, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                          "allocate 9.00 GiB")

    monkeypatch.setattr(build_mod, "symmetrize_to_ell", oom)
    monkeypatch.setattr(native, "symmetrize_host", _no_host_engine)
    with pytest.raises(torch.cuda.OutOfMemoryError,
                       match="ARROWSPACE_SYMMETRIZE=host"):
        pt.ArrowSpaceBuilder.build(GP, items, device="cpu")


def test_host_mode_without_engine_raises(monkeypatch, items):
    monkeypatch.setattr(native, "get_lib", lambda: None)
    monkeypatch.setenv("ARROWSPACE_SYMMETRIZE", "host")
    with pytest.raises(RuntimeError, match="ARROWSPACE_SYMMETRIZE=host but "
                       "the native engine is unavailable"):
        pt.ArrowSpaceBuilder.build(GP, items, device="cpu")
