"""The spectral stage and the reduction of the PyTorch port against the JAX
package, in float64 on the same numpy inputs: the feature Laplacian (binary
and sigma-scale paths), Rayleigh energies, dispersion, tau* (an even count,
where the median averages the two middle values), lambda synthesis, and
reduce_corpus (same numpy draws, so the same sample, K and assignments)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyarrowspace_tpu.core.params import TauMode
from pyarrowspace_tpu.graph import feature as jfeat
from pyarrowspace_tpu.ops import rayleigh as jray
from pyarrowspace_tpu.reduction import pipeline as jred
from pyarrowspace_tpu.spectral import taumode as jtau
from pyarrowspace_tpu_torch.core.params import TauMode as TTauMode
from pyarrowspace_tpu_torch.graph import feature as tfeat
from pyarrowspace_tpu_torch.ops import rayleigh as tray
from pyarrowspace_tpu_torch.reduction import pipeline as tred
from pyarrowspace_tpu_torch.spectral import taumode as ttau
from pyarrowspace_tpu_torch.utils.stats import median

TOL = 1e-9


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("sigma_scale", [None, 0.25, 0.6, 4.0])
def test_feature_laplacian_matches_reference(sigma_scale):
    signals = np.random.default_rng(1).normal(size=(60, 16)) * 3.0 + 0.5
    ref = jfeat.build_feature_laplacian(jnp.asarray(signals), k_f=4,
                                        sigma_scale=sigma_scale)
    got = tfeat.build_feature_laplacian(torch.from_numpy(signals), k_f=4,
                                        sigma_scale=sigma_scale)
    for g, r in zip(got, ref):
        _close(g.numpy(), r)


def test_feature_laplacian_ties_and_small_f():
    """Duplicated feature columns tie exactly; F smaller than k_f + 1."""
    s = np.random.default_rng(2).normal(size=(30, 5))
    s[:, 3] = s[:, 1]
    for k_f in (2, 6):
        ref = jfeat.build_feature_laplacian(jnp.asarray(s), k_f=k_f)
        got = tfeat.build_feature_laplacian(torch.from_numpy(s), k_f=k_f)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))


@pytest.mark.parametrize("normalized", [False, True])
def test_rayleigh_dispersion_synthesis_match_reference(normalized):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(50, 12)) + 0.2
    w_f, lap_f, _ = jfeat.build_feature_laplacian(jnp.asarray(x), k_f=3)
    e_un = jray.rayleigh_batch(jnp.asarray(x), lap_f, normalized=False)
    e = jray.rayleigh_batch(jnp.asarray(x), lap_f, normalized=normalized)
    g = jray.dispersion_batch(jnp.asarray(x), w_f, e_un)
    tx, tw, tl = (torch.from_numpy(a) for a in (x, np.asarray(w_f),
                                                np.asarray(lap_f)))
    te_un = tray.rayleigh_batch(tx, tl, normalized=False)
    te = tray.rayleigh_batch(tx, tl, normalized=normalized)
    tg = tray.dispersion_batch(tx, tw, te_un)
    _close(te.numpy(), e)
    _close(tg.numpy(), g)
    ts = ttau.derive_tau_star(te, TTauMode.MEDIAN)
    js = jtau.derive_tau_star(e, TauMode.MEDIAN)
    _close(float(ts), float(js))
    _close(ttau.synthesize(te, tg, ts).numpy(), jtau.synthesize(e, g, js))


def test_tau_star_modes_with_even_count():
    e = np.random.default_rng(4).uniform(0.1, 5.0, 60)
    for jm, tm in ((TauMode.MEDIAN, TTauMode.MEDIAN),
                   (TauMode.MEAN, TTauMode.MEAN), (TauMode.MAX, TTauMode.MAX)):
        _close(float(ttau.derive_tau_star(torch.from_numpy(e), tm)),
               float(jtau.derive_tau_star(jnp.asarray(e), jm)))
    assert float(ttau.derive_tau_star(torch.from_numpy(e), TTauMode.FIXED,
                                      0.3)) == 0.3
    with pytest.raises(ValueError):
        ttau.derive_tau_star(torch.from_numpy(e), TTauMode.FIXED)
    # torch.median would return the lower middle value here.
    assert float(median(torch.tensor([1.0, 2.0, 4.0, 9.0]))) == 3.0


def test_nan_median_matches_numpy():
    x = np.random.default_rng(5).normal(size=(7, 10))
    x[x > 0.8] = np.nan
    x[2] = np.nan
    got = median(torch.from_numpy(x), dim=1, ignore_nan=True).numpy()
    with np.errstate(all="ignore"), pytest.warns(RuntimeWarning):
        ref = np.nanmedian(x, axis=1)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    _close(got[~np.isnan(ref)], ref[~np.isnan(ref)], 1e-15)
    _close(float(median(torch.from_numpy(x), ignore_nan=True)),
           float(np.nanmedian(x)), 1e-15)


def test_reduce_corpus_matches_reference():
    x = np.random.default_rng(6).normal(size=(5000, 16))
    x[:2500] += 2.0
    ref = jred.reduce_corpus(jnp.asarray(x), seed=42, eps_hint=1.31)
    got = tred.reduce_corpus(torch.from_numpy(x), seed=42, eps_hint=1.31)
    assert (got.n_sampled, got.k_clusters, got.intrinsic_dim) == (
        ref.n_sampled, ref.k_clusters, ref.intrinsic_dim)
    np.testing.assert_array_equal(got.assignments.numpy(),
                                  np.asarray(ref.assignments))
    _close(got.centroids.numpy(), ref.centroids)


def test_twonn_and_k_search_match_reference():
    x = np.random.default_rng(7).normal(size=(3000, 6))
    assert tred.twonn_intrinsic_dim(torch.from_numpy(x), seed=3)[0] == \
        jred.twonn_intrinsic_dim(jnp.asarray(x), seed=3)[0]
    _close(tred.twonn_intrinsic_dim(torch.from_numpy(x), seed=3)[1],
           jred.twonn_intrinsic_dim(jnp.asarray(x), seed=3)[1])
    assert tred.select_k_searched(torch.from_numpy(x), 3000, 4, 0.8) == \
        jred.select_k_searched(jnp.asarray(x), 3000, 4, 0.8)
    assert tred.k_search_range(188305, 3, 1.31) == \
        jred.k_search_range(188305, 3, 1.31)
