"""The PyTorch port's trainers (pyarrowspace_tpu_torch/models) against the
JAX package's: the embedding-space DomainAdapter and the TSDAE text
encoder, with the JAX package's weights carried across in float64
(models/convert.py) and the same noise passed to both.  Tolerances: the
adapter 1e-10, TSDAE 1e-9 (float64; the two libraries sum in other
orders).  Then the port's own versions of tests/test_models.py's
behavioural cases, and the save / load round trips both ways."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pyarrowspace_tpu.models import domain_adapter as jda
from pyarrowspace_tpu.models import tsdae as jts
from pyarrowspace_tpu_torch.models import (DomainAdapter, TSDAEConfig,
                                           TSDAEEncoder, adapt_corpus,
                                           adapter_from_jax_params,
                                           tsdae_from_jax_params)
from pyarrowspace_tpu_torch.models import tsdae as pts

ADAPTER_TOL = 1e-10
TSDAE_TOL = 1e-9


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread a test: the tensors are tiny, and the suite runs
    beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(t):
    return t.detach().cpu().numpy()


# -- DomainAdapter ------------------------------------------------------------
@pytest.mark.parametrize("arch", ["linear", "mlp"])
def test_adapter_matches_jax_step_for_step(arch):
    """_encode / _decode, the loss on the same batch and noise, its
    gradients, three AdamW steps (optax.adamw's default weight decay) and
    transform, all at 1e-10."""
    rng = np.random.default_rng(3)
    f, hidden, bs, lr, noise_std = 24, 12, 32, 1e-2, 0.2
    params = jax.tree.map(np.asarray, jda._init_params(
        jax.random.PRNGKey(5), f, hidden, jnp.float64, arch))
    adapter = adapter_from_jax_params(params, device="cpu",
                                      learning_rate=lr, noise_std=noise_std)
    assert adapter.arch == arch
    x = rng.normal(size=(bs, f))
    xt = torch.from_numpy(x)
    jp = jax.tree.map(jnp.asarray, params)
    np.testing.assert_allclose(_np(adapter.encode(xt)),
                               np.asarray(jda._encode(jp, jnp.asarray(x))),
                               rtol=ADAPTER_TOL, atol=ADAPTER_TOL)
    h = rng.normal(size=(bs, hidden))
    np.testing.assert_allclose(
        _np(adapter.decode(torch.from_numpy(h))),
        np.asarray(jda._decode(jp, jnp.asarray(h))), rtol=ADAPTER_TOL,
        atol=ADAPTER_TOL)

    tx = optax.adamw(lr)
    state = tx.init(jp)
    opt = adapter.optimizer()

    def jloss(p, batch, noise):
        noisy = batch + noise_std * noise * jnp.std(batch)
        recon = jda._decode(p, jda._encode(p, noisy))
        return jnp.mean((recon - batch) ** 2)

    @jax.jit
    def jstep(p, s, batch, noise):
        loss, g = jax.value_and_grad(jloss)(p, batch, noise)
        updates, s = tx.update(g, s, p)
        return loss, g, optax.apply_updates(p, updates), s

    for _ in range(3):
        batch = rng.normal(size=(bs, f))
        noise = rng.normal(size=(bs, f))
        lj, gj, jp, state = jstep(jp, state, jnp.asarray(batch),
                                  jnp.asarray(noise))
        opt.zero_grad()
        lt = adapter.loss(torch.from_numpy(batch), torch.from_numpy(noise))
        lt.backward()
        assert float(lt.detach()) == pytest.approx(float(lj), rel=ADAPTER_TOL)
        for name, g in gj.items():
            np.testing.assert_allclose(_np(getattr(adapter, name).grad),
                                       np.asarray(g), rtol=ADAPTER_TOL,
                                       atol=ADAPTER_TOL)
        opt.step()
        for name, v in jp.items():
            np.testing.assert_allclose(_np(getattr(adapter, name)),
                                       np.asarray(v), rtol=ADAPTER_TOL,
                                       atol=ADAPTER_TOL)

    ref = jda.DomainAdapter(alpha=adapter.alpha,
                            params=jax.tree.map(np.asarray, jp))
    np.testing.assert_allclose(adapter.transform(x), ref.transform(x),
                               rtol=ADAPTER_TOL, atol=ADAPTER_TOL)


def test_adapter_denoises_toward_manifold():
    rng = np.random.default_rng(0)
    base = rng.normal(size=(20, 64))
    train = np.repeat(base, 50, axis=0) + 0.1 * rng.normal(size=(1000, 64))
    adapter = DomainAdapter(epochs=200, learning_rate=3e-3, alpha=1.0,
                            batch_size=256, seed=0, device="cpu").fit(train)
    held = np.repeat(base, 5, axis=0)
    noisy = held + 0.3 * rng.normal(size=held.shape)
    adapted = adapter.transform(noisy)
    before = np.linalg.norm(noisy - held, axis=1).mean()
    after = np.linalg.norm(adapted - held, axis=1).mean()
    assert after < before
    assert adapter.losses_[-1] < adapter.losses_[0]


def test_adapter_fit_is_deterministic():
    x = np.random.default_rng(2).normal(size=(300, 16))
    a = DomainAdapter(epochs=3, batch_size=64, device="cpu").fit(x)
    b = DomainAdapter(epochs=3, batch_size=64, device="cpu").fit(x)
    for name, v in a.params.items():
        np.testing.assert_array_equal(v, b.params[name])


@pytest.mark.parametrize("arch", ["linear", "mlp"])
def test_adapter_save_load_both_ways(tmp_path, arch):
    """The port reads the JAX package's npz and the JAX package reads the
    port's; transform agrees at 1e-10 (float64)."""
    x = np.random.default_rng(1).normal(size=(200, 32))
    ours = DomainAdapter(epochs=2, batch_size=64, arch=arch,
                         device="cpu").fit(x)
    p = str(tmp_path / "ours.npz")
    ours.save(p)
    theirs = jda.DomainAdapter.load(p)
    assert theirs.arch == arch
    np.testing.assert_allclose(ours.transform(x[:5]), theirs.transform(x[:5]),
                               rtol=ADAPTER_TOL, atol=ADAPTER_TOL)
    jfit = jda.DomainAdapter(epochs=2, batch_size=64, arch=arch).fit(x)
    q = str(tmp_path / "theirs.npz")
    jfit.save(q)
    back = DomainAdapter.load(q, device="cpu")
    assert back.arch == arch
    np.testing.assert_allclose(back.transform(x[:5]), jfit.transform(x[:5]),
                               rtol=ADAPTER_TOL, atol=ADAPTER_TOL)


def test_adapter_errors_and_device():
    with pytest.raises(ValueError, match="before fit"):
        DomainAdapter(device="cpu").transform(np.zeros((2, 4)))
    with pytest.raises(ValueError, match="before fit"):
        DomainAdapter(device="cpu").save("unused.npz")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DomainAdapter().fit(np.zeros((8, 4)))
    # A CPU tensor picks the CPU by itself.
    a = DomainAdapter(batch_size=4).fit(torch.ones((8, 4)))
    assert a.w_enc.device.type == "cpu" and a.w_enc.dtype == torch.float32


def test_linear_adapter_denoises_manifold():
    """tests/test_models.py's characterization: the tied linear adapter
    reconstructs a rank-40 manifold and strips off-manifold noise."""
    rng = np.random.default_rng(0)
    dim, r, n = 128, 40, 2000
    m = rng.normal(size=(r, dim)).astype(np.float32) / np.sqrt(r)
    corpus = (rng.normal(size=(n, r)).astype(np.float32) @ m) * 100.0
    ad = DomainAdapter(epochs=800, alpha=1.0, hidden=64, learning_rate=1e-3,
                       arch="linear", device="cpu").fit(corpus)
    rec = ad.transform(corpus)
    assert np.linalg.norm(rec - corpus) / np.linalg.norm(corpus) < 0.1
    noise = rng.normal(size=(200, dim)).astype(np.float32) * 100
    assert np.linalg.norm(ad.transform(noise)) / np.linalg.norm(noise) < 0.75


# -- TSDAE ----------------------------------------------------------------------
SMALL = dict(vocab=512, d_model=32, n_layers=2, heads=4, max_len=16)
CORPUS = [
    "heap overflow in the image parser allows remote code execution",
    "stack overflow in the pdf parser allows remote code execution",
    "cross site scripting in the admin panel leaks session cookies",
    "sql injection in the login form leaks user credentials",
    "use after free in the font renderer allows remote code execution",
    "improper input validation in the upload handler leaks files",
    "buffer overflow in the audio decoder allows remote code",
    "path traversal in the download endpoint leaks arbitrary files",
] * 4


def _small_config(**kw):
    base = dict(SMALL, epochs=8, lr=1e-3, batch_size=8, seed=0)
    base.update(kw)
    return TSDAEConfig(**base)


def _jax_config(cfg: TSDAEConfig):
    return jts.TSDAEConfig(**{f: getattr(cfg, f) for f in (
        "vocab", "d_model", "n_layers", "heads", "max_len", "noise_ratio",
        "batch_size", "epochs", "lr", "weight_decay", "seed")})


def test_tokenizer_and_noise_are_the_jax_packages():
    ids = pts._encode_batch(CORPUS[:8], 512, 16, 0)
    np.testing.assert_array_equal(ids, jts._encode_batch(CORPUS[:8], 512,
                                                         16, 0))
    np.testing.assert_array_equal(
        pts._delete_noise(ids, 0.6, np.random.default_rng(4)),
        jts._delete_noise(ids, 0.6, np.random.default_rng(4)))


def test_tsdae_matches_jax_step_for_step():
    """Encoder embeddings, decoder logits, the masked CE loss, its
    gradients and one AdamW step (weight decay 0) on the same noisy /
    clean ids, the JAX package's float64 weights carried across: 1e-9."""
    cfg = _small_config(lr=1e-3)
    params = jts._init_params(jax.random.PRNGKey(0), cfg.vocab, cfg.d_model,
                              cfg.max_len, cfg.n_layers)
    assert params["tok"].dtype == jnp.float64
    ours = tsdae_from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                 device="cpu")
    assert ours.tok.dtype == torch.float64
    clean = pts._encode_batch(CORPUS[:8], cfg.vocab, cfg.max_len, cfg.seed)
    clean[3] = 0                      # a fully padded row
    noisy = pts._delete_noise(clean, 0.6, np.random.default_rng(1))
    nj, cj = jnp.asarray(noisy), jnp.asarray(clean)
    nt, ct = torch.from_numpy(noisy), torch.from_numpy(clean)

    emb_j = jax.jit(jts._encoder, static_argnums=2)(params, nj, cfg.heads)
    emb_t = ours.encoder(nt)
    np.testing.assert_allclose(_np(emb_t), np.asarray(emb_j),
                               rtol=TSDAE_TOL, atol=TSDAE_TOL)
    np.testing.assert_allclose(
        _np(ours.decoder_logits(emb_t, ct)),
        np.asarray(jax.jit(jts._decoder_logits, static_argnums=3)(
            params, emb_j, cj, cfg.heads)),
        rtol=TSDAE_TOL, atol=TSDAE_TOL)

    def jloss(p):
        logits = jts._decoder_logits(p, jts._encoder(p, nj, cfg.heads), cj,
                                     cfg.heads)
        mask = (cj != 0).astype(jnp.float32)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, cj)
        return jnp.sum(ce * mask) / jnp.maximum(jnp.sum(mask), 1.0)

    lj, gj = jax.jit(jax.value_and_grad(jloss))(params)
    tx = optax.adamw(cfg.lr, weight_decay=cfg.weight_decay)

    @jax.jit
    def adamw_step(p, g):
        updates, _ = tx.update(g, tx.init(p), p)
        return optax.apply_updates(p, updates)

    new_j = adamw_step(params, gj)

    opt = ours.optimizer()
    lt = ours.loss(nt, ct)
    lt.backward()
    assert float(lt.detach()) == pytest.approx(float(lj), rel=TSDAE_TOL)
    leaves = ours.leaves()
    for p, g in zip(leaves, jax.tree.leaves(gj)):
        np.testing.assert_allclose(_np(p.grad), np.asarray(g),
                                   rtol=TSDAE_TOL, atol=TSDAE_TOL)
    opt.step()
    for p, v in zip(leaves, jax.tree.leaves(new_j)):
        np.testing.assert_allclose(_np(p), np.asarray(v), rtol=TSDAE_TOL,
                                   atol=TSDAE_TOL)


def test_tsdae_training_reduces_loss():
    enc = TSDAEEncoder(_small_config(n_layers=1), device="cpu")
    enc.fit(CORPUS)
    first = np.mean(enc.losses_[:4])
    last = np.mean(enc.losses_[-4:])
    assert last < 0.85 * first, (first, last)


def test_tsdae_encode_shape_norm_and_determinism():
    enc = TSDAEEncoder(_small_config(), device="cpu")
    e1 = enc.encode(CORPUS[:5])
    assert e1.shape == (5, 32) and e1.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(e1, axis=1), 1.0, rtol=1e-5)
    np.testing.assert_array_equal(e1, enc.encode(CORPUS[:5]))
    np.testing.assert_allclose(e1, enc.encode(CORPUS[:5], batch_size=2),
                               atol=1e-5)
    same = TSDAEEncoder(_small_config(), device="cpu")
    for a, b in zip(enc.leaves(), same.leaves()):
        assert torch.equal(a, b)


def test_tsdae_adapted_embeddings_preserve_lexical_similarity():
    enc = TSDAEEncoder(_small_config(n_layers=1), device="cpu")
    enc.fit(CORPUS)
    emb = enc.encode([
        "heap overflow in the image parser allows remote code",
        "stack overflow in the image parser allows remote code",
        "sql injection in the login form leaks user credentials",
    ])
    assert float(emb[0] @ emb[1]) > float(emb[0] @ emb[2])


def test_tsdae_save_load_both_ways(tmp_path):
    """The JAX package loads the port's npz and the port loads the JAX
    package's: encode agrees at 1e-6 (float32 weights)."""
    cfg = _small_config(epochs=1)
    ours = TSDAEEncoder(cfg, device="cpu")
    ours.fit(CORPUS[:8])
    p = str(tmp_path / "ours.npz")
    ours.save(p)
    theirs = jts.TSDAEEncoder.load(p)
    np.testing.assert_allclose(ours.encode(CORPUS[:3]),
                               theirs.encode(CORPUS[:3]), atol=1e-6)
    back = pts.TSDAEEncoder.load(p, device="cpu")
    np.testing.assert_array_equal(ours.encode(CORPUS[:3]),
                                  back.encode(CORPUS[:3]))

    jfit = jts.TSDAEEncoder(_jax_config(cfg))
    jfit.fit(CORPUS[:8])
    q = str(tmp_path / "theirs.npz")
    jfit.save(q)
    loaded = pts.TSDAEEncoder.load(q, device="cpu")
    np.testing.assert_allclose(loaded.encode(CORPUS[:3]),
                               jfit.encode(CORPUS[:3]), atol=1e-6)


def test_adapt_corpus_end_to_end_build():
    """CVE-style texts -> TSDAE adapt -> the port's build -> search stays
    self-consistent."""
    from pyarrowspace_tpu_torch import ArrowSpaceBuilder
    emb = adapt_corpus(CORPUS[:16], _small_config(n_layers=1, epochs=2),
                       device="cpu")
    gp = {"eps": 1.31, "k": 4, "topk": 5, "p": 2.0, "sigma": None}
    aspace, gl = ArrowSpaceBuilder.build(gp, emb.astype(np.float64),
                                         device="cpu")
    hits = aspace.search(emb[0].astype(np.float64), gl, 0.62)
    assert hits[0][0] == 0


def test_tsdae_needs_a_card_or_cpu():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TSDAEEncoder(_small_config())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            adapt_corpus(CORPUS[:4], _small_config())
    with pytest.raises(ValueError, match="d_model must divide heads"):
        TSDAEEncoder(_small_config(heads=5), device="cpu")
