"""TSDAE domain adaptation of a TEXT encoder (port of
pyarrowspace_tpu/models/tsdae.py).

The reference fine-tunes a pretrained sentence encoder on the target
corpus with a denoising autoencoder objective before building the index
(reference tests/embeddings_model.py:23-35: sentence-transformers
`DenoisingAutoEncoderDataset` + `DenoisingAutoEncoderLoss` with
tie_encoder_decoder=True, 1 epoch, lr 3e-5, weight_decay 0, batch 8).
This module trains the same objective on a from-scratch mini-transformer:

* noise: per-token deletion at ratio 0.6, on the host (numpy);
* encoder: token-hash embedding + learned positions + pre-LN transformer
  blocks, mean-pooled over non-pad positions into ONE sentence vector;
* decoder: causal transformer over the ORIGINAL token sequence whose
  cross-attention memory is that single sentence vector, token table and
  output logits tied to the encoder's;
* loss: token cross-entropy of the clean text given the noisy encoding.

The arithmetic is the JAX package's: ``gelu`` in its tanh form, layer
norm with the population variance and eps 1e-6, attention masked with
-1e9 (not -inf: a fully padded row gets the uniform softmax), plain
``matmul`` / ``einsum`` (no fused attention).  Weights start from a
``torch.Generator`` seeded from the config's seed, so they are not the
JAX package's draws; models/convert.py carries those across.  The module
runs on the card unless the caller passes ``device="cpu"``; without a
card it raises.  save() writes, and load() reads, the JAX package's npz
layout (leaves ``p{i}`` in ``jax.tree.leaves`` order).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .encoders import _TOKEN_RE
from ..graph.build import resolve_device
from ..utils.debug import dbg_println, phase
from ..utils.logging import get_logger

log = get_logger("models")

_PAD, _BOS = 0, 1
_SPECIALS = 2


def _token_ids(text: str, vocab: int, seed: int) -> list[int]:
    """Word-level hashing tokenizer (blake2b of "seed:token")."""
    ids = []
    for tok in _TOKEN_RE.findall(text.lower()):
        h = hashlib.blake2b(f"{seed}:{tok}".encode(), digest_size=8)
        v = int.from_bytes(h.digest(), "little")
        ids.append(_SPECIALS + v % (vocab - _SPECIALS))
    return ids


def _encode_batch(texts: Sequence[str], vocab: int, max_len: int,
                  seed: int) -> np.ndarray:
    out = np.zeros((len(texts), max_len), dtype=np.int32)
    for i, t in enumerate(texts):
        ids = _token_ids(t, vocab, seed)[:max_len]
        out[i, : len(ids)] = ids
    return out


def _delete_noise(ids: np.ndarray, ratio: float,
                  rng: np.random.Generator) -> np.ndarray:
    """Token-deletion noise (delete each token with prob `ratio`, keep at
    least one); the JAX package's draws, call for call."""
    noisy = np.zeros_like(ids)
    for i in range(ids.shape[0]):
        toks = ids[i][ids[i] != _PAD]
        if len(toks) == 0:
            continue
        keep = rng.random(len(toks)) >= ratio
        if not keep.any():
            keep[rng.integers(len(toks))] = True
        kept = toks[keep]
        noisy[i, : len(kept)] = kept
    return noisy


def _ln(x, s, b):
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * s + b


def _mha(xq, xkv, wq, wk, wv, wo, heads: int, mask=None):
    b, lq, d = xq.shape
    lk = xkv.shape[1]
    hd = d // heads
    q = (xq @ wq).reshape(b, lq, heads, hd)
    k = (xkv @ wk).reshape(b, lk, heads, hd)
    v = (xkv @ wv).reshape(b, lk, heads, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
    if mask is not None:
        logits = torch.where(mask, logits, -1e9)
    att = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, lq, d)
    return out @ wo


class Block(nn.Module):
    """A pre-LN transformer block: self-attention, cross-attention to the
    sentence vector (decoder blocks), a gelu MLP.  Parameter names are the
    JAX package's dict keys."""

    def __init__(self, d: int, cross: bool, gen: torch.Generator, dtype,
                 device):
        super().__init__()
        self.cross = cross
        names = ["wq", "wk", "wv", "wo"] + (["cq", "ck", "cv", "co"]
                                            if cross else [])

        def normal(*shape):
            return nn.Parameter((torch.randn(shape, generator=gen,
                                             dtype=torch.float64) * 0.02)
                                .to(device=device, dtype=dtype))

        for n in names:
            setattr(self, n, normal(d, d))
        self.w1 = normal(d, 4 * d)
        self.w2 = normal(4 * d, d)
        for ln in ["ln1", "ln2"] + (["ln3"] if cross else []):
            setattr(self, ln + "_s",
                    nn.Parameter(torch.ones(d, dtype=dtype, device=device)))
            setattr(self, ln + "_b",
                    nn.Parameter(torch.zeros(d, dtype=dtype, device=device)))

    def forward(self, x, heads: int, mask=None, memory=None):
        h = _ln(x, self.ln1_s, self.ln1_b)
        x = x + _mha(h, h, self.wq, self.wk, self.wv, self.wo, heads, mask)
        if memory is not None:   # cross-attention to the sentence vector
            h = _ln(x, self.ln3_s, self.ln3_b)
            x = x + _mha(h, memory, self.cq, self.ck, self.cv, self.co,
                         heads)
        h = _ln(x, self.ln2_s, self.ln2_b)
        return x + F.gelu(h @ self.w1, approximate="tanh") @ self.w2


@dataclasses.dataclass
class TSDAEConfig:
    vocab: int = 8192
    d_model: int = 384          # MiniLM's output width
    n_layers: int = 2
    heads: int = 6
    max_len: int = 128
    noise_ratio: float = 0.6    # DenoisingAutoEncoderDataset default
    batch_size: int = 8         # reference recipe
    epochs: int = 1
    lr: float = 3e-5
    weight_decay: float = 0.0
    seed: int = 42


class TSDAEEncoder(nn.Module):
    """Text encoder adapted to a corpus with the TSDAE objective: fit on
    the raw corpus texts, then ``encode`` produces the domain-adapted
    embeddings that feed the standard build."""

    def __init__(self, config: Optional[TSDAEConfig] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.config = c = config or TSDAEConfig()
        if c.d_model % c.heads:
            raise ValueError("d_model must divide heads")
        dev = resolve_device(None, device)
        gen = torch.Generator(device="cpu").manual_seed(c.seed)

        def normal(*shape):
            return nn.Parameter((torch.randn(shape, generator=gen,
                                             dtype=torch.float64) * 0.02)
                                .to(device=dev, dtype=dtype))

        self.tok = normal(c.vocab, c.d_model)       # tied logits
        self.pos = normal(c.max_len, c.d_model)
        self.enc = nn.ModuleList([Block(c.d_model, False, gen, dtype, dev)
                                  for _ in range(c.n_layers)])
        self.dec = nn.ModuleList([Block(c.d_model, True, gen, dtype, dev)
                                  for _ in range(c.n_layers)])
        self.lnf_s = nn.Parameter(torch.ones(c.d_model, dtype=dtype,
                                             device=dev))
        self.lnf_b = nn.Parameter(torch.zeros(c.d_model, dtype=dtype,
                                              device=dev))
        self.losses_: list[float] = []

    @property
    def device(self) -> torch.device:
        return self.tok.device

    # -- the model -------------------------------------------------------------
    def encoder(self, ids: torch.Tensor) -> torch.Tensor:
        """ids [B, L] -> mean-pooled sentence embeddings [B, D]."""
        heads = self.config.heads
        np_mask = ids != _PAD
        x = self.tok[ids] + self.pos[None, : ids.shape[1]]
        att = np_mask[:, None, None, :]                    # keys only
        for blk in self.enc:
            x = blk(x, heads, mask=att)
        x = _ln(x, self.lnf_s, self.lnf_b)
        w = np_mask[:, :, None].to(x.dtype)
        return torch.sum(x * w, dim=1) / torch.clamp_min(
            torch.sum(w, dim=1), 1.0)

    def decoder_logits(self, emb: torch.Tensor,
                       tgt_ids: torch.Tensor) -> torch.Tensor:
        """Causal LM over the clean tokens, conditioned ONLY on the
        sentence embedding (cross-attention memory of length 1)."""
        heads = self.config.heads
        b, length = tgt_ids.shape
        dec_in = torch.cat([torch.full((b, 1), _BOS, dtype=tgt_ids.dtype,
                                       device=tgt_ids.device),
                            tgt_ids[:, :-1]], dim=1)
        x = self.tok[dec_in] + self.pos[None, :length]
        causal = torch.tril(torch.ones((length, length), dtype=torch.bool,
                                       device=tgt_ids.device))[None, None]
        mem = emb[:, None, :]
        for blk in self.dec:
            x = blk(x, heads, mask=causal, memory=mem)
        x = _ln(x, self.lnf_s, self.lnf_b)
        return x @ self.tok.T                              # tied logits

    def loss(self, noisy: torch.Tensor, clean: torch.Tensor) -> torch.Tensor:
        """Masked token cross-entropy of the clean ids given the noisy
        ids' sentence vector."""
        logits = self.decoder_logits(self.encoder(noisy), clean)
        mask = (clean != _PAD).to(torch.float32)
        ce = (torch.logsumexp(logits, dim=-1)
              - torch.gather(logits, -1, clean.long()[..., None])[..., 0])
        return torch.sum(ce * mask) / torch.clamp_min(torch.sum(mask), 1.0)

    def optimizer(self) -> torch.optim.Optimizer:
        """AdamW with optax.adamw's b1, b2 and eps and the config's lr and
        weight decay."""
        c = self.config
        return torch.optim.AdamW(self.parameters(), lr=c.lr,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=c.weight_decay)

    # -- the JAX package's surface -------------------------------------------
    def fit(self, texts: Sequence[str]) -> "TSDAEEncoder":
        c = self.config
        ids = _encode_batch(texts, c.vocab, c.max_len, c.seed)
        rng = np.random.default_rng(c.seed)
        opt = self.optimizer()
        dev = self.device
        n = ids.shape[0]
        losses = []
        with phase("tsdae_fit", dev):
            for epoch in range(c.epochs):
                order = rng.permutation(n)
                for s in range(0, n, c.batch_size):
                    sel = order[s: s + c.batch_size]
                    if len(sel) < c.batch_size:  # the reference's batch
                        sel = np.concatenate(
                            [sel, order[: c.batch_size - len(sel)]])
                    clean = ids[sel]
                    noisy = _delete_noise(clean, c.noise_ratio, rng)
                    opt.zero_grad(set_to_none=True)
                    loss = self.loss(torch.from_numpy(noisy).to(dev),
                                     torch.from_numpy(clean).to(dev))
                    loss.backward()
                    opt.step()
                    losses.append(loss.detach())
                self.losses_.extend(float(v) for v in losses)
                losses.clear()
                dbg_println(f"tsdae epoch {epoch}: "
                            f"loss {self.losses_[-1]:.4f}")
        return self

    @torch.no_grad()
    def encode(self, texts: Sequence[str], batch_size: int = 256,
               normalize: bool = True) -> np.ndarray:
        """texts -> [N, d_model] adapted embeddings (float32)."""
        c = self.config
        outs = []
        for s in range(0, len(texts), batch_size):
            ids = _encode_batch(list(texts[s: s + batch_size]), c.vocab,
                                c.max_len, c.seed)
            outs.append(self.encoder(torch.from_numpy(ids).to(self.device))
                        .cpu().numpy())
        emb = np.concatenate(outs, axis=0).astype(np.float32)
        if normalize:
            emb /= np.maximum(np.linalg.norm(emb, axis=1, keepdims=True),
                              1e-12)
        return emb

    def leaves(self) -> list[nn.Parameter]:
        """The parameters in ``jax.tree.leaves`` order of the JAX
        package's params dict: keys sorted (dec, enc, lnf_b, lnf_s, pos,
        tok), each block's keys sorted."""
        out = []
        for blocks in (self.dec, self.enc):
            for blk in blocks:
                out.extend(p for _, p in sorted(blk.named_parameters()))
        return out + [self.lnf_b, self.lnf_s, self.pos, self.tok]

    def save(self, path: str) -> None:
        """An npz the JAX package's TSDAEEncoder.load reads."""
        c = self.config
        flat = {f"p{i}": p.detach().cpu().numpy()
                for i, p in enumerate(self.leaves())}
        np.savez(path, _config=np.array(
            [c.vocab, c.d_model, c.n_layers, c.heads, c.max_len, c.seed],
            dtype=np.int64), **flat)

    def load_leaves(self, arrays: Sequence) -> None:
        """Copy arrays in ``leaves()`` order into the parameters (their
        dtype taken from the arrays)."""
        params = self.leaves()
        if len(arrays) != len(params):
            raise ValueError(f"expected {len(params)} arrays, got "
                             f"{len(arrays)}")
        with torch.no_grad():
            for p, a in zip(params, arrays):
                a = torch.from_numpy(np.array(a))
                if tuple(a.shape) != tuple(p.shape):
                    raise ValueError(f"leaf shape {tuple(a.shape)} != "
                                     f"{tuple(p.shape)}")
                p.data = a.to(device=p.device).clone()

    @classmethod
    def load(cls, path: str, device=None) -> "TSDAEEncoder":
        """Read an npz written by either package's save."""
        z = np.load(path)
        v, d, nl, h, ml, seed = (int(x) for x in z["_config"])
        enc = cls(TSDAEConfig(vocab=v, d_model=d, n_layers=nl, heads=h,
                              max_len=ml, seed=seed), device=device)
        enc.load_leaves([z[f"p{i}"] for i in range(len(enc.leaves()))])
        return enc


def adapt_corpus(texts: Sequence[str], config: Optional[TSDAEConfig] = None,
                 device=None) -> np.ndarray:
    """One-call reference flow: TSDAE-fit on the corpus, encode it."""
    enc = TSDAEEncoder(config, device=device)
    enc.fit(texts)
    return enc.encode(texts)
