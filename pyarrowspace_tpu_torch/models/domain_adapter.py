"""Domain adaptation of embeddings (port of
pyarrowspace_tpu/models/domain_adapter.py).

A denoising autoencoder (tied LINEAR by default, which converges to the
principal-subspace projection, or a gelu MLP) is trained on the corpus
embeddings with Gaussian input corruption, and decode(encode(.)) becomes
the domain projection applied to corpus and queries alike:
x_adapted = x + alpha * (decode(encode(x)) - x).  Defaults mirror the
reference's recipe (1 epoch, lr 3e-5, seed 42); the optimizer is
``torch.optim.AdamW`` with optax.adamw's defaults (weight decay 1e-4).

The module runs on the card unless the caller passes ``device="cpu"`` or
CPU tensors; without a card it raises.  On the card it trains in float32,
on the CPU in float64 for float64 input.  Initial weights and the
per-step noise come from ``torch.Generator``s seeded from ``seed``: the
JAX package's ``jax.random`` draws are not reproduced, so the two
packages agree step for step only on weights and noise passed across
(models/convert.py, ``loss(batch, noise)``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..graph.build import _pick_dtype, resolve_device
from ..utils.debug import dbg_println, phase
from ..utils.logging import get_logger

log = get_logger("models")

_PARAM_NAMES = ("w_enc", "b_enc", "w_dec", "b_dec")


class DomainAdapter(nn.Module):
    """Denoising-autoencoder embedding adapter.

    fit() trains on [N, F] embeddings; transform() maps embeddings into
    the adapted space.  The parameters (``w_enc`` [F, hidden], and for
    arch "mlp" ``b_enc``, ``w_dec``, ``b_dec``) exist once fit() or load()
    has run; ``params`` gives them as numpy arrays under the JAX
    package's names."""

    def __init__(self, hidden: Optional[int] = None, noise_std: float = 0.2,
                 learning_rate: float = 3e-5, epochs: int = 1,
                 batch_size: int = 1024, alpha: float = 0.5,
                 arch: str = "linear", seed: int = 42,
                 weight_decay: float = 1e-4, device=None):
        super().__init__()
        if arch not in ("linear", "mlp"):
            raise ValueError(f"arch must be 'linear' or 'mlp', got {arch!r}")
        self.hidden = hidden
        self.noise_std = noise_std
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.batch_size = batch_size
        self.alpha = alpha
        self.arch = arch
        self.seed = seed
        self.weight_decay = weight_decay
        self.device_request = device
        self.losses_: list[float] = []
        self.w_enc: Optional[nn.Parameter] = None
        self.b_enc: Optional[nn.Parameter] = None
        self.w_dec: Optional[nn.Parameter] = None
        self.b_dec: Optional[nn.Parameter] = None

    # -- parameters ------------------------------------------------------------
    def set_params(self, params: dict, device=None, dtype=None) -> None:
        """Install parameters by the JAX package's names (numpy arrays or
        tensors); the arch follows from whether ``b_enc`` is present."""
        dev = resolve_device(None, device if device is not None
                             else self.device_request)
        for name in _PARAM_NAMES:
            value = params.get(name)
            if value is None:
                setattr(self, name, None)
                continue
            t = (value.detach() if isinstance(value, torch.Tensor)
                 else torch.from_numpy(np.array(value)))
            setattr(self, name, nn.Parameter(
                t.to(device=dev, dtype=dtype or t.dtype).clone()))
        self.arch = "linear" if self.b_enc is None else "mlp"

    def _init(self, dim: int, hidden: int, dtype, device) -> None:
        g = torch.Generator(device="cpu").manual_seed(self.seed)
        scale_in = 1.0 / np.sqrt(dim)
        p = {"w_enc": torch.randn((dim, hidden), generator=g,
                                  dtype=torch.float64) * scale_in}
        if self.arch == "mlp":
            p["w_dec"] = torch.randn((hidden, dim), generator=g,
                                     dtype=torch.float64) / np.sqrt(hidden)
            p["b_enc"] = torch.zeros(hidden, dtype=torch.float64)
            p["b_dec"] = torch.zeros(dim, dtype=torch.float64)
        self.set_params(p, device=device, dtype=dtype)

    @property
    def params(self) -> Optional[dict]:
        if self.w_enc is None:
            return None
        return {name: getattr(self, name).detach().cpu().numpy()
                for name in _PARAM_NAMES if getattr(self, name) is not None}

    # -- the autoencoder -------------------------------------------------------
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        h = x @ self.w_enc
        if self.b_enc is None:        # linear tied
            return h
        return F.gelu(h + self.b_enc, approximate="tanh")

    def decode(self, h: torch.Tensor) -> torch.Tensor:
        if self.b_dec is None:        # linear tied: decoder = encoder^T
            return h @ self.w_enc.T
        return h @ self.w_dec + self.b_dec

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))

    def loss(self, batch: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Mean squared reconstruction error of ``batch`` from its
        corruption batch + noise_std * noise * std(batch), ``noise`` a
        standard normal draw of the batch's shape (the population std,
        as ``jnp.std``)."""
        noisy = batch + self.noise_std * noise * torch.std(batch,
                                                           correction=0)
        return torch.mean((self(noisy) - batch) ** 2)

    def optimizer(self) -> torch.optim.Optimizer:
        """AdamW with optax.adamw's defaults (b1 0.9, b2 0.999, eps 1e-8)
        and this adapter's weight decay."""
        return torch.optim.AdamW(self.parameters(), lr=self.learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=self.weight_decay)

    # -- the JAX package's surface -----------------------------------------
    def fit(self, embeddings) -> "DomainAdapter":
        dev = resolve_device(embeddings, self.device_request)
        arr = (embeddings if isinstance(embeddings, torch.Tensor)
               else np.asarray(embeddings))
        x = torch.as_tensor(arr).to(device=dev,
                                    dtype=_pick_dtype(arr, dev))
        n, f = x.shape
        hidden = self.hidden or max(32, f // 2)
        self._init(f, hidden, x.dtype, dev)
        opt = self.optimizer()
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        bs = min(self.batch_size, n)
        n_batches = max(1, n // bs)
        with phase("domain_adapter_fit", dev):
            order = np.random.default_rng(self.seed).permutation(n)
            x_shuf = x[torch.as_tensor(order, device=dev)]
            for epoch in range(self.epochs):
                for b in range(n_batches):
                    batch = x_shuf[b * bs:(b + 1) * bs]
                    noise = torch.randn(batch.shape, generator=gen,
                                        dtype=batch.dtype, device=dev)
                    opt.zero_grad(set_to_none=True)
                    loss = self.loss(batch, noise)
                    loss.backward()
                    opt.step()
                self.losses_.append(float(loss.detach()))
                dbg_println(f"domain_adapter epoch {epoch}: "
                            f"loss={self.losses_[-1]:.6f}")
                log.debug("epoch %d loss %.6f", epoch, self.losses_[-1])
        return self

    @torch.no_grad()
    def transform(self, embeddings) -> np.ndarray:
        if self.w_enc is None:
            raise ValueError("DomainAdapter.transform before fit")
        x = torch.as_tensor(np.asarray(embeddings) if not isinstance(
            embeddings, torch.Tensor) else embeddings).to(
            device=self.w_enc.device, dtype=self.w_enc.dtype)
        out = x + self.alpha * (self(x) - x)
        return out.cpu().numpy()

    def save(self, path: str) -> None:
        """An npz the JAX package's DomainAdapter.load reads."""
        if self.w_enc is None:
            raise ValueError("DomainAdapter.save before fit")
        np.savez(path if path.endswith(".npz") else path + ".npz",
                 **self.params,
                 _meta=np.asarray([self.alpha, self.noise_std]))

    @classmethod
    def load(cls, path: str, device=None) -> "DomainAdapter":
        """Read an npz written by either package's save."""
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        meta = z["_meta"]
        adapter = cls(alpha=float(meta[0]), noise_std=float(meta[1]),
                      device=device)
        adapter.set_params({k: z[k] for k in _PARAM_NAMES if k in z})
        return adapter
