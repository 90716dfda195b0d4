"""Carry the JAX package's trained weights across into this package's
modules: the params of a ``pyarrowspace_tpu.models.DomainAdapter`` (a dict
of arrays) and of a ``pyarrowspace_tpu.models.TSDAEEncoder`` (the nested
dict of arrays and lists of block dicts), as numpy arrays.  The arrays keep
their dtype (float64 under ``jax_enable_x64``)."""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

from .domain_adapter import DomainAdapter
from .tsdae import TSDAEConfig, TSDAEEncoder


def adapter_from_jax_params(params: Mapping[str, np.ndarray], device=None,
                            **kwargs) -> DomainAdapter:
    """A DomainAdapter holding ``params`` (keys w_enc and, for the mlp
    arch, b_enc, w_dec, b_dec); ``kwargs`` are DomainAdapter's settings
    (alpha, noise_std, learning_rate, ...)."""
    adapter = DomainAdapter(device=device, **kwargs)
    adapter.set_params(dict(params))
    return adapter


def tsdae_leaves(params: Mapping) -> list[np.ndarray]:
    """The JAX params dict flattened in ``jax.tree.leaves`` order: sorted
    keys, each block's keys sorted."""
    out = []
    for key in sorted(params):
        value = params[key]
        if isinstance(value, (list, tuple)):
            for blk in value:
                out.extend(np.asarray(blk[k]) for k in sorted(blk))
        else:
            out.append(np.asarray(value))
    return out


def tsdae_from_jax_params(params: Mapping, config: Optional[TSDAEConfig]
                          = None, device=None) -> TSDAEEncoder:
    """A TSDAEEncoder of ``config`` holding the JAX package's ``params``."""
    enc = TSDAEEncoder(config, device=device)
    enc.load_leaves(tsdae_leaves(params))
    return enc
