"""Domain-adaptation and text-encoder front-ends (ports of
pyarrowspace_tpu/models): the embedding-space DomainAdapter, the TSDAE
text encoder and the hash / sentence-transformers encoders."""

from .convert import adapter_from_jax_params, tsdae_from_jax_params
from .domain_adapter import DomainAdapter
from .encoders import embed_texts, hash_embed
from .tsdae import TSDAEConfig, TSDAEEncoder, adapt_corpus

__all__ = ["DomainAdapter", "embed_texts", "hash_embed", "TSDAEConfig",
           "TSDAEEncoder", "adapt_corpus", "adapter_from_jax_params",
           "tsdae_from_jax_params"]
