"""Text -> embedding front-ends (a numpy copy of
pyarrowspace_tpu/models/encoders.py)."""

from .encoders import embed_texts, hash_embed

__all__ = ["embed_texts", "hash_embed"]
