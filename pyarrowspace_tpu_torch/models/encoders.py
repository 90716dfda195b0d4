"""Text -> embedding front-ends for the evaluation harness.

The reference embeds corpora with sentence-transformers (MiniLM 384-d /
mpnet 768-d — tests/test_2:146-154, test_3:129-150).  `embed_texts` uses the
same stack when the model weights are locally available; in offline
environments it falls back to `hash_embed`, a deterministic feature-hashing
encoder, so every protocol stays runnable end-to-end without network access.
"""

from __future__ import annotations

import hashlib
import re
from typing import Optional, Sequence

import numpy as np

from ..utils.logging import get_logger

log = get_logger("encoders")

_TOKEN_RE = re.compile(r"[a-z0-9]+")


def hash_embed(texts: Sequence[str], dim: int = 384,
               seed: int = 42) -> np.ndarray:
    """Deterministic feature-hashing text encoder (offline fallback).

    Unigram+bigram tokens are hashed into `dim` buckets with signed counts,
    then L2-normalized — the classic hashing-trick encoder.  Quality is far
    below a learned model but preserves lexical similarity structure, which
    is enough for protocol smoke runs.
    """
    out = np.zeros((len(texts), dim), dtype=np.float32)
    for row, text in enumerate(texts):
        toks = _TOKEN_RE.findall(text.lower())
        grams = toks + [a + "_" + b for a, b in zip(toks, toks[1:])]
        for g in grams:
            h = hashlib.blake2b(f"{seed}:{g}".encode(),
                                digest_size=8).digest()
            v = int.from_bytes(h, "little")
            out[row, v % dim] += 1.0 if (v >> 63) & 1 else -1.0
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    return out / np.maximum(norms, 1e-12)


def embed_texts(texts: Sequence[str],
                model_name: str = "sentence-transformers/all-MiniLM-L6-v2",
                batch_size: int = 256, dim_fallback: int = 384,
                device: Optional[str] = None) -> np.ndarray:
    """Embed with sentence-transformers when available, else hash_embed.

    Never raises on a missing model/network — logs and falls back, so the
    harness protocols degrade gracefully offline.
    """
    try:
        from sentence_transformers import SentenceTransformer
        model = SentenceTransformer(model_name, device=device or "cpu",
                                    local_files_only=True)
        emb = model.encode(list(texts), batch_size=batch_size,
                           convert_to_numpy=True, show_progress_bar=False)
        return np.asarray(emb, dtype=np.float32)
    except Exception as e:
        log.warning("sentence-transformers unavailable (%s); "
                    "using hash_embed fallback", e)
        return hash_embed(texts, dim=dim_fallback)
