"""Synthetic corpora with planted semantic structure (twin of
``repro/data/corpus.py``).

Gaussian-mixture embeddings with known topic structure; the same seed gives
the same bytes as the JAX package's `make_corpus`.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Corpus:
    texts: list[bytes]
    embeddings: np.ndarray        # (N, d) f32, unit-norm — what systems index
    latent: np.ndarray            # (N, d) f32 — ground-truth semantics
    topics: np.ndarray            # (N,) int
    d: int


def _unit(x: np.ndarray) -> np.ndarray:
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)


def make_corpus(seed: int, n_docs: int, *, emb_dim: int = 96,
                n_topics: int = 32, text_len: tuple[int, int] = (64, 256),
                topic_spread: float = 0.5,
                encoder_noise: float = 0.0) -> Corpus:
    """All noise ratios are NORM ratios (per-coordinate noise scaled by 1/√d).

    encoder_noise > 0 separates ground-truth semantics (`latent`) from what
    the systems index (`embeddings` = unit(latent + noise)).
    """
    rng = np.random.default_rng(seed)
    topic_centers = _unit(rng.standard_normal((n_topics, emb_dim)))
    topics = rng.integers(0, n_topics, n_docs)
    latent = _unit(topic_centers[topics]
                   + topic_spread / np.sqrt(emb_dim)
                   * rng.standard_normal((n_docs, emb_dim)))
    if encoder_noise > 0:
        emb = _unit(latent + encoder_noise / np.sqrt(emb_dim)
                    * rng.standard_normal((n_docs, emb_dim)))
    else:
        emb = latent
    texts = []
    for i in range(n_docs):
        ln = int(rng.integers(*text_len))
        body = f"doc:{i} topic:{topics[i]} " .encode()
        filler = rng.integers(97, 123, max(0, ln - len(body))).astype(np.uint8)
        texts.append((body + filler.tobytes())[:ln])
    return Corpus(texts=texts, embeddings=emb.astype(np.float32),
                  latent=latent.astype(np.float32), topics=topics, d=emb_dim)
