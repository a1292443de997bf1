"""Synthetic corpora with planted semantic structure (twin of
``repro/data/corpus.py``).

Gaussian-mixture embeddings with known topic structure, and queries with
exact brute-force relevance labels; the same seed gives the same bytes as
the JAX package's `make_corpus` and the same arrays as its `make_queries`.
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


@dataclasses.dataclass
class QuerySet:
    embeddings: np.ndarray        # (Q, d) f32
    relevant: list[np.ndarray]    # per query: doc ids, ranked by true score
    gains: list[np.ndarray]       # graded relevance aligned with `relevant`


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


def make_queries(seed: int, corpus: Corpus, n_queries: int, *,
                 n_relevant: int = 50, noise: float = 0.25,
                 topical: bool = False) -> QuerySet:
    """Queries perturbed from random docs.

    relevance oracle (in LATENT space):
      topical=False — global cosine top-L (vector-benchmark style)
      topical=True  — cosine top-L within the anchor's topic
    """
    rng = np.random.default_rng(seed)
    anchors = rng.integers(0, len(corpus.texts), n_queries)
    q_lat = _unit(corpus.latent[anchors]
                  + noise / np.sqrt(corpus.d)
                  * rng.standard_normal((n_queries, corpus.d)))
    # the system sees the query through the same imperfect encoder: a
    # random perturbation of the same norm as the doc-side encoder gap
    enc_scale = float(np.linalg.norm(corpus.latent - corpus.embeddings,
                                     axis=1).mean())
    if enc_scale > 0:
        q = _unit(q_lat + enc_scale
                  * _unit(rng.standard_normal((n_queries, corpus.d)))
                  ).astype(np.float32)
    else:
        q = q_lat.astype(np.float32)
    rel, gains = [], []
    for i in range(n_queries):
        if topical:
            topic = corpus.topics[anchors[i]]
            pool = np.nonzero(corpus.topics == topic)[0]
        else:
            pool = np.arange(len(corpus.texts))
        scores = q_lat[i] @ corpus.latent[pool].T
        L = min(n_relevant, len(pool))
        top = pool[np.argsort(-scores)[:L]]
        rel.append(top.astype(np.int64))
        gains.append(np.linspace(1.0, 0.1, L).astype(np.float32))
    return QuerySet(embeddings=q, relevant=rel, gains=gains)
