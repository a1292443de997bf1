"""Client-side finalization: exact re-rank of the decrypted cluster.

Twin of ``repro/core/rerank.py``; host-side numpy.
"""
from __future__ import annotations

import numpy as np


def cosine_scores(query_emb: np.ndarray, doc_embs: np.ndarray) -> np.ndarray:
    """Cosine similarity of one query (d,) against doc embeddings (D, d)."""
    qn = query_emb / (np.linalg.norm(query_emb) + 1e-12)
    dn = doc_embs / (np.linalg.norm(doc_embs, axis=1, keepdims=True) + 1e-12)
    return dn @ qn


def rerank(query_emb: np.ndarray,
           docs: list[tuple[int, np.ndarray, bytes]],
           top_k: int) -> list[tuple[int, float, bytes]]:
    """Top-k (doc_id, score, text) among the fetched cluster's documents."""
    if not docs:
        return []
    embs = np.stack([d[1] for d in docs])
    scores = cosine_scores(query_emb, embs)
    order = np.argsort(-scores)[:top_k]
    return [(docs[i][0], float(scores[i]), docs[i][2]) for i in order]
