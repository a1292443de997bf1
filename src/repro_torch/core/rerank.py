"""Client-side finalization: exact re-rank of the decrypted cluster.

Twin of ``repro/core/rerank.py``; host-side numpy.  `rerank_columns`
scores parsed columns (`chunking.ParsedColumn`) from one stacked matrix;
it returns what the twin's ``rerank`` returns for the same documents in
the same order.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.chunking import ParsedColumn


def cosine_scores(query_emb: np.ndarray, doc_embs: np.ndarray) -> np.ndarray:
    """Cosine similarity of one query (d,) against doc embeddings (D, d)."""
    qn = query_emb / (np.linalg.norm(query_emb) + 1e-12)
    dn = doc_embs / (np.linalg.norm(doc_embs, axis=1, keepdims=True) + 1e-12)
    return dn @ qn


def rerank_columns(query_emb: np.ndarray, cols: Sequence[ParsedColumn],
                   top_k: int) -> list[tuple[int, float, bytes]]:
    """Top-k (doc_id, score, text) among the documents of ``cols``,
    concatenated in order."""
    cols = [c for c in cols if len(c)]
    if not cols:
        return []
    ids = np.concatenate([c.ids for c in cols])
    embs = (cols[0].embs if len(cols) == 1
            else np.concatenate([c.embs for c in cols]))
    first = np.cumsum([0] + [len(c) for c in cols])
    scores = cosine_scores(query_emb, embs)
    order = np.argsort(-scores)[:top_k]
    col_of = np.searchsorted(first, order, side="right") - 1
    return [(int(ids[i]), float(scores[i]), cols[c].text(i - first[c]))
            for i, c in zip(order, col_of)]
