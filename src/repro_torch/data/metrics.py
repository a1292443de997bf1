"""Retrieval quality metrics (NDCG@k, Precision@k, Recall@k), paper Fig. 3
(twin of ``repro/data/metrics.py``, numpy, the same values)."""
from __future__ import annotations

import numpy as np


def dcg(gains_in_rank_order: np.ndarray) -> float:
    if gains_in_rank_order.size == 0:
        return 0.0
    discounts = 1.0 / np.log2(np.arange(2, gains_in_rank_order.size + 2))
    return float(np.sum(gains_in_rank_order * discounts))


def ndcg_at_k(retrieved: np.ndarray, relevant: np.ndarray,
              gains: np.ndarray, k: int) -> float:
    gain_of = {int(d): float(g) for d, g in zip(relevant, gains)}
    got = np.array([gain_of.get(int(d), 0.0) for d in retrieved[:k]])
    ideal = np.sort(gains)[::-1][:k]
    denom = dcg(ideal)
    return dcg(got) / denom if denom > 0 else 0.0


def precision_at_k(retrieved: np.ndarray, relevant: np.ndarray, k: int) -> float:
    rel = set(int(d) for d in relevant)
    hits = sum(1 for d in retrieved[:k] if int(d) in rel)
    return hits / float(k)


def recall_at_k(retrieved: np.ndarray, relevant: np.ndarray, k: int) -> float:
    rel = set(int(d) for d in relevant)
    if not rel:
        return 0.0
    hits = sum(1 for d in retrieved[:k] if int(d) in rel)
    return hits / float(len(rel))
