"""Delta planner: mutation batch → touched clusters or a full-rebuild trigger.

A copy of ``repro/update/planner.py`` (numpy only).

The planner resolves a mutation batch against the current doc→cluster map,
computes the new contents of every touched cluster, and runs the
column-capacity accounting that decides between the two publish paths:

  delta epoch   — every touched column still fits in m rows and the
                  projected pad fraction stays under the threshold; the
                  live index re-packs only those columns and ships a
                  sparse HintPatch.
  full rebuild  — an insert overflows a column (m must grow) or deletes
                  have degraded pad_fraction past `max_pad_fraction`
                  (the m×n matrix is mostly padding, so downlink and
                  server GEMM cost are being wasted); re-cluster, re-pack
                  and re-hint from scratch, shipping a full-hint patch.

Inserts are assigned to their nearest PUBLIC centroid — the same rule the
client uses to route queries, so freshly inserted documents are reachable
by the very next query without re-clustering.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

import numpy as np

from repro_torch.core import chunking
from repro_torch.update import journal as journal_lib


@dataclasses.dataclass(frozen=True)
class UpdatePlan:
    """Resolved effect of one mutation batch."""
    touched: tuple[int, ...]                 # sorted touched cluster ids
    docs_by_cluster: dict[int, list[chunking.DocTriple]]  # new full contents
    new_docs: dict[int, tuple[bytes, np.ndarray]]         # id → (text, emb)
    new_cluster_of: dict[int, int]           # id → cluster after the batch
    full_rebuild: bool
    reason: str | None                       # overflow | pad-degradation
    projected_pad_fraction: float


def nearest_centroid(emb: np.ndarray, centroids: np.ndarray) -> int:
    d2 = ((centroids - emb[None, :]) ** 2).sum(axis=1)
    return int(np.argmin(d2))


def plan_updates(mutations: Sequence[journal_lib.Mutation], *,
                 docs: Mapping[int, tuple[bytes, np.ndarray]],
                 cluster_of: Mapping[int, int],
                 centroids: np.ndarray,
                 m: int,
                 used_bytes: Mapping[int, int],
                 n_clusters: int,
                 emb_dim: int,
                 max_pad_fraction: float = 0.95,
                 assign_fn: Callable[[int, np.ndarray], int] | None = None
                 ) -> UpdatePlan:
    """Resolve `mutations` in order and account column capacity.

    ``assign_fn(doc_id, emb) -> cluster`` overrides the nearest-centroid
    placement rule for inserts/replaces.  Keyed (embedding-table) systems
    pass the id→group map here: their column membership is a public
    function of the ID, so a replaced row must stay in its id-derived
    group — re-routing it by embedding similarity would silently break the
    client's fixed-stride decode arithmetic.
    """
    new_docs = dict(docs)
    new_cluster_of = dict(cluster_of)
    touched: set[int] = set()

    for mut in mutations:
        if mut.kind == journal_lib.DELETE:
            if mut.doc_id not in new_docs:
                raise KeyError(f"delete of unknown doc_id {mut.doc_id}")
            del new_docs[mut.doc_id]
            touched.add(new_cluster_of.pop(mut.doc_id))
            continue
        if mut.kind == journal_lib.INSERT and mut.doc_id in new_docs:
            raise KeyError(f"insert of existing doc_id {mut.doc_id}")
        if mut.kind == journal_lib.REPLACE and mut.doc_id not in new_docs:
            raise KeyError(f"replace of unknown doc_id {mut.doc_id}")
        emb = np.asarray(mut.emb, np.float32)
        if emb.shape != (emb_dim,):
            raise ValueError(f"embedding dim {emb.shape} != ({emb_dim},)")
        old_cluster = new_cluster_of.get(mut.doc_id)
        if old_cluster is not None:
            touched.add(old_cluster)       # replace may move the doc
        cl = (nearest_centroid(emb, centroids) if assign_fn is None
              else int(assign_fn(mut.doc_id, emb)))
        new_docs[mut.doc_id] = (mut.text, emb)
        new_cluster_of[mut.doc_id] = cl
        touched.add(cl)

    # New contents of every touched cluster (canonical doc_id order comes
    # from pack_column; membership from the post-batch cluster map).
    docs_by_cluster: dict[int, list[chunking.DocTriple]] = {
        j: [] for j in touched}
    for doc_id, cl in new_cluster_of.items():
        if cl in docs_by_cluster:
            text, emb = new_docs[doc_id]
            docs_by_cluster[cl].append((doc_id, emb, text))

    # Capacity accounting: per-column payload vs the m-row budget.
    full_rebuild, reason = False, None
    new_used = dict(used_bytes)
    for j in touched:
        need = chunking.column_payload_bytes(
            emb_dim, [len(t) for _, _, t in docs_by_cluster[j]])
        new_used[j] = need
        if need > m:
            full_rebuild, reason = True, "overflow"
    pad = 1.0 - sum(new_used.values()) / float(m * n_clusters)
    if not full_rebuild and pad > max_pad_fraction:
        full_rebuild, reason = True, "pad-degradation"

    return UpdatePlan(touched=tuple(sorted(touched)),
                      docs_by_cluster=docs_by_cluster,
                      new_docs=new_docs,
                      new_cluster_of=new_cluster_of,
                      full_rebuild=full_rebuild,
                      reason=reason,
                      projected_pad_fraction=pad)
