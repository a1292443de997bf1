"""LiveIndex: streaming corpus mutations over a PirRagSystem (twin of
``repro/update/live.py``).

Mutations accumulate in the journal; `commit()` folds the pending batch into
one published epoch:

    plan      — the planner resolves the batch, accounts column capacity
    repack    — `chunking.rebuild_columns` re-serializes only touched columns
    delta     — `PIRServer.stage_delta` returns ΔH = ΔD[:,J]·A[J,:] through
                the delta-hint kernel, and `ops.add_delta` folds it into the
                hint in ΔH's own buffer; with batch-PIR on, `routing` queues
                the same patch for every bucket that holds a touched column
    publish   — the DB columns are swapped, and the EpochLog gains a
                HintPatch; clients `HintCache.sync()` to patch their cached
                hint instead of re-downloading it

When the planner trips a full-rebuild trigger (an insert overflowing the
m-row budget, or pad_fraction degrading past the threshold after deletes),
the epoch is published as a full-hint patch over a freshly built system.

A sharded system (built with ``mesh=``) patches ΔH shard by shard: each
shard's delta product reads and writes only its own rows, the rows gather
on the client's device, and `ops.add_delta` folds them into the hint once.
Its full rebuild goes back through the sharded build on the same mesh.

Exactness invariant: after any mutation sequence the incrementally patched
hint — server-side AND client-side — is bit-identical to `server.setup()`
on the rebuilt database.  Started from the JAX package's state
(`convert.live_from_state`), a delta epoch gives the same patch, DB bytes
and hint as the JAX package's.  A full rebuild re-runs k-means, whose
kmeans++ draws are the port's own.
"""
from __future__ import annotations

import copy
import dataclasses
import time
import weakref
from typing import Callable

import numpy as np
import torch

from repro_torch._common import u32_to_numpy
from repro_torch.core import chunking, pipeline
from repro_torch.fleet.faults import SITE_COMMIT_FAIL, InjectedCommitFault
from repro_torch.kernels import ops
from repro_torch.obs import DEFAULT_SIZE_BUCKETS, Obs
from repro_torch.update import journal as journal_lib
from repro_torch.update import planner, routing
from repro_torch.update.epochs import EpochLog, HintPatch


@dataclasses.dataclass
class CommitStats:
    epoch: int
    n_mutations: int
    touched_clusters: int
    full_rebuild: bool
    reason: str | None
    seconds: float
    patch_bytes: int
    plan_seconds: float = 0.0      # of seconds: the planner (host)
    repack_seconds: float = 0.0    # of seconds: column re-serialization (host)


@dataclasses.dataclass
class StagedEpoch:
    """One commit's shadow state: computed while the live epoch serves.

    `LiveIndex.stage()` plans the mutation batch, re-packs the touched
    columns and queues ΔH and the patched hint on the device; the serving
    path's pointers are untouched.  `LiveIndex.publish()` then swaps the
    pointers and advances the epoch log.  ``plan_s`` and ``repack_s`` are
    the host seconds of the first two steps (full rebuilds: 0).
    """
    patch: HintPatch
    plan: planner.UpdatePlan
    n_mutations: int
    t0: float
    _apply: Callable[[], None]
    plan_s: float = 0.0
    repack_s: float = 0.0


def _weak_hook(method: Callable) -> Callable:
    """``method`` called through a weak reference to its object; calling it
    after the object is gone raises."""
    ref = weakref.WeakMethod(method)

    def hook(*args, **kwargs):
        bound = ref()
        if bound is None:
            raise RuntimeError("the LiveIndex behind this epoch log is gone")
        return bound(*args, **kwargs)

    return hook


class LiveIndex:
    """A PirRagSystem that accepts insert/delete/replace without downtime."""

    def __init__(self, system: pipeline.PirRagSystem,
                 texts, embeddings, *,
                 doc_ids=None,
                 max_pad_fraction: float = 0.95,
                 compact_every: int | None = None,
                 rebuild_kwargs: dict | None = None):
        if system.assignment is None or system.db.used_bytes is None:
            raise ValueError("LiveIndex needs a built system (assignment "
                             "and per-column used bytes)")
        self.system = system
        self.journal = journal_lib.MutationJournal()
        # compact_every=C chains patches with periodic compaction: a client
        # K epochs behind downloads O(K/C) precomputed segments
        self.epochs = EpochLog(compact_every=compact_every)
        self.max_pad_fraction = max_pad_fraction
        self._rebuild_kwargs = dict(rebuild_kwargs or {})
        # _stage_full supplies the then-current id set itself
        self._rebuild_kwargs.pop("doc_ids", None)
        # a full rebuild runs where the wrapped system runs, with its knobs
        if system.keyed is None:
            self._rebuild_kwargs.setdefault("n_clusters", system.db.n)
        self._rebuild_kwargs.setdefault("device", system.device)
        self._rebuild_kwargs.setdefault("impl", system.cfg.impl)
        self._rebuild_kwargs.setdefault("chunk_size", system.db.chunk_size)
        self._rebuild_kwargs.setdefault("q_switch", system.cfg.params.q_switch)
        if system.mesh is not None:
            # a sharded index rebuilds through the sharded build
            self._rebuild_kwargs.setdefault("mesh", system.mesh)
        self.commits: list[CommitStats] = []
        # Observability handle: a serve loop replaces this with its own via
        # set_obs() so commit spans land in the SAME trace as serve ticks.
        self.obs = Obs(trace=False)
        self.epochs.obs = self.obs
        # Fault-injection hook (an object with ``fire(site)``): `stage`
        # guards the "update.commit.stage" site — an injected failure raises
        # BEFORE any shadow state is computed, so the pending journal batch
        # stays intact and the serving epoch never moves.
        self.faults = None
        # A client that detects a corrupt patch chain recovers by fetching
        # the CURRENT full hint (one deterministic full re-sync).  Bound
        # weakly: the log is this index's own attribute, so a bound method
        # would make a reference cycle that keeps a dropped index's card
        # tensors alive until the cycle collector runs.
        self.epochs.full_fetch = _weak_hook(self._full_patch)

        ids = (np.arange(len(texts)) if doc_ids is None
               else np.asarray(doc_ids))
        embs = np.asarray(embeddings, np.float32)
        self._docs = {int(i): (texts[p], embs[p])
                      for p, i in enumerate(ids)}
        self._cluster_of = {int(i): int(system.assignment[p])
                            for p, i in enumerate(ids)}
        self._used = {j: int(system.db.used_bytes[j])
                      for j in range(system.db.n)}

    # -- construction --------------------------------------------------------

    @classmethod
    def build(cls, texts, embeddings, *, n_clusters: int,
              max_pad_fraction: float = 0.95, doc_ids=None,
              compact_every: int | None = None,
              **build_kwargs) -> "LiveIndex":
        """Offline-build a PirRagSystem and wrap it as a live index.

        texts: N byte strings; embeddings: (N, d) f32; extra kwargs
        (``device=`` and ``mesh=`` among them) forward to
        `PirRagSystem.build` AND are replayed on every full rebuild.
        ``compact_every=C`` enables periodic hint-patch compaction in the
        epoch log.
        """
        system = pipeline.PirRagSystem.build(
            texts, embeddings, n_clusters=n_clusters, doc_ids=doc_ids,
            **build_kwargs)
        return cls(system, texts, embeddings, doc_ids=doc_ids,
                   max_pad_fraction=max_pad_fraction,
                   compact_every=compact_every,
                   rebuild_kwargs=dict(n_clusters=n_clusters, **build_kwargs))

    @classmethod
    def build_keyed(cls, table, *, max_pad_fraction: float = 0.95,
                    compact_every: int | None = None,
                    **build_kwargs) -> "LiveIndex":
        """Offline-build a KEYED system (embedding table) as a live index.

        table: (V, d) f32; extra kwargs (``device=`` among them) forward to
        `PirRagSystem.build_keyed` and are replayed on full rebuilds.  Row i
        is doc i in its id-derived group, so `replace_row` streams fresh
        rows through the delta-epoch path (a keyed record has a fixed width,
        so a replace never overflows a column).  Keyed mutations are
        REPLACE-only: the client's stride arithmetic needs the dense id
        space 0..V-1.
        """
        table = np.ascontiguousarray(table, np.float32)
        system = pipeline.PirRagSystem.build_keyed(table, **build_kwargs)
        layout = system.keyed
        texts = [layout.row_text(table[i]) for i in range(layout.n_rows)]
        return cls(system, texts, table, max_pad_fraction=max_pad_fraction,
                   compact_every=compact_every,
                   rebuild_kwargs=dict(build_kwargs))

    def clone(self) -> "LiveIndex":
        """An independent copy that serves and commits on its own: every
        tensor and the host DB mirror copied, the epoch log's full-fetch hook
        bound to the copy.  The per-doc maps are copied shallowly: a commit
        replaces them, never the (text, embedding) entries in them."""
        memo = {id(self._docs): dict(self._docs),
                id(self._cluster_of): dict(self._cluster_of)}
        twin = copy.deepcopy(self, memo)
        twin.epochs.full_fetch = _weak_hook(twin._full_patch)
        return twin

    def set_obs(self, obs: Obs) -> None:
        """Adopt `obs` (a serve loop's handle) for commit/compaction events."""
        self.obs = obs
        self.epochs.obs = obs

    # -- introspection -------------------------------------------------------

    @property
    def epoch(self) -> int:
        """The published epoch number (0 before any commit)."""
        return self.epochs.epoch

    def doc_ids(self) -> list[int]:
        """Sorted external doc ids of the published epoch."""
        return sorted(self._docs)

    # -- mutation intake -----------------------------------------------------

    def insert(self, doc_id: int, text: bytes, emb: np.ndarray):
        """Journal an insert (emb: (d,) f32); visible at the next commit."""
        self.journal.append(journal_lib.insert(doc_id, text, emb))

    def delete(self, doc_id: int):
        """Journal a delete; visible at the next commit."""
        self.journal.append(journal_lib.delete(doc_id))

    def replace(self, doc_id: int, text: bytes, emb: np.ndarray):
        """Journal a replace (emb: (d,) f32); visible at the next commit."""
        self.journal.append(journal_lib.replace(doc_id, text, emb))

    def replace_row(self, row_id: int, row: np.ndarray):
        """Journal a KEYED row replace; the record payload is the row itself
        (`KeyedLayout.row_text`), so it stays in its id-derived group and
        the next commit ships it as an ordinary delta epoch."""
        layout = self.system.keyed
        if layout is None:
            raise ValueError("replace_row needs a keyed (build_keyed) index")
        row = np.asarray(row, np.float32)
        self.journal.append(journal_lib.replace(
            row_id, layout.row_text(row), row))

    # -- commit --------------------------------------------------------------

    def commit(self, *, donate: bool = False) -> HintPatch | None:
        """Fold all pending mutations into one published epoch.

        Equivalent to ``publish(stage())``.  ``donate=True`` writes the new
        columns into the live DB tensor at publish instead of copying it.
        """
        staged = self.stage(donate=donate)
        return self.publish(staged) if staged is not None else None

    def stage(self, *, donate: bool = False) -> StagedEpoch | None:
        """Compute one commit's shadow state without publishing it.

        Device work is queued against fresh buffers (a donating column
        write is deferred to `publish`); nothing the serving path reads has
        moved when this returns.  Returns None when no mutations are
        pending.
        """
        muts = self.journal.pending()
        if not muts:
            return None
        if self.faults is not None and self.faults.fire(SITE_COMMIT_FAIL):
            raise InjectedCommitFault(
                f"injected stage failure at epoch {self.epochs.epoch} "
                f"({len(muts)} pending mutations, batch retryable)")
        t0 = time.perf_counter()
        db = self.system.db
        keyed = self.system.keyed
        if keyed is not None:
            # The client decodes by id arithmetic over a dense 0..V-1 space,
            # so inserts and deletes would punch holes in it; replaced rows
            # stay in their id-derived group, not the nearest centroid's.
            for mut in muts:
                if mut.kind != journal_lib.REPLACE:
                    raise ValueError(
                        f"keyed index supports replace only, got {mut.kind} "
                        f"for doc {mut.doc_id}")
        assign_fn = (None if keyed is None
                     else (lambda i, e: keyed.group_of(i)))
        with self.obs.span("commit.stage", mutations=len(muts)) as sp:
            plan = planner.plan_updates(
                muts, docs=self._docs, cluster_of=self._cluster_of,
                centroids=self.system.centroids, m=db.m,
                used_bytes=self._used, n_clusters=db.n, emb_dim=db.emb_dim,
                max_pad_fraction=self.max_pad_fraction, assign_fn=assign_fn)
            plan_s = time.perf_counter() - t0
            sp.set(kind="full" if plan.full_rebuild else "delta",
                   touched=len(plan.touched))
            repack_s = 0.0
            if plan.full_rebuild:
                with self.obs.span("commit.rebuild", docs=len(plan.new_docs)):
                    patch, apply = self._stage_full(plan)
            else:
                patch, apply, repack_s = self._stage_delta(plan,
                                                           donate=donate)
        return StagedEpoch(patch=patch, plan=plan, n_mutations=len(muts),
                           t0=t0, _apply=apply, plan_s=plan_s,
                           repack_s=repack_s)

    def publish(self, staged: StagedEpoch) -> HintPatch:
        """Swap the staged pointers and advance the epoch: the swap instant.

        Queries planned before this call keep decoding against their
        snapshot of the old epoch; queries planned after it are formed —
        and admitted — at the new one.
        """
        plan, patch = staged.plan, staged.patch
        with self.obs.span("commit.publish",
                           kind="full" if plan.full_rebuild else "delta",
                           epoch=self.epochs.epoch + 1):
            staged._apply()
            self.epochs.publish(patch)
        self.journal.mark_committed(self.epochs.epoch)
        self._docs = plan.new_docs
        self._cluster_of = plan.new_cluster_of
        self.obs.counter("commit.epochs").inc()
        self.obs.counter("commit.mutations").inc(staged.n_mutations)
        if plan.full_rebuild:
            self.obs.counter("commit.full_rebuilds").inc()
        self.obs.histogram("commit.patch_bytes",
                           bounds=DEFAULT_SIZE_BUCKETS).record(
                               patch.wire_bytes)
        self.commits.append(CommitStats(
            epoch=self.epochs.epoch, n_mutations=staged.n_mutations,
            touched_clusters=len(plan.touched),
            full_rebuild=plan.full_rebuild, reason=plan.reason,
            seconds=time.perf_counter() - staged.t0,
            patch_bytes=patch.wire_bytes, plan_seconds=staged.plan_s,
            repack_seconds=staged.repack_s))
        return patch

    def _stage_delta(self, plan: planner.UpdatePlan, *, donate: bool
                     ) -> tuple[HintPatch, Callable[[], None], float]:
        db, system = self.system.db, self.system
        server = system.server
        t0 = time.perf_counter()
        cols, new_cols, used = chunking.rebuild_columns(
            db.m, plan.docs_by_cluster)
        repack_s = time.perf_counter() - t0

        # Row truncation for the patch: beyond the max used length of the
        # old and new touched columns both sides are zero padding, so ΔD
        # there is identically zero and need not travel.
        old_used = max(self._used[int(j)] for j in cols)
        r = max(old_used, max(used.values()))
        cols_t = torch.from_numpy(cols).to(server.device)
        old_rows = server.columns(cols_t, r)
        delta = (new_cols[:r].astype(np.int16)
                 - old_rows.astype(np.int16))           # entries ∈ [−255, 255]

        new_t = torch.from_numpy(new_cols).to(server.device)
        delta_h = server.stage_delta(cols_t, new_t)
        # The donating column write is DEFERRED to publish(): a failure
        # later in this stage, or a caller dropping the StagedEpoch
        # unpublished, must leave server.db serving the old epoch.
        new_db = None if donate else server.stage_scatter(cols_t, new_t)
        # ΔH is transient, so the add writes into ITS buffer; the old hint
        # survives for in-flight decodes.
        new_hint = ops.add_delta(system.hint, delta_h, impl=system.cfg.impl)
        # Batch-PIR replicas (if enabled) take the same exact delta, routed
        # to each touched cluster's owning buckets.
        staged_batch = routing.stage_batch_hints(system, cols, new_t,
                                                 used, donate=donate)

        def apply():
            server.db = (server.stage_scatter(cols_t, new_t, donate=True)
                         if donate else new_db)
            system.hint = new_hint
            if staged_batch is not None:
                staged_batch.publish()
            # Mirror the host-side ChunkedDB view, patched in place: copying
            # the full (m, n) matrix per commit would make host cost O(DB).
            db.matrix[:, cols] = new_cols
            for j in cols:
                db.cluster_sizes[j] = len(plan.docs_by_cluster[int(j)])
                self._used[int(j)] = used[int(j)]
                db.used_bytes[j] = used[int(j)]
            system.db = dataclasses.replace(
                db, n_docs=len(plan.new_docs),
                pad_fraction=1.0 - sum(self._used.values())
                / float(db.m * db.n))

        return HintPatch(from_epoch=self.epochs.epoch,
                         to_epoch=self.epochs.epoch + 1,
                         cols=np.asarray(cols), delta=delta), apply, repack_s

    def _stage_full(self, plan: planner.UpdatePlan
                    ) -> tuple[HintPatch, Callable[[], None]]:
        """Overflow / pad-degradation: re-cluster, re-pack, re-hint.

        The rebuilt system is a fresh object graph, so the whole build runs
        while the old system keeps serving; publish is one pointer swap.
        """
        ids = sorted(plan.new_docs)
        texts = [plan.new_docs[i][0] for i in ids]
        embs = np.stack([plan.new_docs[i][1] for i in ids])
        if self.system.keyed is not None:
            # Keyed rebuild: the id space is dense (replace-only), so the
            # doc set IS the table; same layout and bucket knobs.
            if ids != list(range(len(ids))):
                raise ValueError("keyed id space is not dense")
            lay, bp = self.system.keyed, self.system.batch
            kw = {k: v for k, v in self._rebuild_kwargs.items()
                  if k not in ("group_size", "kappa", "n_buckets",
                               "batch_seed")}
            new_system = pipeline.PirRagSystem.build_keyed(
                embs, group_size=lay.group_size, kappa=bp.kappa,
                n_buckets=bp.partition.n_buckets, batch_seed=bp.seed, **kw)
        else:
            new_system = pipeline.PirRagSystem.build(
                texts, embs, doc_ids=ids, **self._rebuild_kwargs)
            routing.rebuild_batch(self.system, new_system)
        # Rebuild re-clusters, so the plan's incremental cluster map is stale.
        plan.new_cluster_of.clear()
        plan.new_cluster_of.update(
            {i: int(new_system.assignment[p]) for p, i in enumerate(ids)})

        def apply():
            self.system = new_system
            self._used = {j: int(new_system.db.used_bytes[j])
                          for j in range(new_system.db.n)}

        return HintPatch(from_epoch=self.epochs.epoch,
                         to_epoch=self.epochs.epoch + 1,
                         full_hint=u32_to_numpy(new_system.hint),
                         cfg=new_system.cfg), apply

    def _full_patch(self, from_epoch: int) -> HintPatch:
        """A sealed full-hint patch `from_epoch` → head (corrupt-chain
        fallback: costs `cfg.hint_bytes`, same as bootstrap)."""
        return HintPatch(from_epoch=from_epoch, to_epoch=self.epochs.epoch,
                         full_hint=u32_to_numpy(self.system.hint),
                         cfg=self.system.cfg).sealed()

    # -- epoch-checked queries ----------------------------------------------

    def check_epoch(self, epoch: int):
        """Raise StaleEpochError unless `epoch` is the published head."""
        self.epochs.check_fresh(epoch)

    def query(self, query_emb: np.ndarray, *, epoch: int, **kwargs):
        """Epoch-checked private query (kwargs forwarded to the system).

        A query formed against a stale cached hint would decode garbage, so
        the server rejects it up front; the client syncs its HintCache and
        retries.
        """
        self.check_epoch(epoch)
        return self.system.query(query_emb, **kwargs)

    def query_batch(self, query_embs: np.ndarray, *, epoch: int, **kwargs):
        """Epoch-checked batched query ((B, d) f32; kwargs to the system)."""
        self.check_epoch(epoch)
        return self.system.query_batch(query_embs, **kwargs)

    def lookup(self, ids, *, epoch: int, **kwargs):
        """Epoch-checked keyed row lookup (kwargs to `PirRagSystem.lookup`)."""
        self.check_epoch(epoch)
        return self.system.lookup(ids, **kwargs)

    def lookup_batch(self, ids_batch, *, epoch: int, **kwargs):
        """Epoch-checked batched keyed lookup (kwargs to the system)."""
        self.check_epoch(epoch)
        return self.system.lookup_batch(ids_batch, **kwargs)
