"""PIR-RAG end-to-end system on one device (twin of ``repro/core/pipeline.py``).

Offline (server): K-means → chunk-transposed DB → PIR hint.
Online (client): pick cluster from PUBLIC centroids → LWE-encrypted one-hot
→ server modular GEMV → decrypt whole cluster → local exact re-rank.

The server never sees the query embedding, the chosen cluster, or the ranked
results.  Two server shapes: the legacy path (one one-hot per probe, one
GEMM over the whole DB) and, after `enable_batch()`, batch-PIR (cuckoo
buckets, one bucketed pass for all probes); `build_keyed` serves embedding
rows by id through batch-PIR.  ``mesh=`` (a `launch.mesh.DeviceMesh`)
shards the whole build and the server over the mesh's devices: k-means
with the corpus row-sharded, per-shard packing placed straight on each
device, per-shard hint rows, answers and patches, buckets spread over the
shards; every output is bitwise the unsharded build's.

A serving batch (`query_batch_async`, `lookup_batch_async`) queues its
encryption, the answer, the decode and the decoded bytes' copy to the host
on the device stream without waiting on it; the client's centroid ranking,
which needs its result on the host, runs on a stream of its own.  So a
pipelined engine's plan never waits for the products of batches already in
flight.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch._common import resolve_device, sync, to_device, to_host_async
from repro_torch.core import chunking, clustering, pir, rerank, threefry


@dataclasses.dataclass
class InflightBatch:
    """A dispatched serving batch: answer, decode and the decoded bytes'
    host copy enqueued on the device.

    ``event`` is recorded on the stream when the batch is built, at the end
    of its dispatch; `wait()` blocks on it alone, not on batches queued
    after it.  `complete()` waits, then parses and re-ranks the host bytes
    and returns exactly what `query_batch` would have.
    """
    _complete: Callable[[], list]
    pending: tuple = ()            # device tensors the dispatch produced
    done: bool = False
    event: torch.cuda.Event | None = None

    def __post_init__(self):
        dev = next((t.device for t in self.pending
                    if isinstance(t, torch.Tensor) and t.is_cuda), None)
        if dev is not None and self.event is None:
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(dev))

    def wait(self) -> None:
        """Block until this batch's device work (and host copy) is done."""
        if self.event is not None:
            self.event.synchronize()

    def complete(self) -> list:
        """Wait for this batch, then parse + re-rank; same return value as
        `query_batch`."""
        if self.done:
            raise RuntimeError("InflightBatch.complete() called twice")
        self.wait()
        out = self._complete()
        self.done = True
        return out


def _client_stream(device: torch.device):
    """Context running the client's centroid ranking on a stream of torch's
    pool, not the serving stream (on the card; nothing on the CPU).  The
    ranking reads only the queries and the public centroids, both host
    arrays uploaded inside it, so it needs no ordering against the serving
    stream, and its copy back waits for it alone.  (Waiting on the serving
    stream instead would make that copy wait for every batch in flight.)
    `_cluster_order` asserts that the centroids are a host array: a card
    tensor written on the serving stream would need an event here."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.stream(torch.cuda.Stream(device))


# Independent fold_in streams off the ONE public build seed (see the twin).
_STREAM_KMEANS = 0
_STREAM_LWE = 1


def _derive_build_streams(seed: int) -> tuple[threefry.Key, int]:
    """(kmeans key, a_seed) — bitwise the JAX package's two build streams."""
    root = threefry.PRNGKey(seed)
    k_km = threefry.fold_in(root, _STREAM_KMEANS)
    a_seed = threefry.randint(threefry.fold_in(root, _STREAM_LWE), (), 0,
                              (1 << 31) - 1)
    return k_km, a_seed


def mesh_device(mesh, device: str | torch.device | None) -> torch.device:
    """The client's device of a build: ``device`` (`resolve_device`)
    without a mesh; with one, the mesh's home device, which ``device`` may
    name but not contradict."""
    if mesh is None:
        return resolve_device(device)
    home = mesh.home
    if device is not None:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev != home:
            raise ValueError(f"device {dev} is not the mesh's home device "
                             f"{home}")
    return home


def _fresh_client_generator(device: torch.device) -> torch.Generator:
    """Client-side randomness: one OS-entropy seed, never the build seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(os.urandom(8), "little"))
    return gen


@dataclasses.dataclass
class QueryStats:
    uplink_bytes: int
    downlink_bytes: int
    client_ms: float
    server_ms: float
    cluster_index: int            # known to client only
    mode: str = "legacy"          # "legacy" (P one-hots) | "batch" (cuckoo)
    probes: int = 1               # clusters privately fetched
    n_buckets: int = 0            # batch mode: bucket queries (incl dummies)
    hint_bytes: int = 0           # one-time hint downlink of the path used


@dataclasses.dataclass
class LookupStats:
    """Accounting for one keyed embedding lookup (`PirRagSystem.lookup`)."""
    uplink_bytes: int
    downlink_bytes: int
    client_ms: float
    server_ms: float
    kappa: int                    # rows requested (multiset size)
    groups: int                   # distinct id groups privately fetched
    mode: str = "batch"           # "batch" (cuckoo) | "legacy" (G one-hots)
    n_buckets: int = 0            # batch mode: bucket queries (incl dummies)
    hint_bytes: int = 0           # one-time hint downlink of the path used


@dataclasses.dataclass
class PirRagSystem:
    """Bundles server-public state (centroids) and the two protocol roles."""
    centroids: np.ndarray         # PUBLIC: (n_clusters, d) f32
    db: chunking.ChunkedDB
    cfg: pir.PIRConfig
    server: pir.PIRServer
    hint: torch.Tensor            # client-side after one-time download
    setup_seconds: float          # total offline time
    index_seconds: float = 0.0    # clustering + packing (no crypto)
    kmeans_seconds: float = 0.0   # of index_seconds: k-means
    pack_seconds: float = 0.0     # of index_seconds: chunk-transposed packing
    hint_seconds: float = 0.0     # hint GEMM
    assignment: np.ndarray | None = None  # (N,) doc→cluster
    batch: object | None = None           # batchpir.BatchPIR once enabled
    keyed: object | None = None           # batchpir.KeyedLayout (keyed system)
    mesh: object | None = None            # launch.mesh.DeviceMesh (sharded)
    _qgen: torch.Generator | None = None  # client stream for keyless queries

    @property
    def device(self) -> torch.device:
        return self.server.device

    # -- offline ------------------------------------------------------------

    @classmethod
    def build(cls, texts: Sequence[bytes], embeddings: np.ndarray, *,
              n_clusters: int, kmeans_iters: int = 25, chunk_size: int = 256,
              balance_factor: float | None = None, seed: int = 0,
              impl: str = "auto", q_switch: int | None = 1 << 16,
              doc_ids: Sequence[int] | None = None,
              device: str | torch.device | None = None,
              mesh=None) -> "PirRagSystem":
        """Offline setup: K-means → chunk-transposed DB → PIR hint.

        ``seed`` feeds two independent streams: cluster seeding and the
        public LWE matrix seed (`cfg.a_seed`, bitwise the JAX package's).
        ``doc_ids`` (default 0..N−1) keeps external document ids, as a
        live index's full rebuild needs.  Runs on ``device`` (default
        ``cuda``; raises without a card).

        ``mesh=`` shards the whole build over the mesh (see `mesh_device`
        for ``device``): k-means with the corpus row-sharded
        (`clustering.kmeans_fit_sharded`), the balanced-assign distances per
        shard, packing into per-shard row slices placed straight on their
        devices, per-shard hint rows gathered once on the client's device.
        K-means reduces over ``clustering.build_blocks(shards)`` canonical
        blocks, so with S dividing BUILD_BLOCKS every output equals the
        unsharded build's bitwise.
        """
        dev = mesh_device(mesh, device)
        blocks = clustering.build_blocks(
            1 if mesh is None else len(mesh.devices))
        t0 = time.perf_counter()
        k_km, a_seed = _derive_build_streams(seed)
        gen = threefry.torch_generator(k_km, dev)
        embf = np.asarray(embeddings, np.float32)
        if mesh is None:
            x = torch.from_numpy(embf).to(dev)
            km = clustering.kmeans_fit(gen, x, k=n_clusters,
                                       iters=kmeans_iters, n_blocks=blocks,
                                       impl=impl)
        else:
            x = embf
            km = clustering.kmeans_fit_sharded(
                gen, embf, k=n_clusters, iters=kmeans_iters, mesh=mesh,
                impl=impl)
        cents = km.centroids.cpu().numpy()
        kmeans_s = time.perf_counter() - t0
        if balance_factor is not None:
            cap = int(np.ceil(len(texts) / n_clusters * balance_factor))
            d2 = clustering.blocked_sqdist(x, km.centroids, n_blocks=blocks,
                                           mesh=mesh)
            assign = clustering.balanced_assign(embf, cents, cap,
                                                d2=d2.cpu().numpy())
        else:
            assign = km.assignment.cpu().numpy()
        system = cls._from_parts(texts, embf, cents, assign, n_clusters,
                                 a_seed=a_seed, chunk_size=chunk_size,
                                 q_switch=q_switch, impl=impl, device=dev,
                                 t0=t0, doc_ids=doc_ids, mesh=mesh)
        system.kmeans_seconds = kmeans_s
        return system

    @classmethod
    def _from_parts(cls, texts, embf: np.ndarray, cents: np.ndarray,
                    assign: np.ndarray, n_clusters: int, *, a_seed: int,
                    chunk_size: int, q_switch: int | None, impl: str,
                    device: torch.device, t0: float,
                    doc_ids: Sequence[int] | None = None,
                    mesh=None) -> "PirRagSystem":
        """Pack, upload and hint a clustered corpus (build's second half);
        with ``mesh=``, packed into row shards placed shard by shard."""
        shards = 1 if mesh is None else len(mesh.devices)
        t_pack = time.perf_counter()
        db = chunking.build_chunked_db(texts, embf, assign, n_clusters,
                                       chunk_size, doc_ids=doc_ids,
                                       n_row_shards=shards)
        pack_s = time.perf_counter() - t_pack
        cfg = pir.make_config(db.m, db.n, impl=impl, q_switch=q_switch,
                              a_seed=a_seed)
        if mesh is None:
            server = pir.PIRServer(cfg,
                                   torch.from_numpy(db.matrix).to(device))
        else:
            server = pir.PIRServer(
                cfg, db.row_shards if db.row_shards is not None
                else db.matrix, mesh=mesh)
        sync(device)
        t_index = time.perf_counter()
        hint = server.setup()
        sync(device)
        t_end = time.perf_counter()
        return cls(centroids=np.asarray(cents, np.float32), db=db, cfg=cfg,
                   server=server, hint=hint, setup_seconds=t_end - t0,
                   index_seconds=t_index - t0, pack_seconds=pack_s,
                   hint_seconds=t_end - t_index, assignment=assign,
                   mesh=mesh,
                   _qgen=_fresh_client_generator(device))

    @classmethod
    def build_keyed(cls, table: np.ndarray, *, group_size: int | None = None,
                    kappa: int = 8, n_buckets: int | None = None,
                    chunk_size: int = 256, seed: int = 0,
                    batch_seed: int = 101, impl: str = "auto",
                    q_switch: int | None = 1 << 16,
                    device: str | torch.device | None = None,
                    mesh=None) -> "PirRagSystem":
        """Offline setup for KEYED serving: a private embedding-table index.

        table: (V, d) f32 rows.  There is no k-means: row i lands in group
        ``i // group_size`` (`batchpir.KeyedLayout`, default ≈ √V), each
        group packs into one chunk-transposed column with the row's raw f32
        bytes as the record payload, and batch-PIR is enabled at once.
        `lookup` then recovers rows bit-identical to ``table[ids]``.
        ``centroids`` are the per-group row means, so the legacy `query`
        stays well formed.  ``seed`` gives ``a_seed`` as in `build`.  Runs
        on ``device`` (default ``cuda``; raises without a card); ``mesh=``
        row-shards the flat DB and spreads the buckets as in `build`.
        """
        from repro_torch import batchpir
        dev = mesh_device(mesh, device)
        t0 = time.perf_counter()
        table = np.ascontiguousarray(table, np.float32)
        layout = batchpir.KeyedLayout.build(table.shape[0], table.shape[1],
                                            group_size)
        _, a_seed = _derive_build_streams(seed)
        assign = np.arange(layout.n_rows, dtype=np.int64) // layout.group_size
        texts = [layout.row_text(table[i]) for i in range(layout.n_rows)]
        sums = np.zeros((layout.n_groups, layout.dim), np.float64)
        np.add.at(sums, assign, table)
        cnts = np.bincount(assign, minlength=layout.n_groups)[:, None]
        cents = (sums / np.maximum(cnts, 1)).astype(np.float32)
        system = cls._from_parts(texts, table, cents, assign, layout.n_groups,
                                 a_seed=a_seed, chunk_size=chunk_size,
                                 q_switch=q_switch, impl=impl, device=dev,
                                 t0=t0, mesh=mesh)
        system.keyed = layout
        system.enable_batch(kappa=kappa, n_buckets=n_buckets, seed=batch_seed)
        system.setup_seconds += system.batch.setup_seconds
        return system

    # -- batch-PIR (multi-probe amortization) --------------------------------

    def enable_batch(self, *, kappa: int = 8, n_buckets: int | None = None,
                     seed: int = 101):
        """Bucketize the DB for batch-PIR; multi_probe > 1 then routes there.

        The sub-DBs are gathered on the device from the served DB, and every
        bucket hint is computed there.  A sharded system spreads the buckets
        over its mesh, each sub-DB gathered from the host mirror straight
        onto the shard that owns it.  Returns the `batchpir.BatchPIR`.
        """
        from repro_torch import batchpir
        matrix = (self.server.db if self.mesh is None
                  else torch.from_numpy(self.db.matrix))
        self.batch = batchpir.build(
            matrix, self.db.used_bytes, self.cfg.params,
            kappa=kappa, n_buckets=n_buckets, seed=seed,
            a_seed=self.cfg.a_seed, impl=self.cfg.impl, mesh=self.mesh)
        return self.batch

    # -- keyed lookups (recsys serving) --------------------------------------

    def _require_keyed(self):
        if self.keyed is None or self.batch is None:
            raise ValueError("keyed lookups need a build_keyed() system")
        return self.keyed, self.batch

    def lookup(self, ids, *, generator: torch.Generator | None = None
               ) -> tuple[np.ndarray, LookupStats]:
        """Privately fetch embedding rows ``ids`` → ((κ, d) f32, accounting).

        ``ids`` is a multiset; rows come back in caller order, bit-identical
        to ``table[ids]``.  The server sees B pseudorandom bucket
        ciphertexts and streams its bucketed DB once whatever κ is.  A
        structurally unplaceable distinct-group set falls back to the legacy
        path: one flat-PIR one-hot per distinct group.
        """
        from repro_torch.batchpir import PlacementError
        layout, bp = self._require_keyed()
        gen = self._generator(generator)
        t0 = time.perf_counter()
        try:
            qs, state = bp.client.query_rows(gen, layout, ids)
        except PlacementError:
            return self._lookup_legacy(ids, gen, t0)
        sync(self.device)
        t1 = time.perf_counter()
        ans = bp.server.answer_batch(qs)
        sync(self.device)
        t2 = time.perf_counter()
        rows = bp.client.recover_rows(ans, state)
        t3 = time.perf_counter()
        acc = bp.client.accounting(state.base)
        stats = LookupStats(
            uplink_bytes=acc.uplink_bytes, downlink_bytes=acc.downlink_bytes,
            client_ms=1e3 * ((t1 - t0) + (t3 - t2)),
            server_ms=1e3 * (t2 - t1), kappa=len(state.ids),
            groups=len(state.base.placement), mode="batch",
            n_buckets=acc.n_buckets, hint_bytes=acc.hint_bytes)
        return rows, stats

    def _lookup_legacy(self, ids, gen: torch.Generator, t0: float
                       ) -> tuple[np.ndarray, LookupStats]:
        """Flat-PIR fallback: one one-hot query per DISTINCT id group."""
        layout = self.keyed
        ids = [int(i) for i in ids]
        groups = layout.groups_of(ids)
        client = pir.PIRClient(self.cfg, self.hint,
                               a_mat=self.server.a_matrix)
        cols = np.zeros((self.cfg.m, 0), np.uint8)
        t1 = t2 = time.perf_counter()
        if groups:
            qs, secrets = client.query_batch(gen, groups)
            sync(self.device)
            t1 = time.perf_counter()
            ans = self.server.answer(qs)
            sync(self.device)
            t2 = time.perf_counter()
            cols = client.recover_batch(ans, secrets).cpu().numpy()
        by_group = {g: cols[:, j] for j, g in enumerate(groups)}
        rows = [layout.decode_row(by_group[layout.group_of(i)], i)
                for i in ids]
        out = (np.stack(rows) if rows
               else np.zeros((0, layout.dim), np.float32))
        t3 = time.perf_counter()
        g = len(groups)
        stats = LookupStats(
            uplink_bytes=g * self.cfg.uplink_bytes,
            downlink_bytes=g * self.cfg.downlink_bytes,
            client_ms=1e3 * ((t1 - t0) + (t3 - t2)),
            server_ms=1e3 * (t2 - t1), kappa=len(ids), groups=g,
            mode="legacy", hint_bytes=self.cfg.hint_bytes)
        return out, stats

    def lookup_batch(self, ids_batch, *,
                     generator: torch.Generator | None = None
                     ) -> list[np.ndarray]:
        """Batched keyed serving: C clients' bucket queries, one bucketed
        pass.  Returns one (κ_i, d) f32 array per client, bit-identical to
        ``table[ids_i]``."""
        return self.lookup_batch_async(ids_batch,
                                       generator=generator).complete()

    def lookup_batch_async(self, ids_batch, *,
                           generator: torch.Generator | None = None
                           ) -> InflightBatch:
        """Plan + dispatch a keyed serving batch; row extraction deferred.

        Per-client placement failures fall back to that client's legacy
        lookup, drawn at its place in the client order; everyone else
        shares one A_b·S_b, the bucketed product and one H_b·S_b per bucket.
        The decode is queued here, against the hints of this batch's epoch,
        so a later commit cannot reach it.
        """
        from repro_torch.batchpir import PlacementError
        from repro_torch.batchpir.client import KeyedQueryState
        layout, bp = self._require_keyed()
        gen = self._generator(generator)
        draws, wanted, live, fallback = [], [], [], {}
        for i, ids in enumerate(ids_batch):
            try:
                drawn, ids_i = bp.client.draw_rows(gen, layout, ids)
            except PlacementError:
                # drawn here, at its place in the client order
                fallback[i] = self._lookup_legacy(ids, gen,
                                                  time.perf_counter())[0]
                continue
            draws.append(drawn)
            wanted.append(ids_i)
            live.append(i)
        answers, states, decoded = self._stacked_pass(bp, draws)

        def complete():
            out: list[np.ndarray | None] = [None] * len(ids_batch)
            if decoded is not None:
                for i, ids_i, st, cols in zip(live, wanted, states,
                                              decoded.columns()):
                    out[i] = bp.client.rows(cols, KeyedQueryState(
                        ids=ids_i, layout=layout, base=st))
            for i, rows in fallback.items():
                out[i] = rows
            return out

        return InflightBatch(_complete=complete, pending=tuple(answers))

    @staticmethod
    def _stacked_pass(bp, draws: list):
        """Queue one batch-PIR pass for C drawn clients: one A_b·S_b per
        bucket, the bucketed answer, one H_b·S_b per bucket and the host
        copy of the decoded columns → (per-bucket answers (m_b, C), the
        clients' states, `batchpir.DecodedBatch`); ([], [], None) for no
        clients."""
        if not draws:
            return [], [], None
        qs, states = bp.client.encrypt(draws)
        answers = bp.server.answer_batch(qs)
        return answers, states, bp.client.decode(answers, states)

    # -- online -------------------------------------------------------------

    def _generator(self, generator: torch.Generator | None
                   ) -> torch.Generator:
        if generator is not None:
            return generator
        if self._qgen is None:
            self._qgen = _fresh_client_generator(self.device)
        return self._qgen

    def _cluster_order(self, query_embs: np.ndarray, probes: int
                       ) -> np.ndarray:
        """(B, P) nearest public centroids per query (client-side)."""
        assert isinstance(self.centroids, np.ndarray), \
            "the client stream reads centroids uploaded from the host"
        with _client_stream(self.device):
            d2 = clustering.pairwise_sqdist(
                to_device(np.asarray(query_embs, np.float32), self.device),
                to_device(self.centroids, self.device)).cpu().numpy()
        return np.argsort(d2, axis=1)[:, :probes]

    def query(self, query_emb: np.ndarray, *, top_k: int = 10,
              multi_probe: int = 1, generator: torch.Generator | None = None,
              mode: str = "auto"
              ) -> tuple[list[tuple[int, float, bytes]], QueryStats]:
        """One fully private retrieval; returns top-k docs + accounting.

        multi_probe=P privately fetches the P nearest clusters.  Two server
        shapes:

          legacy — P one-hot queries into ONE GEMM over the full DB: server
                   work and uplink/downlink scale P×.
          batch  — with `enable_batch()`: cuckoo-place the P clusters into
                   buckets and send one (real or dummy) query per bucket;
                   the server streams its bucketed DB once whatever P is.

        mode="auto" routes multi_probe > 1 through batch-PIR when enabled,
        falling back to legacy on a placement failure; "legacy"/"batch"
        force a path.  LWE secrets and errors come from ``generator``
        (default: the system's OS-seeded client stream).
        """
        if mode not in ("auto", "legacy", "batch"):
            raise ValueError(f"unknown query mode {mode!r}")
        gen = self._generator(generator)
        t0 = time.perf_counter()
        order = self._cluster_order(np.asarray(query_emb)[None, :],
                                    max(1, multi_probe))[0]
        use_batch = self.batch is not None and (
            mode == "batch" or (mode == "auto" and len(order) > 1))
        if use_batch:
            from repro_torch.batchpir import PlacementError
            try:
                return self._query_via_batch(query_emb, order, top_k, gen, t0)
            except PlacementError:
                if mode == "batch":
                    raise
        elif mode == "batch":
            raise ValueError("enable_batch() before mode='batch' queries")
        client = pir.PIRClient(self.cfg, self.hint,
                               a_mat=self.server.a_matrix)
        qs, secrets = client.query_batch(gen, [int(c) for c in order])
        sync(self.device)
        t1 = time.perf_counter()

        ans = self.server.answer(qs)
        sync(self.device)
        t2 = time.perf_counter()

        cols = client.recover_batch(ans, secrets).cpu().numpy()
        top = rerank.rerank_columns(
            np.asarray(query_emb, np.float32),
            [chunking.parse_column(cols[:, j], self.db.emb_dim)
             for j in range(len(order))], top_k)
        t3 = time.perf_counter()

        p = len(order)
        stats = QueryStats(
            uplink_bytes=p * self.cfg.uplink_bytes,
            downlink_bytes=p * self.cfg.downlink_bytes,
            client_ms=1e3 * ((t1 - t0) + (t3 - t2)),
            server_ms=1e3 * (t2 - t1),
            cluster_index=int(order[0]),
            mode="legacy", probes=p, hint_bytes=self.cfg.hint_bytes)
        return top, stats

    def _query_via_batch(self, query_emb: np.ndarray, order: np.ndarray,
                         top_k: int, gen: torch.Generator, t0: float
                         ) -> tuple[list, QueryStats]:
        """Batch-PIR leg of `query`: one bucketed pass for all probes."""
        bp = self.batch
        qs, state = bp.client.query(gen, [int(c) for c in order])
        sync(self.device)
        t1 = time.perf_counter()
        ans = bp.server.answer_batch(qs)
        sync(self.device)
        t2 = time.perf_counter()
        cols = bp.client.recover(ans, state)
        top = rerank.rerank_columns(
            np.asarray(query_emb, np.float32),
            [chunking.parse_column(cols[int(c)], self.db.emb_dim)
             for c in order], top_k)
        t3 = time.perf_counter()
        acc = bp.client.accounting(state)
        stats = QueryStats(
            uplink_bytes=acc.uplink_bytes, downlink_bytes=acc.downlink_bytes,
            client_ms=1e3 * ((t1 - t0) + (t3 - t2)),
            server_ms=1e3 * (t2 - t1), cluster_index=int(order[0]),
            mode="batch", probes=len(order), n_buckets=acc.n_buckets,
            hint_bytes=acc.hint_bytes)
        return top, stats

    def query_batch(self, query_embs: np.ndarray, *,
                    top_k: int | Sequence[int] = 10, multi_probe: int = 1,
                    generator: torch.Generator | None = None
                    ) -> list[list[tuple[int, float, bytes]]]:
        """Batched serving: B clients' encrypted queries in one GEMM.

        top_k may be per-request (a sequence aligned with `query_embs`).
        multi_probe > 1 with `enable_batch()` routes every client through
        batch-PIR: all clients' per-bucket queries stack along the column
        axis of the SAME bucketed product, one pass per serving batch.
        """
        return self.query_batch_async(query_embs, top_k=top_k,
                                      multi_probe=multi_probe,
                                      generator=generator).complete()

    def query_batch_async(self, query_embs: np.ndarray, *,
                          top_k: int | Sequence[int] = 10,
                          multi_probe: int = 1,
                          generator: torch.Generator | None = None
                          ) -> InflightBatch:
        """Plan + dispatch a serving batch; decode deferred to `complete()`.

        Encryption, the answer GEMM, the batched recover and the decoded
        columns' host copy are all enqueued on the device stream here;
        ``pending`` holds the decoded (m, B·P) u8 columns.  `query_batch` is
        ``query_batch_async(...).complete()``.
        """
        gen = self._generator(generator)
        n_req = len(query_embs)
        top_ks = ([int(top_k)] * n_req if np.isscalar(top_k)
                  else [int(t) for t in top_k])
        if len(top_ks) != n_req:
            raise ValueError(f"{len(top_ks)} top_k values for {n_req} queries")
        if multi_probe > 1 and self.batch is not None:
            return self._query_batch_via_batchpir_async(query_embs, top_ks,
                                                        multi_probe, gen)
        p = max(1, multi_probe)
        client = pir.PIRClient(self.cfg, self.hint,
                               a_mat=self.server.a_matrix)
        emb_dim = self.db.emb_dim
        orders = self._cluster_order(query_embs, p)          # (B, P)
        qs, secrets = client.query_batch(gen, orders.reshape(-1).tolist())
        ans = self.server.answer(qs)                          # (m, B·P)
        cols = client.recover_batch(ans, secrets)
        # one contiguous row a column on the host, so parsing reads it as is
        host = to_host_async(cols.T.contiguous())

        def complete():
            rows = host.numpy()
            return [rerank.rerank_columns(
                np.asarray(query_embs[b], np.float32),
                [chunking.parse_column(rows[b * p + j], emb_dim)
                 for j in range(p)], top_ks[b]) for b in range(n_req)]

        return InflightBatch(_complete=complete, pending=(cols,))

    def _query_batch_via_batchpir_async(self, query_embs: np.ndarray,
                                        top_ks: list[int], multi_probe: int,
                                        gen: torch.Generator
                                        ) -> InflightBatch:
        """Multi-probe serving batch: C clients × B buckets, one bucketed
        product, one A_b·S_b and one H_b·S_b per bucket.

        Per-client placement failures fall back to that client's legacy
        multi-probe query, drawn at its place in the client order; everyone
        else shares the stacked pass.  The decode is queued here, against
        the hints of this batch's epoch, so a later commit cannot reach it.
        """
        from repro_torch.batchpir import PlacementError
        bp = self.batch
        emb_dim = self.db.emb_dim
        orders = self._cluster_order(query_embs, multi_probe)
        draws, live, fallback = [], [], {}
        for i in range(len(query_embs)):
            try:
                draws.append(bp.client.draw(gen,
                                            [int(c) for c in orders[i]]))
            except PlacementError:
                # drawn here, at its place in the client order
                fallback[i] = self.query(query_embs[i], top_k=top_ks[i],
                                         multi_probe=multi_probe,
                                         generator=gen, mode="legacy")[0]
                continue
            live.append(i)
        answers, _, decoded = self._stacked_pass(bp, draws)

        def complete():
            out: list[list | None] = [None] * len(query_embs)
            if decoded is not None:
                for i, cols in zip(live, decoded.columns()):
                    out[i] = rerank.rerank_columns(
                        np.asarray(query_embs[i], np.float32),
                        [chunking.parse_column(cols[int(cl)], emb_dim)
                         for cl in orders[i]], top_ks[i])
            for i, top in fallback.items():
                out[i] = top
            return out

        return InflightBatch(_complete=complete, pending=tuple(answers))
