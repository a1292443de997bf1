"""PIR-RAG end-to-end system on one device (twin of ``repro/core/pipeline.py``).

Offline (server): K-means → chunk-transposed DB → PIR hint.
Online (client): pick cluster from PUBLIC centroids → LWE-encrypted one-hot
→ server modular GEMV → decrypt whole cluster → local exact re-rank.

The server never sees the query embedding, the chosen cluster, or the ranked
results.  This slice ports the legacy (one-hot per probe) path only: no
batch-PIR, keyed lookups or mesh.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch._common import resolve_device, sync
from repro_torch.core import chunking, clustering, pir, rerank, threefry


@dataclasses.dataclass
class InflightBatch:
    """A dispatched serving batch: answer and decode enqueued on the device.

    `complete()` copies the decoded columns to the host, parses and
    re-ranks them, and returns exactly what `query_batch` would have.
    """
    _complete: Callable[[], list]
    pending: tuple = ()            # device tensors the dispatch produced
    done: bool = False

    def complete(self) -> list:
        """Decode + re-rank; same return value as `query_batch`."""
        if self.done:
            raise RuntimeError("InflightBatch.complete() called twice")
        out = self._complete()
        self.done = True
        return out


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
    mode: str = "legacy"          # one one-hot query per probe
    probes: int = 1               # clusters privately fetched
    n_buckets: int = 0            # batch-PIR buckets (not ported: always 0)
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
              device: str | torch.device | None = None) -> "PirRagSystem":
        """Offline setup: K-means → chunk-transposed DB → PIR hint.

        ``seed`` feeds two independent streams: cluster seeding and the
        public LWE matrix seed (`cfg.a_seed`, bitwise the JAX package's).
        ``doc_ids`` (default 0..N−1) keeps external document ids, as a
        live index's full rebuild needs.  Runs on ``device`` (default
        ``cuda``; raises without a card).
        """
        dev = resolve_device(device)
        t0 = time.perf_counter()
        k_km, a_seed = _derive_build_streams(seed)
        embf = np.asarray(embeddings, np.float32)
        x = torch.from_numpy(embf).to(dev)
        km = clustering.kmeans_fit(threefry.torch_generator(k_km, dev), x,
                                   k=n_clusters, iters=kmeans_iters,
                                   n_blocks=clustering.BUILD_BLOCKS, impl=impl)
        cents = km.centroids.cpu().numpy()
        kmeans_s = time.perf_counter() - t0
        if balance_factor is not None:
            cap = int(np.ceil(len(texts) / n_clusters * balance_factor))
            d2 = clustering.blocked_sqdist(x, km.centroids,
                                           n_blocks=clustering.BUILD_BLOCKS)
            assign = clustering.balanced_assign(embf, cents, cap,
                                                d2=d2.cpu().numpy())
        else:
            assign = km.assignment.cpu().numpy()
        system = cls._from_parts(texts, embf, cents, assign, n_clusters,
                                 a_seed=a_seed, chunk_size=chunk_size,
                                 q_switch=q_switch, impl=impl, device=dev,
                                 t0=t0, doc_ids=doc_ids)
        system.kmeans_seconds = kmeans_s
        return system

    @classmethod
    def _from_parts(cls, texts, embf: np.ndarray, cents: np.ndarray,
                    assign: np.ndarray, n_clusters: int, *, a_seed: int,
                    chunk_size: int, q_switch: int | None, impl: str,
                    device: torch.device, t0: float,
                    doc_ids: Sequence[int] | None = None) -> "PirRagSystem":
        """Pack, upload and hint a clustered corpus (build's second half)."""
        t_pack = time.perf_counter()
        db = chunking.build_chunked_db(texts, embf, assign, n_clusters,
                                       chunk_size, doc_ids=doc_ids)
        pack_s = time.perf_counter() - t_pack
        cfg = pir.make_config(db.m, db.n, impl=impl, q_switch=q_switch,
                              a_seed=a_seed)
        server = pir.PIRServer(cfg, torch.from_numpy(db.matrix).to(device))
        sync(device)
        t_index = time.perf_counter()
        hint = server.setup()
        sync(device)
        t_end = time.perf_counter()
        return cls(centroids=np.asarray(cents, np.float32), db=db, cfg=cfg,
                   server=server, hint=hint, setup_seconds=t_end - t0,
                   index_seconds=t_index - t0, pack_seconds=pack_s,
                   hint_seconds=t_end - t_index, assignment=assign,
                   _qgen=_fresh_client_generator(device))

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
        d2 = clustering.pairwise_sqdist(
            torch.as_tensor(np.asarray(query_embs, np.float32)).to(self.device),
            torch.tensor(self.centroids, device=self.device))
        return np.argsort(d2.cpu().numpy(), axis=1)[:, :probes]

    def query(self, query_emb: np.ndarray, *, top_k: int = 10,
              multi_probe: int = 1, generator: torch.Generator | None = None
              ) -> tuple[list[tuple[int, float, bytes]], QueryStats]:
        """One fully private retrieval; returns top-k docs + accounting.

        multi_probe=P privately fetches the P nearest clusters with P
        one-hot queries in one GEMM.  LWE secrets and errors come from
        ``generator`` (default: the system's OS-seeded client stream).
        """
        gen = self._generator(generator)
        t0 = time.perf_counter()
        order = self._cluster_order(np.asarray(query_emb)[None, :],
                                    max(1, multi_probe))[0]
        client = pir.PIRClient(self.cfg, self.hint,
                               a_mat=self.server.a_matrix)
        qs, secrets = client.query_batch(gen, [int(c) for c in order])
        sync(self.device)
        t1 = time.perf_counter()

        ans = self.server.answer(qs)
        sync(self.device)
        t2 = time.perf_counter()

        cols = client.recover_batch(ans, secrets).cpu().numpy()
        docs = []
        for j in range(len(order)):
            docs.extend(chunking.deserialize_docs(cols[:, j], self.db.emb_dim))
        top = rerank.rerank(np.asarray(query_emb, np.float32), docs, top_k)
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

    def query_batch(self, query_embs: np.ndarray, *,
                    top_k: int | Sequence[int] = 10, multi_probe: int = 1,
                    generator: torch.Generator | None = None
                    ) -> list[list[tuple[int, float, bytes]]]:
        """Batched serving: B clients' encrypted queries in one GEMM.

        top_k may be per-request (a sequence aligned with `query_embs`).
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

        Encryption, the answer GEMM and the batched recover are all enqueued
        on the device stream here; ``pending`` holds the decoded (m, B·P)
        u8 columns.  `query_batch` is ``query_batch_async(...).complete()``.
        """
        gen = self._generator(generator)
        n_req = len(query_embs)
        top_ks = ([int(top_k)] * n_req if np.isscalar(top_k)
                  else [int(t) for t in top_k])
        if len(top_ks) != n_req:
            raise ValueError(f"{len(top_ks)} top_k values for {n_req} queries")
        p = max(1, multi_probe)
        client = pir.PIRClient(self.cfg, self.hint,
                               a_mat=self.server.a_matrix)
        emb_dim = self.db.emb_dim
        orders = self._cluster_order(query_embs, p)          # (B, P)
        qs, secrets = client.query_batch(gen, orders.reshape(-1).tolist())
        ans = self.server.answer(qs)                          # (m, B·P)
        cols = client.recover_batch(ans, secrets)

        def complete():
            cols_np = cols.cpu().numpy()
            out = []
            for b in range(n_req):
                docs = []
                for j in range(p):
                    docs.extend(chunking.deserialize_docs(
                        cols_np[:, b * p + j], emb_dim))
                out.append(rerank.rerank(
                    np.asarray(query_embs[b], np.float32), docs, top_ks[b]))
            return out

        return InflightBatch(_complete=complete, pending=(cols,))
