"""Tiptoe-style private-scoring baseline, paper §4.1 baseline 2 (twin of
``repro/core/baselines/tiptoe.py``).

Clustered corpus; the client picks a cluster from public centroids and sends
(a) the cluster id IN THE CLEAR — the documented leak of this architecture —
and (b) its query embedding LWE-encrypted coordinate-wise, quantized to a few
signed bits.  The server homomorphically computes similarity scores for every
document in that cluster (one u8×u32 GEMV through the modular product) and
returns ONLY encrypted scores.  The client decrypts, ranks, and — for a RAG
workflow — still owes K private content fetches (``DocContentPIR``).

Homomorphic scoring must fit `Σ d_i·q_i` inside the plaintext modulus
*after* LWE noise, forcing coarse (≈5-bit) embedding quantization
server-side: the mechanism behind its quality gap (paper Fig. 3).

On the device: the k-means (`clustering.kmeans_fit`), one hint product per
non-empty cluster (`ops.hint_gemm`), the query's cluster
(`clustering.assign_to_centroids`), the encryption, the scoring product
(`ops.modmatmul`) and the hint strip.  The offset correction and the
ranking stay on the host, as in the reference, so tie order matches.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch._common import resolve_device, sync, to_device
from repro_torch.core import clustering, lwe, threefry
from repro_torch.core.baselines import common
from repro_torch.kernels import ops


@dataclasses.dataclass
class TiptoeStats:
    uplink_bytes: int
    downlink_bytes: int
    server_ms: float
    cluster_index: int            # visible to the server (the leak)


def feasible_levels(d: int, levels: int, params: lwe.LWEParams) -> int:
    """Shrink L until the shifted products d·(2L)² fit below p and the LWE
    noise z·σ·√d·(2L) below q/2p — the quantization coarsening that costs
    Tiptoe its ranking quality."""
    p = params.p
    L = levels
    while L > 1:
        vmax = d * (2 * L) ** 2
        noise = params.z_tail * params.sigma * np.sqrt(d) * (2 * L)
        if vmax < p and noise < lwe.Q / (2 * p):
            return L
        L -= 1
    raise ValueError("no feasible tiptoe quantization")


@dataclasses.dataclass
class TiptoeSystem:
    centroids: np.ndarray                     # public
    params: lwe.LWEParams
    quant: common.QuantScheme
    cluster_mats: list[torch.Tensor]          # per-cluster (n_docs_c, d) u8
    cluster_doc_ids: list[np.ndarray]
    cluster_rowsums: list[np.ndarray]         # public Σd per doc (offset corr.)
    hints: list[torch.Tensor]                 # per-cluster D_c · A
    a_mat: torch.Tensor                       # public (d, k), from a_seed
    a_seed: int
    emb_dim: int
    setup_seconds: float
    impl: str = "auto"

    @property
    def device(self) -> torch.device:
        return self.a_mat.device

    # -- offline --------------------------------------------------------------

    @classmethod
    def build(cls, embeddings: np.ndarray, *, n_clusters: int,
              levels: int = 15, kmeans_iters: int = 25, seed: int = 0,
              impl: str = "auto",
              device: str | torch.device | None = None) -> "TiptoeSystem":
        """k-means on ``device`` (default ``cuda``; raises without a card),
        then `_from_parts`."""
        dev = resolve_device(device)
        t0 = time.perf_counter()
        x = torch.from_numpy(np.asarray(embeddings, np.float32)).to(dev)
        km = clustering.kmeans_fit(
            threefry.torch_generator(threefry.PRNGKey(seed), dev), x,
            k=n_clusters, iters=kmeans_iters, impl=impl)
        return cls._from_parts(embeddings, km.centroids.cpu().numpy(),
                               km.assignment.cpu().numpy(), n_clusters,
                               levels=levels, seed=seed, impl=impl,
                               device=dev, t0=t0)

    @classmethod
    def _from_parts(cls, embeddings: np.ndarray, cents: np.ndarray,
                    assign: np.ndarray, n_clusters: int, *, levels: int,
                    seed: int, impl: str, device: torch.device,
                    t0: float) -> "TiptoeSystem":
        """Quantize, upload and hint a clustered corpus (build's second
        half): one upload of every cluster's rows, one hint product per
        non-empty cluster."""
        n, d = embeddings.shape
        params = lwe.LWEParams(p=1 << 16, q_switch=None)
        quant = common.fit_quant(embeddings, feasible_levels(d, levels,
                                                             params))
        a_seed = seed + 101
        a_mat = lwe.gen_public_matrix(a_seed, d, params.k, device=device)
        assign = np.asarray(assign)
        # members of each cluster in ascending row order, one stable sort
        order = np.argsort(assign, kind="stable")
        bounds = np.searchsorted(assign[order], np.arange(n_clusters + 1))
        dq = quant.quantize(np.asarray(embeddings)[order])
        sums = dq.astype(np.int64).sum(axis=1)
        dq_dev = to_device(dq, device)
        mats, ids, rowsums, hints = [], [], [], []
        for j in range(n_clusters):
            lo, hi = int(bounds[j]), int(bounds[j + 1])
            mats.append(dq_dev[lo:hi])
            ids.append(order[lo:hi].astype(np.int64))
            rowsums.append(sums[lo:hi])
            hints.append(ops.hint_gemm(mats[j], a_mat, impl=impl) if hi > lo
                         else torch.zeros((0, params.k), dtype=torch.int32,
                                          device=device))
        sync(device)
        return cls(centroids=np.asarray(cents, np.float32), params=params,
                   quant=quant, cluster_mats=mats, cluster_doc_ids=ids,
                   cluster_rowsums=rowsums, hints=hints, a_mat=a_mat,
                   a_seed=a_seed, emb_dim=d,
                   setup_seconds=time.perf_counter() - t0, impl=impl)

    # -- online ---------------------------------------------------------------

    def search(self, query_emb: np.ndarray, *, top_k: int = 10,
               generator: torch.Generator | None = None
               ) -> tuple[np.ndarray, TiptoeStats]:
        """Private scoring of the query's cluster.  The LWE secret and
        errors come from ``generator`` (default: seeded 0)."""
        dev = self.device
        gen = (generator if generator is not None
               else torch.Generator(device=dev).manual_seed(0))
        q32 = np.asarray(query_emb, np.float32)
        cl = int(clustering.assign_to_centroids(
            to_device(q32[None], dev), to_device(self.centroids, dev),
            impl=self.impl)[0])
        dmat = self.cluster_mats[cl]
        if dmat.shape[0] == 0:
            return np.zeros(0, np.int64), TiptoeStats(0, 0, 0.0, cl)

        # client: encrypt shifted-unsigned quantized query
        q_shift = self.quant.quantize(q32)
        ct, s = common.encrypt_embedding(gen, q_shift, self.params,
                                         self.a_mat, impl=self.impl)

        # server: encrypted scores for every doc in the (known) cluster
        sync(dev)
        t0 = time.perf_counter()
        ans = ops.modmatmul(dmat, ct, impl=self.impl)
        sync(dev)
        server_ms = 1e3 * (time.perf_counter() - t0)

        # client: decrypt, de-offset, rank
        rec = lwe.hint_strip(ans, self.hints[cl], s, impl=self.impl)
        raw = lwe.decode(rec, self.params).cpu().numpy()
        half = self.params.p // 2
        raw = np.where(raw >= half, raw - self.params.p, raw)   # center mod p
        L = self.quant.levels
        sum_q = int(q_shift.astype(np.int64).sum())
        # Σ(d+L)(q+L) = Σdq + L·Σd + L·Σq + dim·L²  →  Σdq =
        scores = (raw - L * self.cluster_rowsums[cl] - L * sum_q
                  - self.emb_dim * L * L)
        order = np.argsort(-scores)[:top_k]
        ids = self.cluster_doc_ids[cl][order]
        stats = TiptoeStats(
            uplink_bytes=self.emb_dim * 4,
            downlink_bytes=int(dmat.shape[0]) * 4,
            server_ms=server_ms, cluster_index=cl)
        return ids, stats
