"""Graph-PIR baseline, PACMANN-inspired, paper §4.1 baseline 1 (twin of
``repro/core/baselines/graph_pir.py``).

A k-NN similarity graph is built over the document embeddings; retrieval is
a private best-first beam traversal.  At every hop the client PIR-fetches
the *records* (quantized embedding + adjacency list + a SimHash sketch of
every neighbour) of its best unvisited candidates — one query batch and one
server product per hop — scores them locally, and expands.  The server
sees only pseudorandom query vectors, never which nodes are walked.

Candidates are ranked by their OWN sketch similarity to the query (the
sketches ride inside the fetched records; the projection is public), so
the walk does not dead-end where the best beam's neighbourhoods run out.

On the device: the k-NN product, in row blocks (fp32, TF32 off, the
diagonal masked, `torch.topk`; the reference's numpy ``n × n`` product
does not fit memory at corpus scale), the hint, the entry-point k-means
and every hop's encryption, answer and decode.  The traversal stays on
the host as written.  The decode is exact, so ids, hops, bytes and
fetched nodes do not depend on the LWE draws.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch._common import resolve_device, sync
from repro_torch.core import chunking, clustering, pir, threefry
from repro_torch.core.baselines import common


@dataclasses.dataclass
class GraphPIRStats:
    hops: int
    uplink_bytes: int
    downlink_bytes: int
    fetched_nodes: int
    server_ms: float


#: query rows of one block of the k-NN product (a 1024 × n fp32 block of
#: similarities: 2.8 GB at n = 700,000)
KNN_BLOCK = 1024


def build_knn_graph(embs: np.ndarray, k: int, *,
                    device: str | torch.device | None = None) -> np.ndarray:
    """Exact k-NN adjacency (n, k) u32 by cosine, on ``device``.

    The unit rows are formed in numpy as the reference forms them; the
    similarities of each block of `KNN_BLOCK` rows are one fp32 product
    against all rows with TF32 off, the self-similarity set to −inf, and
    the k largest taken in descending order.  Equal to the reference's
    ``argsort(-sims)[:, :k]`` wherever no two similarities lie within the
    products' rounding of each other.
    """
    dev = resolve_device(device)
    n = embs.shape[0]
    nn = embs / (np.linalg.norm(embs, axis=1, keepdims=True) + 1e-12)
    x = torch.from_numpy(np.asarray(nn, np.float32)).to(dev)
    out = torch.empty((n, min(k, n)), dtype=torch.int64, device=dev)
    keep = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for r0 in range(0, n, KNN_BLOCK):
            sims = x[r0:r0 + KNN_BLOCK] @ x.T
            sims.diagonal(offset=r0).fill_(-torch.inf)
            out[r0:r0 + KNN_BLOCK] = torch.topk(sims, out.shape[1],
                                                dim=1).indices
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep
    return out.cpu().numpy().astype(np.uint32)


def build_nav_graph(embs: np.ndarray, k: int, n_random: int,
                    seed: int = 0, *,
                    device: str | torch.device | None = None) -> np.ndarray:
    """k-NN edges + NSW-style random long links for navigability.

    Pure k-NN graphs fragment across topic clusters; a few uniform
    long-range edges per node (small-world construction) make greedy
    traversal reach any region.
    """
    n = embs.shape[0]
    knn = build_knn_graph(embs, k, device=device)
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, n, (n, n_random), dtype=np.uint32)
    return np.concatenate([knn, rand], axis=1)


_SKETCH_BITS = 64               # default SimHash sign bits per node (8 B)


def sketch_matrix(seed: int, d: int, bits: int = _SKETCH_BITS) -> np.ndarray:
    """Public random projection for the navigation sketches (client and
    server derive it from a shared seed, like the LWE matrix A).  Wider
    sketches estimate cosine similarity more tightly but inflate every
    node record by `degree · bits/8` bytes."""
    assert bits % 8 == 0 and bits > 0, bits
    return np.random.default_rng(seed ^ 0x51E7C4).standard_normal(
        (bits, d)).astype(np.float32)


def embed_sketches(embs: np.ndarray, proj: np.ndarray) -> np.ndarray:
    """(n, d) embeddings → (n, bits/8) uint8 packed sign bits of proj·emb."""
    nn = embs / (np.linalg.norm(embs, axis=1, keepdims=True) + 1e-12)
    bits = (nn @ proj.T) > 0
    return np.packbits(bits, axis=1)


def node_records(embs: np.ndarray, graph: np.ndarray,
                 sketches: np.ndarray) -> np.ndarray:
    """Every node's record, (n, m) u8, row-major: [scale f32][offset f32]
    [q u8 × d][neighbour ids u32 × deg][neighbour sketches u8 × deg·bits/8]
    (the reference's `_serialize_node`, byte for byte)."""
    n = embs.shape[0]
    q, scale, off = chunking.quantize_rows(embs)
    hdr = np.stack([scale, off], axis=1).view(np.uint8)
    nbrs = np.ascontiguousarray(graph, "<u4").view(np.uint8)
    return np.concatenate([hdr, q, nbrs, sketches[graph].reshape(n, -1)],
                          axis=1)


@dataclasses.dataclass
class GraphPIRSystem:
    cfg: pir.PIRConfig
    server: pir.PIRServer
    hint: torch.Tensor
    entry_points: np.ndarray      # public medoid ids
    emb_dim: int
    graph_degree: int
    setup_seconds: float
    n_docs: int
    index_seconds: float = 0.0    # graph construction (no crypto)
    hint_seconds: float = 0.0
    sketch_seed: int = 0          # public seed of the navigation projection
    sketch_bits: int = _SKETCH_BITS   # SimHash width carried per neighbour

    @property
    def device(self) -> torch.device:
        return self.server.device

    @classmethod
    def build(cls, embeddings: np.ndarray, *, degree: int = 12,
              n_random: int = 4, n_entry: int = 8, impl: str = "auto",
              seed: int = 0, sketch_bits: int = _SKETCH_BITS,
              device: str | torch.device | None = None
              ) -> "GraphPIRSystem":
        """Graph, records and hint on ``device`` (default ``cuda``; raises
        without a card), then the entry points: the medoids of a coarse
        k-means."""
        dev = resolve_device(device)
        t0 = time.perf_counter()
        system = cls._from_parts(embeddings, np.zeros(0, np.int64),
                                 degree=degree, n_random=n_random, seed=seed,
                                 sketch_bits=sketch_bits, impl=impl,
                                 device=dev, t0=t0)
        x = torch.from_numpy(np.asarray(embeddings, np.float32)).to(dev)
        km = clustering.kmeans_fit(
            threefry.torch_generator(threefry.PRNGKey(seed), dev), x,
            k=min(n_entry, len(x)), iters=8, impl=impl)
        d2 = clustering.pairwise_sqdist(x, km.centroids)
        system.entry_points = np.unique(
            d2.argmin(dim=0).cpu().numpy()).astype(np.int64)
        system.setup_seconds = time.perf_counter() - t0
        return system

    @classmethod
    def _from_parts(cls, embeddings: np.ndarray, entry_points: np.ndarray,
                    *, degree: int, n_random: int, seed: int,
                    sketch_bits: int, impl: str, device: torch.device,
                    t0: float) -> "GraphPIRSystem":
        """Graph, sketches, node records, upload (index_seconds) and hint
        (hint_seconds)."""
        n, d = embeddings.shape
        graph = build_nav_graph(embeddings, degree, n_random, seed=seed,
                                device=device)
        sketches = embed_sketches(embeddings,
                                  sketch_matrix(seed, d, sketch_bits))
        rows = node_records(embeddings, graph, sketches)
        cfg = pir.make_config(rows.shape[1], n, impl=impl)
        common.require_byte_plaintext(cfg)
        server = pir.PIRServer(cfg, common.upload_columns(rows, device))
        sync(device)
        t_index = time.perf_counter()
        hint = server.setup()
        sync(device)
        t_hint = time.perf_counter()
        return cls(cfg=cfg, server=server, hint=hint,
                   entry_points=np.asarray(entry_points, np.int64),
                   emb_dim=d, graph_degree=degree + n_random,
                   setup_seconds=t_hint - t0, n_docs=n,
                   index_seconds=t_index - t0, hint_seconds=t_hint - t_index,
                   sketch_seed=seed, sketch_bits=sketch_bits)

    def _decode_node(self, col: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """→ (embedding (d,), neighbour ids (deg,), sketches (deg, bits/8))."""
        buf = col.tobytes()
        scale = float(np.frombuffer(buf[0:4], np.float32)[0])
        off = float(np.frombuffer(buf[4:8], np.float32)[0])
        q = np.frombuffer(buf[8:8 + self.emb_dim], np.uint8)
        ofs = 8 + self.emb_dim
        nbrs = np.frombuffer(buf[ofs:ofs + 4 * self.graph_degree], np.uint32)
        ofs += 4 * self.graph_degree
        sk = np.frombuffer(
            buf[ofs:ofs + (self.sketch_bits // 8) * self.graph_degree],
            np.uint8).reshape(self.graph_degree, self.sketch_bits // 8)
        return chunking.dequantize_embedding(q, scale, off), nbrs, sk

    def fetch_records(self, client: pir.PIRClient, gen: torch.Generator,
                      nodes: list[int]) -> tuple[np.ndarray, float]:
        """One hop's private fetch: one query batch, one answer, one decode.
        Returns (records (m, len(nodes)) u8, server milliseconds)."""
        qs, secrets = client.query_batch(gen, nodes)
        sync(self.device)
        t0 = time.perf_counter()
        ans = self.server.answer(qs)
        sync(self.device)
        server_ms = 1e3 * (time.perf_counter() - t0)
        return client.recover_batch(ans, secrets).cpu().numpy(), server_ms

    def search(self, query_emb: np.ndarray, *, top_k: int = 10,
               beam: int = 8, max_hops: int = 6, seed: int = 0
               ) -> tuple[np.ndarray, GraphPIRStats]:
        """Private best-first traversal; one batched PIR fetch per hop.

        The candidate pool persists across hops (a hop that exhausts one
        region backtracks to the best unvisited candidate seen anywhere),
        is deduplicated, and is ranked by each candidate's own sketch
        similarity to the query.  LWE draws come from a generator seeded
        ``seed``.
        """
        gen = torch.Generator(device=self.device).manual_seed(seed)
        client = pir.PIRClient(self.cfg, self.hint,
                               a_mat=self.server.a_matrix)
        qn = query_emb / (np.linalg.norm(query_emb) + 1e-12)
        proj = sketch_matrix(self.sketch_seed, self.emb_dim,
                             self.sketch_bits)
        qbits = np.unpackbits(embed_sketches(qn[None, :], proj)[0])

        def sketch_sim(packed: np.ndarray) -> float:
            """Fraction of agreeing sign bits ≈ 1 − angle/π (SimHash)."""
            return float(
                (np.unpackbits(packed) == qbits).mean())

        scored: dict[int, float] = {}
        # pool: candidate → own estimated similarity; entries are fetched
        # first regardless (their sketches are unknown until decoded)
        pool: dict[int, float] = {int(e): float("inf")
                                  for e in self.entry_points}
        up = down = fetched = 0
        server_ms = 0.0
        hops = 0
        for _ in range(max_hops):
            cand = sorted(pool, key=lambda c: -pool[c])[:beam]
            if not cand:
                break
            hops += 1
            cols, ms = self.fetch_records(client, gen, cand)
            server_ms += ms
            up += len(cand) * self.cfg.uplink_bytes
            down += len(cand) * self.cfg.downlink_bytes
            fetched += len(cand)

            for j, node in enumerate(cand):
                emb, nbrs, sketches = self._decode_node(cols[:, j])
                scored[node] = float(
                    emb @ qn / (np.linalg.norm(emb) + 1e-12))
                pool.pop(node, None)
                for x, sk in zip(nbrs, sketches):
                    x = int(x)
                    if x not in scored and x not in pool:
                        pool[x] = sketch_sim(sk)
        ids = np.array(sorted(scored, key=lambda n: -scored[n])[:top_k],
                       np.int64)
        return ids, GraphPIRStats(hops=hops, uplink_bytes=up,
                                  downlink_bytes=down, fetched_nodes=fetched,
                                  server_ms=server_ms)
