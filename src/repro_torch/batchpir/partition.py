"""Cuckoo bucketization of the cluster space (batch-PIR layer 1; twin of
``repro/batchpir/partition.py``, numpy, a copy).

The cluster axis of the chunk-transposed DB is split into B buckets using
3-way cuckoo hashing (the probabilistic-batch-code construction from the
batch-PIR literature):

  server side — every cluster j gets THREE candidate buckets derived from a
    public seed, and its column is replicated into each candidate's sub-DB.
    Candidates come from a balanced template (each bucket receives the same
    number of replicas ±1), so all bucket widths equal ~3n/B and the shared
    kernel width pads minimally.

  client side — a client that wants κ clusters cuckoo-places them, each
    into exactly ONE of its three candidates with at most one cluster per
    bucket, via random-walk eviction.  A placement failure (walk cycles)
    retries with a fresh walk seed; only a structurally infeasible probe
    set (Hall violation, probability ≪ 1e-4 for κ ≤ B/3) raises
    PlacementError, which callers treat as "fall back to the legacy path".

Everything here is deterministic given (seed, walk seed): server and client
derive identical candidate tables independently, so only the seed is ever
communicated.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


class PlacementError(RuntimeError):
    """The probe set admits no one-cluster-per-bucket cuckoo placement."""

    def __init__(self, clusters, n_buckets: int, retries: int):
        super().__init__(
            f"cannot place {len(clusters)} probe clusters into "
            f"{n_buckets} buckets after {retries} walk retries")
        self.clusters = tuple(clusters)
        self.retries = retries


def _balanced_candidates(n_clusters: int, n_buckets: int,
                         rng: np.random.Generator) -> np.ndarray:
    """(n, 3) distinct candidate buckets per cluster, bucket loads ±1.

    Greedy least-loaded with a random tiebreak: each cluster takes the three
    least-loaded buckets, which keeps every load within 1 of the others
    (inductively: the three minima are always raised first), while the
    tiebreak shuffle makes the triples pseudorandom — what the cuckoo walk
    needs for placement to succeed with overwhelming probability.
    """
    cand = np.zeros((n_clusters, 3), np.int64)
    loads = np.zeros(n_buckets, np.int64)
    for j in range(n_clusters):
        order = np.lexsort((rng.random(n_buckets), loads))
        cand[j] = np.sort(order[:3])
        loads[cand[j]] += 1
    return cand


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class KeyedLayout:
    """Keyed grouping of a fixed-width embedding table (recsys serving).

    The document path clusters by embedding similarity; a recsys embedding
    lookup is KEYED — the client knows row ids, not contents — so the
    "clusters" are just contiguous id ranges: row i lives in group
    ``i // group_size`` at within-group position ``i % group_size``.
    Both sides derive the mapping from (n_rows, group_size) alone; nothing
    about the table contents leaks into the layout.

    Row codec: each row serializes through the standard chunking record
    with ``text`` = the row's raw little-endian f32 bytes, so every record
    has the same width (16-byte header + d quantized bytes + 4d payload
    bytes) and a group's column decodes by fixed-stride arithmetic.  The
    f32 payload round-trips bit-exactly — the u8-quantized emb field only
    feeds the (inert, for keyed systems) legacy re-rank path.
    """
    n_rows: int                 # V: embedding table rows
    dim: int                    # d: embedding width (f32 lanes)
    group_size: int             # rows per group; last group may be short

    @classmethod
    def build(cls, n_rows: int, dim: int,
              group_size: int | None = None) -> "KeyedLayout":
        """Size the grouping; default group_size ≈ √V balances the column
        height (group_size·record bytes) against the group count (the PIR
        query width), the same m×n tradeoff the document build makes."""
        if n_rows < 1 or dim < 1:
            raise ValueError(f"need n_rows, dim >= 1, got {n_rows}, {dim}")
        if group_size is None:
            group_size = max(1, math.isqrt(n_rows))
        if group_size < 1:
            raise ValueError(f"group_size must be >= 1, got {group_size}")
        return cls(n_rows=n_rows, dim=dim, group_size=group_size)

    @property
    def n_groups(self) -> int:
        """Number of id groups = PIR clusters of the keyed DB."""
        return -(-self.n_rows // self.group_size)

    @property
    def record_stride(self) -> int:
        """Fixed serialized bytes per row record: header + emb_q + raw f32."""
        return 16 + 5 * self.dim

    def group_of(self, row_id: int) -> int:
        """The group (cluster) holding table row ``row_id``."""
        if not 0 <= row_id < self.n_rows:
            raise IndexError(f"row id {row_id} outside table "
                             f"[0, {self.n_rows})")
        return row_id // self.group_size

    def groups_of(self, ids) -> list[int]:
        """Distinct, sorted groups covering an id multiset — the probe set
        handed to cuckoo placement (duplicates fan back out at decode)."""
        return sorted({self.group_of(int(i)) for i in ids})

    def row_text(self, row: np.ndarray) -> bytes:
        """A row's record payload: its raw little-endian f32 bytes."""
        return np.ascontiguousarray(row, dtype="<f4").tobytes()

    def decode_row(self, col: np.ndarray, row_id: int) -> np.ndarray:
        """Extract row ``row_id`` from its group's decrypted column bytes.

        Fixed-stride: group g packs rows [g·gs, min((g+1)·gs, V)) in
        ascending id order (the canonical `chunking.pack_column` order), so
        the record sits at ``4 + (row_id % gs)·record_stride``.  The id
        header is verified; on mismatch (a corrupt or foreign column) the
        records are scanned before giving up.
        """
        g = self.group_of(row_id)
        stride = self.record_stride
        start = 4 + (row_id - g * self.group_size) * stride
        buf = np.asarray(col, np.uint8)
        rec = buf[start:start + stride]
        if (len(rec) == stride
                and int(np.frombuffer(rec[:4].tobytes(), np.uint32)[0])
                == row_id):
            return np.frombuffer(
                rec[16 + self.dim:].tobytes(), "<f4").copy()
        n_docs = int(np.frombuffer(buf[:4].tobytes(), np.uint32)[0])
        for p in range(n_docs):
            rec = buf[4 + p * stride:4 + (p + 1) * stride]
            if (len(rec) == stride
                    and int(np.frombuffer(rec[:4].tobytes(), np.uint32)[0])
                    == row_id):
                return np.frombuffer(
                    rec[16 + self.dim:].tobytes(), "<f4").copy()
        raise KeyError(f"row {row_id} not found in group {g}'s column")


@dataclasses.dataclass(frozen=True)
class CuckooPartition:
    """Public cluster → candidate-bucket mapping plus placement logic."""
    n_clusters: int
    n_buckets: int
    seed: int
    candidates: np.ndarray              # (n, 3) int64, distinct per row
    members: tuple[np.ndarray, ...]     # per bucket: sorted member clusters
    width: int                          # shared sub-DB width (power of two)

    @classmethod
    def build(cls, n_clusters: int, n_buckets: int, seed: int
              ) -> "CuckooPartition":
        """Draw the public 3-way candidate map from `seed` (balanced, so
        every bucket width is ≈ 3n/B, padded to a shared power of two)."""
        if n_buckets < 3:
            raise ValueError("3-way cuckoo needs at least 3 buckets")
        rng = np.random.default_rng([0x5C0B, seed, n_clusters, n_buckets])
        cand = _balanced_candidates(n_clusters, n_buckets, rng)
        members = tuple(np.sort(np.nonzero((cand == b).any(axis=1))[0])
                        for b in range(n_buckets))
        width = _next_pow2(max(1, max(len(m) for m in members)))
        return cls(n_clusters=n_clusters, n_buckets=n_buckets, seed=seed,
                   candidates=cand, members=members, width=width)

    def position(self, bucket: int, cluster: int) -> int:
        """Local column index of `cluster` inside `bucket`'s sub-DB."""
        mem = self.members[bucket]
        pos = int(np.searchsorted(mem, cluster))
        if pos >= len(mem) or mem[pos] != cluster:
            raise KeyError(f"cluster {cluster} not in bucket {bucket}")
        return pos

    def buckets_of(self, cluster: int) -> tuple[int, int, int]:
        """The three candidate buckets holding `cluster`'s replicas."""
        return tuple(int(b) for b in self.candidates[cluster])

    def place(self, clusters, *, walk_seed: int = 0, retries: int = 16
              ) -> dict[int, int]:
        """Cuckoo-place distinct probe clusters; returns {bucket: cluster}.

        Random-walk eviction: a cluster whose candidates are all occupied
        kicks out one occupant (uniformly) and the evictee re-places.  A
        walk that exceeds its step budget restarts with the next walk seed;
        after `retries` restarts the probe set is declared unplaceable.
        """
        clusters = [int(c) for c in clusters]
        if len(set(clusters)) != len(clusters):
            raise ValueError("probe clusters must be distinct")
        if len(clusters) > self.n_buckets:
            raise PlacementError(clusters, self.n_buckets, 0)
        max_steps = 16 * max(1, len(clusters))
        for r in range(retries):
            rng = np.random.default_rng(
                [0xC0C0, self.seed, walk_seed, r])
            occ: dict[int, int] = {}
            failed = False
            for c in clusters:
                item = c
                for _ in range(max_steps):
                    cand = self.candidates[item]
                    free = [int(b) for b in cand if b not in occ]
                    if free:
                        occ[free[int(rng.integers(len(free)))]] = item
                        break
                    b = int(cand[int(rng.integers(3))])
                    item, occ[b] = occ[b], item
                else:
                    failed = True
                    break
            if not failed:
                return occ
        raise PlacementError(clusters, self.n_buckets, retries)
