"""Batch-PIR server: per-bucket sub-DBs, hints and the one-pass answer
(twin of ``repro/batchpir/server.py``).

Bucket b's sub-DB D_b holds a replica of every member cluster's column,
row-truncated to the tallest member payload (rounded to the row granule):
the global DB pads every column to the single largest cluster, so the
bucket-local truncation turns that padding into compute and downlink
savings.  Columns beyond the member count are zero up to the partition's
shared power-of-two width, so every bucket takes the same query width.

Per bucket there is an independent LWE instance: public matrix A_b from a
bucket-specific seed and hint H_b = D_b·A_b.  A batched query is one u32
vector per bucket; the answer is ONE `ops.bucketed_modmatmul` call, which
on a card is one launch of the grouped kernel over the buckets' own
heights.

With ``mesh=`` (a `launch.mesh.DeviceMesh`) whole buckets spread over the
mesh's shards, longest first to the least-loaded shard
(`collectives.balanced_bucket_order`): each sub-DB lives on its owner's
device, an answer is one grouped launch per shard over its own ragged list
of buckets (`collectives.bucket_shard_gemm`), and the answers, the hints
and the public matrices the client reads stay on the mesh's home device.
A bucket keeps its owner when an overflow rebuilds it.  The JAX twin pads
every bucket to the tallest and stacks them; the grouped kernel walks the
ragged buckets as they are, so nothing is padded.

Live-index deltas route here through `update/routing.py`: a mutation that
re-packs cluster columns J patches the owning buckets' sub-DBs and hints
with the delta-hint kernel, so the patched H_b stays bit-identical to
`setup()` on the mutated sub-DB.  A payload that outgrows its bucket's row
budget rebuilds that bucket alone.  u32 values are int32 tensors holding
the same bits.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch._common import on_device
from repro_torch.batchpir.partition import CuckooPartition
from repro_torch.core import lwe, pir
from repro_torch.distributed import collectives
from repro_torch.kernels import ops

_ROW_GRANULE = 128          # bucket heights round up to this (the JAX tiling)


def _bucket_a_seed(a_seed: int, bucket: int) -> int:
    """Distinct public-matrix seed per bucket, derived from the global one."""
    return a_seed * 1_000_003 + bucket


def _round_rows(used: int) -> int:
    return max(_ROW_GRANULE, ((used + _ROW_GRANULE - 1) // _ROW_GRANULE)
               * _ROW_GRANULE)


def bucket_rows(partition: CuckooPartition, used_bytes: np.ndarray,
                m: int) -> list[int]:
    """Each bucket's sub-DB height: its tallest member's payload rounded up
    to the row granule, never above the DB's ``m`` rows."""
    used = np.asarray(used_bytes)
    return [min(_round_rows(int(used[mem].max()) if len(mem) else 1), m)
            for mem in partition.members]


@dataclasses.dataclass
class BucketUpdate:
    """One bucket's reaction to a live-index mutation batch."""
    bucket: int
    rebuilt: bool               # True: overflow forced a bucket re-hint
    cols: np.ndarray            # local column positions patched (delta only)


@dataclasses.dataclass
class StagedBucketPatch:
    """Shadow half of a bucketed mutation commit: computed, not yet live.

    `stage_update_columns` queues every patched sub-DB, hint and config as
    fresh buffers on the device; `publish()` is the pointer swap.  In-flight
    answers keep decoding against the plan-time snapshots they captured.
    """
    updates: list[BucketUpdate]
    _apply: Callable[[], None]
    published: bool = False

    def publish(self) -> list[BucketUpdate]:
        """Flip every staged bucket pointer; returns the per-bucket log."""
        if self.published:
            raise RuntimeError("StagedBucketPatch published twice")
        self._apply()
        self.published = True
        return self.updates


class BatchPIRServer:
    """Holds the bucketed replica DBs on one device (or spread over a
    mesh's shards) and answers batched queries there."""

    def __init__(self, matrix: torch.Tensor, used_bytes: np.ndarray,
                 partition: CuckooPartition, params: lwe.LWEParams, *,
                 a_seed: int = 7, impl: str = "auto", mesh=None):
        n = partition.n_clusters
        if matrix.dim() != 2 or matrix.shape[1] != n:
            raise ValueError(f"matrix {tuple(matrix.shape)} does not have "
                             f"{n} columns")
        self.partition = partition
        self.impl = impl
        self.a_seed = a_seed
        self.device = matrix.device if mesh is None else mesh.home
        if not lwe.noise_budget_ok(params, partition.width):
            params = lwe.choose_params(partition.width,
                                       q_switch=params.q_switch)
        self.params = params
        self.cfgs: list[pir.PIRConfig] = []
        self.sub_dbs: list[torch.Tensor] = []
        self._a_mats: list[torch.Tensor | None] = []
        heights = bucket_rows(partition, used_bytes, matrix.shape[0])
        self._place(mesh, heights)
        for b, rows in enumerate(heights):
            mem = partition.members[b]
            sub = torch.zeros((rows, partition.width), dtype=torch.uint8,
                              device=self.bucket_device(b))
            if len(mem):
                idx = torch.as_tensor(mem, dtype=torch.int64,
                                      device=matrix.device)
                sub[:, :len(mem)] = matrix[:rows].index_select(1, idx).to(
                    sub.device)
            self.sub_dbs.append(sub)
            self.cfgs.append(pir.PIRConfig(
                m=rows, n=partition.width, params=self.params,
                a_seed=_bucket_a_seed(a_seed, b), impl=impl))
            self._a_mats.append(None)
        self.hints: list[torch.Tensor] = []

    # -- placement -----------------------------------------------------------

    def _place(self, mesh, heights: list[int]) -> None:
        """Each bucket's owner shard (LPT over the bucket heights on a mesh,
        the one device otherwise) and each shard's buckets, in order."""
        self.mesh = mesh
        self._devices = [self.device] if mesh is None else list(mesh.devices)
        shards = len(self._devices)
        order = collectives.balanced_bucket_order(heights, shards)
        per = len(order) // shards
        self.shard_of = [0] * len(heights)
        for slot, b in enumerate(order):
            if b < len(heights):            # not a zero-height pad bucket
                self.shard_of[b] = slot // per
        self._groups = [[b for b in range(len(heights))
                         if self.shard_of[b] == s] for s in range(shards)]
        self._group_idx = [torch.as_tensor(g, dtype=torch.int64,
                                           device=self.device)
                           for g in self._groups]

    def bucket_device(self, bucket: int) -> torch.device:
        """The device bucket b's sub-DB lives on."""
        return self._devices[self.shard_of[bucket]]

    # -- public matrices / hints --------------------------------------------

    def a_matrix(self, bucket: int) -> torch.Tensor:
        """Bucket b's public LWE matrix A_b: (W, k) u32, seed-derived."""
        if self._a_mats[bucket] is None:
            cfg = self.cfgs[bucket]
            self._a_mats[bucket] = lwe.gen_public_matrix(
                cfg.a_seed, cfg.n, cfg.params.k, device=self.device)
        return self._a_mats[bucket]

    def _local_a(self, bucket: int) -> torch.Tensor:
        """A_b on the device of bucket b's sub-DB."""
        return self.a_matrix(bucket).to(self.bucket_device(bucket))

    def _hint(self, bucket: int, sub: torch.Tensor) -> torch.Tensor:
        """H_b = sub·A_b, computed where ``sub`` lives, on the home
        device."""
        with on_device(sub.device):
            hint = ops.hint_gemm(sub, self._local_a(bucket), impl=self.impl)
        return hint.to(self.device)

    def setup(self) -> list[torch.Tensor]:
        """Recompute every bucket hint H_b = D_b·A_b from the current DBs."""
        return [self._hint(b, self.sub_dbs[b])
                for b in range(self.partition.n_buckets)]

    def install_hints(self) -> int:
        """One-time offline hint build; returns total hint bytes."""
        self.hints = self.setup()
        return self.hint_bytes

    @property
    def hint_bytes(self) -> int:
        """One-time hint downlink: Σ_b 4·m_b·k bytes across buckets."""
        return sum(cfg.hint_bytes for cfg in self.cfgs)

    @property
    def downlink_bytes(self) -> int:
        """Response bytes of one batched query (all buckets answer)."""
        return sum(cfg.downlink_bytes for cfg in self.cfgs)

    @property
    def uplink_bytes(self) -> int:
        """Query bytes of one batched query: B ciphertexts of 4·W bytes."""
        return sum(cfg.uplink_bytes for cfg in self.cfgs)

    @property
    def stored_bytes(self) -> int:
        """Total bucketed-DB bytes = what one batched answer streams."""
        return sum(int(d.shape[0]) * int(d.shape[1]) for d in self.sub_dbs)

    # -- online --------------------------------------------------------------

    def answer_batch(self, qs: torch.Tensor) -> list[torch.Tensor]:
        """qs: (B, W) or (B, W, C) int32-held u32 → per-bucket answers,
        modulus-switched when configured.  One bucketed product per shard
        (one in all without a mesh), the answers back in bucket order."""
        one = len(self._groups) == 1           # every bucket, in order
        per_shard = collectives.bucket_shard_gemm(
            [[self.sub_dbs[b] for b in g] for g in self._groups],
            [qs.to(dev) if one else qs.index_select(0, idx).to(dev)
             for idx, dev in zip(self._group_idx, self._devices)],
            impl=self.impl)
        raw: list[torch.Tensor] = [None] * len(self.sub_dbs)
        for group, answers in zip(self._groups, per_shard):
            for b, a in zip(group, answers):
                raw[b] = a.to(self.device)
        if self.params.q_switch is not None:
            raw = [lwe.switch_modulus(a, self.params.q_switch) for a in raw]
        return raw

    # -- live-index deltas ---------------------------------------------------

    def update_columns(self, cols: np.ndarray, new_cols: torch.Tensor,
                       new_used: dict[int, int], *, donate: bool = False
                       ) -> list[BucketUpdate]:
        """Patch every bucket owning a touched cluster; exact mod 2^32.

        cols: (J,) global cluster ids (already re-packed); new_cols: (m, J)
        uint8 at the GLOBAL row height, on the server's device; new_used:
        payload bytes per touched cluster.  Buckets whose row budget still
        fits every new payload take a sparse ΔH_b = ΔD_b[:,P]·A_b[P,:] patch
        (bit-identical to a fresh hint); a bucket that overflows is rebuilt
        and re-hinted alone.
        """
        return self.stage_update_columns(cols, new_cols, new_used,
                                         donate=donate).publish()

    def stage_update_columns(self, cols: np.ndarray, new_cols: torch.Tensor,
                             new_used: dict[int, int], *,
                             donate: bool = False) -> StagedBucketPatch:
        """Queue every bucket's patch WITHOUT publishing (shadow commit).

        ΔH_b is computed from the current sub-DBs; the returned patch's
        `publish()` swaps the pointers.  ``donate=True`` writes the new
        columns into each touched sub-DB itself, deferred to `publish()` so
        an abandoned staged patch leaves the serving sub-DBs untouched; on
        a card that write is queued on the stream that serves reads, after
        every answer enqueued before it.
        """
        cols = np.asarray(cols)
        part = self.partition
        by_bucket: dict[int, list[int]] = {}
        for idx, j in enumerate(cols):
            for b in part.buckets_of(int(j)):
                by_bucket.setdefault(b, []).append(idx)
        updates: list[BucketUpdate] = []
        new_sub_dbs: dict[int, torch.Tensor] = {}
        deferred: list[tuple[int, torch.Tensor, torch.Tensor]] = []
        new_hints: dict[int, torch.Tensor] = {}
        new_cfgs: dict[int, pir.PIRConfig] = {}
        for b, idxs in sorted(by_bucket.items()):
            rows = self.cfgs[b].m
            need = max(new_used[int(cols[i])] for i in idxs)
            if need > rows:
                sub, cfg, hint = self._stage_rebuild_bucket(
                    b, cols, new_cols, new_used)
                new_sub_dbs[b] = sub
                new_cfgs[b] = cfg
                if hint is not None:
                    new_hints[b] = hint
                updates.append(BucketUpdate(bucket=b, rebuilt=True,
                                            cols=np.zeros(0, np.int64)))
                continue
            pos = np.array([part.position(b, int(cols[i])) for i in idxs],
                           np.int64)
            dev = self.bucket_device(b)
            pos_t = torch.from_numpy(pos).to(dev)
            sel = torch.as_tensor(idxs, dtype=torch.int64,
                                  device=new_cols.device)
            new_sub = new_cols[:rows].index_select(1, sel).to(dev)
            delta_h = self._delta(b, pos_t, new_sub)   # reads OLD sub-DB
            if donate:
                deferred.append((b, pos_t, new_sub))
            else:
                new_sub_dbs[b] = ops.scatter_columns(self.sub_dbs[b], pos_t,
                                                     new_sub)
            if self.hints:
                # ΔH_b is transient, so the add writes into ITS buffer; the
                # live hint stays intact for in-flight decode snapshots
                new_hints[b] = ops.add_delta(self.hints[b],
                                             delta_h.to(self.device),
                                             impl=self.impl)
            updates.append(BucketUpdate(bucket=b, rebuilt=False, cols=pos))

        def apply():
            for b, sub in new_sub_dbs.items():
                self.sub_dbs[b] = sub
            for b, pos_t, new_sub in deferred:
                self.sub_dbs[b] = ops.scatter_columns(
                    self.sub_dbs[b], pos_t, new_sub, donate=True)
            for b, cfg in new_cfgs.items():
                self.cfgs[b] = cfg
            for b, hint in new_hints.items():
                self.hints[b] = hint

        return StagedBucketPatch(updates=updates, _apply=apply)

    def _delta(self, bucket: int, pos: torch.Tensor, new_sub: torch.Tensor
               ) -> torch.Tensor:
        """ΔH_b for replacing local columns ``pos`` by ``new_sub``.  The JAX
        twin pads the column count to a power of two with column 0 on both
        sides, which adds exactly 0; the port does not pad."""
        old_sub = self.sub_dbs[bucket].index_select(1, pos)
        a_p = self._local_a(bucket).index_select(0, pos)
        with on_device(old_sub.device):
            return ops.delta_gemm(new_sub, old_sub, a_p, impl=self.impl)

    def _stage_rebuild_bucket(self, bucket: int, cols: np.ndarray,
                              new_cols: torch.Tensor,
                              new_used: dict[int, int]
                              ) -> tuple[torch.Tensor, pir.PIRConfig,
                                         torch.Tensor | None]:
        """Overflow path: re-truncate, re-pack and re-hint ONE bucket.

        Returns the staged (sub_db, cfg, hint-or-None) triple; the caller
        publishes.  A member column's row need is its last nonzero byte + 1
        (1 for an all-zero column), a replaced one's its new payload.
        """
        part = self.partition
        mem = [int(j) for j in part.members[bucket]]
        old = self.sub_dbs[bucket]
        old_rows = old.shape[0]
        # rows up to the last nonzero byte: the first nonzero of the column
        # read bottom-up (argmax returns the first maximum)
        live = (old[:, :len(mem)] != 0).flip(0).to(torch.uint8)
        if old_rows and mem:
            last = (old_rows - live.argmax(dim=0)) * live.amax(dim=0)
            last = last.tolist()
        else:
            last = [0] * len(mem)
        need = {j: max(1, int(last[p])) for p, j in enumerate(mem)}
        replaced = []                       # (local position, column index)
        for idx, j in enumerate(cols):
            j = int(j)
            if j in need:
                need[j] = new_used[j]
                replaced.append((mem.index(j), idx))
        rows = _round_rows(max(need.values(), default=1))
        dev = self.bucket_device(bucket)
        sub = torch.zeros((rows, part.width), dtype=torch.uint8, device=dev)
        take = min(rows, old_rows)
        sub[:take, :len(mem)] = old[:take, :len(mem)]
        if replaced:
            pos = torch.as_tensor([p for p, _ in replaced], dtype=torch.int64,
                                  device=dev)
            src = torch.as_tensor([i for _, i in replaced], dtype=torch.int64,
                                  device=new_cols.device)
            take = min(rows, new_cols.shape[0])
            fresh = torch.zeros((rows, len(replaced)), dtype=torch.uint8,
                                device=dev)
            fresh[:take] = new_cols[:take].index_select(1, src).to(dev)
            sub.index_copy_(1, pos, fresh)
        # A_b depends only on (n, k), so it survives the row-budget change.
        cfg = dataclasses.replace(self.cfgs[bucket], m=rows)
        hint = self._hint(bucket, sub) if self.hints else None
        return sub, cfg, hint
