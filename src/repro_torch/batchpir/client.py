"""Batch-PIR client: placement, per-bucket encryption, decode (twin of
``repro/batchpir/client.py``).

One batched query is exactly B ciphertexts, one per bucket, always:

  placed buckets  — an LWE-encrypted one-hot selecting the member column
                    where the wanted cluster's replica lives;
  empty buckets   — a DUMMY: an encryption of the all-zero message under a
                    fresh secret.

Under LWE both are pseudorandom u32 vectors, so the server's view does not
depend on κ or on which buckets carry probes.  Dummy answers are discarded
without decryption.  Secrets and errors come from a `torch.Generator` (the
JAX twin folds them from one key per bucket); tests inject the JAX
package's.  Decoding per bucket is the standard SimplePIR recover against
that bucket's hint H_b.  u32 values are int32 tensors holding the same bits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.batchpir.partition import CuckooPartition, KeyedLayout
from repro_torch.batchpir.server import BatchPIRServer
from repro_torch.core import lwe, pir


@dataclasses.dataclass
class BatchQueryState:
    """Client-side secrets + placement for one batched query (never sent)."""
    placement: dict[int, int]            # bucket → cluster (real queries)
    secrets: torch.Tensor                # (B, k) per-bucket LWE secrets


@dataclasses.dataclass
class KeyedQueryState:
    """Client-side state of one keyed row lookup (never sent).

    ``ids`` keeps the requested multiset in caller order (recovery returns
    one row per requested id, duplicates included); ``base`` carries the
    placement of the DISTINCT id groups that went on the wire.
    """
    ids: tuple[int, ...]
    layout: KeyedLayout
    base: BatchQueryState


@dataclasses.dataclass
class BatchAccounting:
    uplink_bytes: int
    downlink_bytes: int
    hint_bytes: int
    n_buckets: int
    placed: int


class BatchPIRClient:
    """Forms batched queries and decodes per-bucket answers."""

    def __init__(self, partition: CuckooPartition,
                 cfgs: list[pir.PIRConfig], hints: list[torch.Tensor], *,
                 a_mats: list[torch.Tensor] | None = None):
        self.partition = partition
        self.cfgs = cfgs
        self.hints = hints                 # shared refs; patched by epochs
        dev = hints[0].device if hints else torch.device("cpu")
        self._a_mats = (a_mats if a_mats is not None else
                        [lwe.gen_public_matrix(c.a_seed, c.n, c.params.k,
                                               device=dev) for c in cfgs])

    @classmethod
    def from_server(cls, server: BatchPIRServer) -> "BatchPIRClient":
        """Client sharing the server's partition, config and hint lists
        (the in-process stand-in for the one-time hint download)."""
        if not server.hints:
            server.install_hints()
        return cls(server.partition, server.cfgs, server.hints,
                   a_mats=[server.a_matrix(b)
                           for b in range(server.partition.n_buckets)])

    # -- query formulation ---------------------------------------------------

    def query(self, gen: torch.Generator | None, clusters, *,
              walk_seed: int = 0, secrets: torch.Tensor | None = None,
              errors: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, BatchQueryState]:
        """Encrypt probes for ``clusters`` (distinct) → ((B, W), state).

        Per bucket b, in order, ``gen`` draws the secret and then the error
        unless ``secrets`` (B, k) and ``errors`` (B, W) are given.  Raises
        PlacementError if the probe set is structurally unplaceable (callers
        fall back to the legacy multi-query path).
        """
        part = self.partition
        placement = part.place(clusters, walk_seed=walk_seed)
        dev = self._a_mats[0].device
        qs, secs = [], []
        for b in range(part.n_buckets):
            cfg = self.cfgs[b]
            p = cfg.params
            s = (secrets[b] if secrets is not None
                 else lwe.keygen(gen, p))
            e = (errors[b] if errors is not None
                 else lwe.sample_error(gen, (cfg.n,), p.sigma))
            msg = torch.zeros((cfg.n,), dtype=torch.int32, device=dev)
            if b in placement:
                msg[part.position(b, placement[b])] = 1
            qs.append(lwe.encrypt_vector(s.to(dev), self._a_mats[b], msg,
                                         p.delta, e.to(dev), impl=cfg.impl))
            secs.append(s.to(dev))
        return torch.stack(qs), BatchQueryState(placement=placement,
                                                secrets=torch.stack(secs))

    def query_rows(self, gen: torch.Generator | None, layout: KeyedLayout,
                   ids, *, walk_seed: int = 0
                   ) -> tuple[torch.Tensor, KeyedQueryState]:
        """Encrypt a keyed lookup for table rows ``ids`` → ((B, W), state).

        ``ids`` is a multiset: it dedups to distinct id groups before cuckoo
        placement, and `recover_rows` fans shared group columns back out to
        every requesting id.  The wire view is the document path's: always B
        ciphertexts of the shared width.  Raises PlacementError when the
        distinct group set is structurally unplaceable.
        """
        ids = [int(i) for i in ids]
        groups = layout.groups_of(ids)       # validates every id's range
        qs, base = self.query(gen, groups, walk_seed=walk_seed)
        return qs, KeyedQueryState(ids=tuple(ids), layout=layout, base=base)

    # -- decode --------------------------------------------------------------

    def recover(self, answers: list[torch.Tensor], state: BatchQueryState, *,
                hints: list[torch.Tensor] | None = None,
                cfgs: list[pir.PIRConfig] | None = None
                ) -> dict[int, np.ndarray]:
        """Decode REAL buckets only → {cluster: column bytes (m_b,) u8}.

        ``hints``/``cfgs`` override the live per-bucket state with a
        plan-time snapshot: a batch planned before an epoch commit decodes
        against the hints it was formed with.
        """
        hints = self.hints if hints is None else hints
        cfgs = self.cfgs if cfgs is None else cfgs
        out: dict[int, np.ndarray] = {}
        for b, cluster in state.placement.items():
            p = cfgs[b].params
            s = state.secrets[b]
            if p.q_switch is not None:
                vals = lwe.decode_switched(answers[b], hints[b], s, p,
                                           impl=cfgs[b].impl)
            else:
                vals = lwe.decode(lwe.hint_strip(answers[b], hints[b], s,
                                                 impl=cfgs[b].impl), p)
            out[cluster] = vals.to(torch.uint8).cpu().numpy()
        return out

    def recover_rows(self, answers: list[torch.Tensor],
                     state: KeyedQueryState, *,
                     hints: list[torch.Tensor] | None = None,
                     cfgs: list[pir.PIRConfig] | None = None) -> np.ndarray:
        """Decode a keyed lookup → (κ, d) f32, bit-identical to table[ids].

        Decodes each placed group's column once, then extracts every
        requested row by fixed-stride arithmetic; duplicate ids repeat
        their row, in the caller's order.
        """
        cols = self.recover(answers, state.base, hints=hints, cfgs=cfgs)
        layout = state.layout
        rows = [layout.decode_row(cols[layout.group_of(i)], i)
                for i in state.ids]
        if not rows:
            return np.zeros((0, layout.dim), np.float32)
        return np.stack(rows)

    # -- accounting ----------------------------------------------------------

    def accounting(self, state: BatchQueryState) -> BatchAccounting:
        """Exact per-bucket wire costs of one batched query (summed)."""
        return BatchAccounting(
            uplink_bytes=sum(c.uplink_bytes for c in self.cfgs),
            downlink_bytes=sum(c.downlink_bytes for c in self.cfgs),
            hint_bytes=sum(c.hint_bytes for c in self.cfgs),
            n_buckets=self.partition.n_buckets,
            placed=len(state.placement))
