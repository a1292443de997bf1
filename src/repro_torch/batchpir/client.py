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

A serving batch of C clients is formed in two steps: `draw` places each
client's probes and takes its draws (per bucket, the secret's then the
error's, as `query` does), then `encrypt` finishes every draw at once and
runs ONE A_b·S_b per bucket over all C clients.  `decode` runs ONE H_b·S_b
per bucket over the clients placed there and queues the host copy of every
decoded column.  Each column of a stacked product equals its own GEMV, so
ciphertexts and decoded bytes are bitwise the per-client ones for the same
generator state; `query` and `recover` are the batch of one.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._common import sync, to_device, to_host_async, wrap_i32
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
class ClientDraw:
    """One client's placement and raw draws, before encryption (never
    sent): per bucket, the secret's uniform int64 bits (B, k) and the
    error's standard normals (B, W)."""
    placement: dict[int, int]
    secret_bits: torch.Tensor
    noise: torch.Tensor


@dataclasses.dataclass
class DecodedBatch:
    """The decoded real-bucket columns of C clients, queued on the device.

    ``host`` holds every (client, cluster) column back to back at the
    offsets of ``index`` — (client, cluster, offset, rows).  On the card it
    is a pinned copy queued on the stream: read it (through `columns`) only
    once the stream has passed it.
    """
    host: torch.Tensor
    index: list[tuple[int, int, int, int]]
    n_clients: int

    def columns(self) -> list[dict[int, np.ndarray]]:
        """Per client: {cluster: column bytes (m_b,) u8}."""
        buf = self.host.numpy()
        out: list[dict[int, np.ndarray]] = [{} for _ in range(self.n_clients)]
        for c, cluster, ofs, rows in self.index:
            out[c][cluster] = buf[ofs:ofs + rows]
        return out


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

    def draw(self, gen: torch.Generator | None, clusters, *,
             walk_seed: int = 0) -> ClientDraw:
        """Place ``clusters`` (distinct) and take one client's draws: per
        bucket b, in order, the secret's and then the error's (what `query`
        draws).  Nothing is encrypted yet.  Raises PlacementError, before
        any draw, if the probe set is structurally unplaceable (callers fall
        back to the legacy multi-query path).
        """
        part = self.partition
        placement = part.place(clusters, walk_seed=walk_seed)
        bits, noise = [], []
        for b in range(part.n_buckets):
            cfg = self.cfgs[b]
            bits.append(lwe.uniform_bits(gen, (cfg.params.k,)))
            noise.append(lwe.standard_normal(gen, (cfg.n,)))
        return ClientDraw(placement=placement, secret_bits=torch.stack(bits),
                          noise=torch.stack(noise))

    def encrypt(self, draws: list[ClientDraw]
                ) -> tuple[torch.Tensor, list[BatchQueryState]]:
        """Encrypt C drawn clients → ((B, W, C), their states): the draws
        finished in one launch each, then one A_b·S_b per bucket.

        Column c is client c's query, bitwise what `query` gives for the
        same draws.
        """
        sec = wrap_i32(torch.stack([d.secret_bits for d in draws]))
        noise = torch.stack([d.noise for d in draws], dim=2)     # (B, W, C)
        err = torch.stack([lwe.round_error(noise[b], cfg.params.sigma)
                           for b, cfg in enumerate(self.cfgs)])
        states = [BatchQueryState(placement=d.placement, secrets=sec[c])
                  for c, d in enumerate(draws)]
        return self._encrypt(states, sec.permute(1, 2, 0), err), states

    def _encrypt(self, states: list[BatchQueryState], sec: torch.Tensor,
                 err: torch.Tensor) -> torch.Tensor:
        """(B, W, C) ciphertexts for secrets (B, k, C) and errors (B, W, C):
        one A_b·S_b per bucket.  The one-hot selectors are built on the host
        and copied without waiting on the stream."""
        part = self.partition
        n_b, width = part.n_buckets, self.cfgs[0].n
        msg = np.zeros((n_b, width, len(states)), np.int32)
        for c, st in enumerate(states):
            for b, cluster in st.placement.items():
                msg[b, part.position(b, cluster), c] = 1
        msg_t = to_device(msg, self._a_mats[0].device)
        return torch.stack([
            lwe.encrypt_vector(sec[b], self._a_mats[b], msg_t[b],
                               self.cfgs[b].params.delta, err[b],
                               impl=self.cfgs[b].impl)
            for b in range(n_b)])

    def query(self, gen: torch.Generator | None, clusters, *,
              walk_seed: int = 0, secrets: torch.Tensor | None = None,
              errors: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, BatchQueryState]:
        """Encrypt probes for ``clusters`` (distinct) → ((B, W), state).

        `draw` then `encrypt` for a batch of one, unless ``secrets`` (B, k)
        and ``errors`` (B, W) are given (tests inject the JAX package's).
        Raises PlacementError as `draw` does.
        """
        if (secrets is None) != (errors is None):
            raise ValueError("give both secrets and errors, or neither")
        if secrets is None:
            qs, (state,) = self.encrypt([self.draw(gen, clusters,
                                                   walk_seed=walk_seed)])
            return qs[..., 0], state
        dev = self._a_mats[0].device
        state = BatchQueryState(
            placement=self.partition.place(clusters, walk_seed=walk_seed),
            secrets=secrets.to(dev))
        qs = self._encrypt([state], state.secrets[..., None],
                           errors.to(dev)[..., None])
        return qs[..., 0], state

    def draw_rows(self, gen: torch.Generator | None, layout: KeyedLayout,
                  ids, *, walk_seed: int = 0) -> tuple[ClientDraw, tuple]:
        """`draw` for a keyed lookup of table rows ``ids`` (a multiset,
        deduplicated to its distinct id groups) → (draw, the ids)."""
        ids = tuple(int(i) for i in ids)
        groups = layout.groups_of(ids)       # validates every id's range
        return self.draw(gen, groups, walk_seed=walk_seed), ids

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
        drawn, ids = self.draw_rows(gen, layout, ids, walk_seed=walk_seed)
        qs, (base,) = self.encrypt([drawn])
        return qs[..., 0], KeyedQueryState(ids=ids, layout=layout, base=base)

    # -- decode --------------------------------------------------------------

    def decode(self, answers: list[torch.Tensor],
               states: list[BatchQueryState], *,
               hints: list[torch.Tensor] | None = None,
               cfgs: list[pir.PIRConfig] | None = None) -> DecodedBatch:
        """Queue the decode of C clients' REAL buckets: one H_b·S_b per
        bucket over the clients placed there.

        ``answers[b]`` is (m_b, C), column c client c's.  ``hints``/``cfgs``
        override the live per-bucket state.  The decoded columns and their
        host copy are queued on the stream; nothing waits here.
        """
        hints = self.hints if hints is None else hints
        cfgs = self.cfgs if cfgs is None else cfgs
        parts, index, ofs = [], [], 0
        for b in range(self.partition.n_buckets):
            who = [(c, st.placement[b]) for c, st in enumerate(states)
                   if b in st.placement]
            if not who:
                continue
            p = cfgs[b].params
            sec = torch.stack([states[c].secrets[b] for c, _ in who], dim=1)
            ans = (answers[b] if len(who) == answers[b].shape[1] else
                   torch.stack([answers[b][:, c] for c, _ in who], dim=1))
            if p.q_switch is not None:
                vals = lwe.decode_switched(ans, hints[b], sec, p,
                                           impl=cfgs[b].impl)
            else:
                vals = lwe.decode(lwe.hint_strip(ans, hints[b], sec,
                                                 impl=cfgs[b].impl), p)
            rows = vals.shape[0]
            parts.append(vals.to(torch.uint8).T.reshape(-1))
            for c, cluster in who:
                index.append((c, cluster, ofs, rows))
                ofs += rows
        flat = (torch.cat(parts) if parts else torch.zeros(
            0, dtype=torch.uint8, device=self._a_mats[0].device))
        return DecodedBatch(host=to_host_async(flat), index=index,
                            n_clients=len(states))

    def recover(self, answers: list[torch.Tensor], state: BatchQueryState, *,
                hints: list[torch.Tensor] | None = None,
                cfgs: list[pir.PIRConfig] | None = None
                ) -> dict[int, np.ndarray]:
        """Decode REAL buckets only → {cluster: column bytes (m_b,) u8}.

        `decode` for a batch of one, waited for.  ``hints``/``cfgs``
        override the live per-bucket state with a plan-time snapshot.
        """
        decoded = self.decode([a.reshape(-1, 1) for a in answers], [state],
                              hints=hints, cfgs=cfgs)
        sync(self._a_mats[0].device)
        return decoded.columns()[0]

    @staticmethod
    def rows(cols: dict[int, np.ndarray], state: KeyedQueryState
             ) -> np.ndarray:
        """A keyed lookup's rows from its decoded group columns → (κ, d)
        f32, by fixed-stride arithmetic; duplicate ids repeat their row, in
        the caller's order."""
        layout = state.layout
        rows = [layout.decode_row(cols[layout.group_of(i)], i)
                for i in state.ids]
        if not rows:
            return np.zeros((0, layout.dim), np.float32)
        return np.stack(rows)

    def recover_rows(self, answers: list[torch.Tensor],
                     state: KeyedQueryState, *,
                     hints: list[torch.Tensor] | None = None,
                     cfgs: list[pir.PIRConfig] | None = None) -> np.ndarray:
        """Decode a keyed lookup → (κ, d) f32, bit-identical to table[ids]."""
        return self.rows(self.recover(answers, state.base, hints=hints,
                                      cfgs=cfgs), state)

    # -- accounting ----------------------------------------------------------

    def accounting(self, state: BatchQueryState) -> BatchAccounting:
        """Exact per-bucket wire costs of one batched query (summed)."""
        return BatchAccounting(
            uplink_bytes=sum(c.uplink_bytes for c in self.cfgs),
            downlink_bytes=sum(c.downlink_bytes for c in self.cfgs),
            hint_bytes=sum(c.hint_bytes for c in self.cfgs),
            n_buckets=self.partition.n_buckets,
            placed=len(state.placement))
