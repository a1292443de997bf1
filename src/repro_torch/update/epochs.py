"""Versioned hint epochs: the client-visible side of the live index.

Twin of ``repro/update/epochs.py``.  Patches, their wire format and CRC are
numpy and byte-identical to the JAX package's; a hint is an int32-held u32
tensor, and `HintPatch.apply` runs its (r, J)·(J, k) product through
`kernels.ops.mod_u32_matmul` (the CUDA kernel on a card).

Every committed mutation batch publishes a new epoch e → e+1 together with a
`HintPatch` that transforms a cached epoch-e hint into the epoch-(e+1) hint
*bit-exactly*.  Two patch kinds:

delta patch (the common case)
    Carries the raw DB column delta `ΔD[:,J]` (int16, entries ∈ [−255, 255])
    truncated to the first `r` rows that can differ (max used length of the
    touched columns).  The client recomputes `ΔH = ΔD·A[J,:]` locally — A is
    public and seed-derived, so it never travels.  Wire size is
    `16 + 4·|J| + 2·r·|J|` bytes vs `4·m·k` for the full hint: the download
    ratio is ≈ |J|·r / (2·k·m), e.g. 5% of 4096 clusters at k=1024 ⇒ ~10⁻²
    of a re-download even before row truncation.

full patch (rebuild epochs)
    Published when the planner triggers a full rebuild (column overflow or
    pad-fraction degradation); carries the fresh hint and the new PIRConfig
    (m and LWE params may change).  Costs `hint_bytes`, same as bootstrap.

All arithmetic is uint32 wraparound (mod 2^32), matching the server's
`PIRServer.update_columns` path, so `patch(H)` equals `server.setup()` on
the rebuilt DB bit-for-bit.

Patch CHAINS (the hint-delivery layer): patches compose.  Two consecutive
delta patches merge into one spanning patch whose delta is
`D_final − D_initial` over the union of their touched columns — still
int16 (both endpoints are u8 databases), and strictly no larger than the
two patches side by side (overlapping columns dedupe).  `EpochLog` built
with ``compact_every=C`` folds every aligned run of C patches into one
compacted segment at publish time, so a client K epochs behind downloads
O(K/C) segments plus a short raw tail instead of K patches — and never
the full `m·k·4`-byte hint unless a rebuild epoch intervened (a full
patch subsumes everything before it).  `chain_since`/`chain_bytes` give
the minimal chain and its exact downlink cost; `HintCache.sync` applies
either representation with bit-identical results.

Publication timing: under the pipelined serving engine a commit is staged
into shadow buffers first (`LiveIndex.stage`) and `EpochLog.publish`
happens inside the pointer swap (`LiveIndex.publish`) — i.e. the epoch
counter, the server buffers and the patch log all advance at the same
instant, which is what lets `check_fresh` remain a plain equality test
with no read locks: a query either sees the old epoch everywhere or the
new epoch everywhere.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from repro_torch._common import u32_to_numpy, u32_to_torch
from repro_torch.core import lwe, pir
from repro_torch.fleet.faults import SITE_CHAIN_CORRUPT
from repro_torch.kernels import ops

_PATCH_HEADER_BYTES = 16   # from_epoch u32 | to_epoch u32 | n_cols u32 | nrows u32


class StaleEpochError(RuntimeError):
    """A query/patch was formed against an epoch the server has moved past."""

    def __init__(self, have: int, want: int):
        super().__init__(f"stale epoch {have}; server is at {want}")
        self.have = have
        self.want = want


class CorruptPatchError(RuntimeError):
    """A downloaded patch failed its integrity checksum and the log offers
    no full-hint fallback (`EpochLog.full_fetch`) to re-sync from."""


@dataclasses.dataclass(frozen=True)
class HintPatch:
    """Transforms the epoch-`from_epoch` hint into the `to_epoch` hint.

    ``crc`` is the wire-integrity checksum over the patch's payload and
    epoch span, computed at publish time (`sealed`); a client verifies it
    at decode time so a corrupt or truncated download is detected instead
    of silently patching the cached hint into garbage.  Unsealed patches
    (``crc=None`` — intermediate compositions, hand-built test patches)
    verify trivially: the checksum protects the DELIVERY path, not
    in-process arithmetic.
    """
    from_epoch: int
    to_epoch: int
    cols: np.ndarray | None = None        # (J,) int64 touched cluster ids
    delta: np.ndarray | None = None       # (r, J) int16: D_new − D_old rows <r
    full_hint: np.ndarray | None = None   # (m, k) u32 — rebuild epochs only
    cfg: pir.PIRConfig | None = None      # new config on rebuild epochs
    crc: int | None = None                # payload checksum (None = unsealed)

    @property
    def is_full(self) -> bool:
        """True for rebuild epochs: the patch carries a whole (m, k) hint."""
        return self.full_hint is not None

    def payload_crc(self) -> int:
        """CRC-32 over the epoch span and payload arrays (wire contents)."""
        hdr = np.asarray([self.from_epoch, self.to_epoch], np.uint32)
        acc = zlib.crc32(hdr.tobytes())
        if self.is_full:
            acc = zlib.crc32(np.ascontiguousarray(self.full_hint).tobytes(),
                             acc)
        else:
            acc = zlib.crc32(np.ascontiguousarray(self.cols).tobytes(), acc)
            acc = zlib.crc32(np.ascontiguousarray(self.delta).tobytes(), acc)
        return acc

    def sealed(self) -> "HintPatch":
        """This patch with its checksum stamped (idempotent)."""
        return dataclasses.replace(self, crc=self.payload_crc())

    def verify(self) -> bool:
        """True iff the payload matches the stamped checksum (or unsealed)."""
        return self.crc is None or self.crc == self.payload_crc()

    @property
    def wire_bytes(self) -> int:
        """Downlink cost of shipping this patch (cf. PIRConfig.hint_bytes)."""
        if self.is_full:
            return _PATCH_HEADER_BYTES + self.full_hint.size * 4
        return (_PATCH_HEADER_BYTES + 4 * len(self.cols)
                + 2 * self.delta.size)

    def apply(self, hint: torch.Tensor, a_mat: torch.Tensor) -> torch.Tensor:
        """hint → patched hint, a new tensor (exact mod 2^32; bit-identical
        to a rebuild).

        hint: (m, k) int32-held u32; a_mat: the client's seed-derived public
        matrix A (n, k) on the same device.
        """
        if self.is_full:
            return u32_to_torch(self.full_hint, hint.device)
        r = self.delta.shape[0]
        dev = hint.device
        # an int32 in [−255, 255] holds the bits of its mod-2^32 residue, so
        # the u32 product below is the exact ring product ΔD·A[J,:]
        d_u32 = torch.from_numpy(self.delta.astype(np.int32)).to(dev)
        a_j = a_mat[torch.from_numpy(np.asarray(self.cols, np.int64)).to(dev)]
        prod = ops.mod_u32_matmul(d_u32, a_j)
        return torch.cat([ops.add_delta(hint[:r], prod), hint[r:]])


def compose_patches(a: HintPatch, b: HintPatch) -> HintPatch:
    """Merge consecutive patches into ONE spanning a.from_epoch→b.to_epoch.

    Exact in every case (all arithmetic lands on the same mod-2^32 residues
    a client applying the two patches in sequence would reach):

      delta ∘ delta — the spanning delta is `D_final − D_initial` over the
          union of touched columns: per-column int32 sum of the two deltas,
          which provably fits int16 again (both endpoints are u8 databases),
          row-truncated to the taller of the two.
      anything ∘ full — the later full patch subsumes the earlier patch.
      full ∘ delta — the delta is folded into the carried hint via the
          public matrix A (seed-derived from the full patch's cfg), i.e.
          exactly `HintPatch.apply` on the server side.
    """
    assert a.to_epoch == b.from_epoch, (a.to_epoch, b.from_epoch)
    if b.is_full:
        # crc is span-dependent: the widened composition must re-seal
        return dataclasses.replace(b, from_epoch=a.from_epoch, crc=None)
    if a.is_full:
        assert a.cfg is not None, "full patch needs cfg to absorb deltas"
        cpu = torch.device("cpu")
        a_mat = lwe.gen_public_matrix(a.cfg.a_seed, a.cfg.n, a.cfg.params.k,
                                      device=cpu)
        hint = u32_to_numpy(b.apply(u32_to_torch(a.full_hint, cpu), a_mat))
        return HintPatch(from_epoch=a.from_epoch, to_epoch=b.to_epoch,
                         full_hint=hint, cfg=a.cfg)
    cols = np.union1d(a.cols, b.cols)
    r = max(a.delta.shape[0], b.delta.shape[0])
    acc = np.zeros((r, len(cols)), np.int32)
    acc[:a.delta.shape[0], np.searchsorted(cols, a.cols)] += a.delta
    acc[:b.delta.shape[0], np.searchsorted(cols, b.cols)] += b.delta
    return HintPatch(from_epoch=a.from_epoch, to_epoch=b.to_epoch,
                     cols=cols, delta=acc.astype(np.int16))


def compact_chain(patches: list[HintPatch]) -> HintPatch:
    """Fold a consecutive patch run into one spanning patch (left fold)."""
    assert patches, "cannot compact an empty chain"
    out = patches[0]
    for p in patches[1:]:
        out = compose_patches(out, p)
    return out


class EpochLog:
    """Server-side publication log: monotone epochs + their patches.

    ``compact_every=C`` turns on periodic compaction: every time the head
    reaches a multiple of C, the just-completed aligned run of C patches is
    folded into one segment.  `chain_since` then hands a catching-up client
    the minimal chain — a short raw prefix up to the next C-boundary,
    whole segments across the middle, and the raw tail — instead of one
    patch per missed epoch.  Raw patches are kept (clients can be stranded
    at any epoch, including mid-segment); `stored_bytes` accounts the
    server-side cost of keeping both representations.
    """

    def __init__(self, compact_every: int | None = None):
        assert compact_every is None or compact_every >= 2, compact_every
        self.epoch = 0
        self.compact_every = compact_every
        self._patches: list[HintPatch] = []
        self._segments: dict[int, HintPatch] = {}   # from_epoch → segment
        # Optional observability handle (repro_torch.obs.Obs); LiveIndex threads
        # its own through so compaction events land in the serving trace.
        self.obs = None
        # Fault-injection hook (an object with ``fire(site)``, as the JAX
        # package's FaultInjector): when set, `download_chain` guards the
        # "update.hint.chain" site and corrupts one patch of the served copy
        # when it fires.
        self.faults = None
        # Full re-sync fallback: callable(from_epoch) -> sealed full
        # HintPatch to the head.  LiveIndex wires this to its serving hint
        # so a client that detects a corrupt chain can recover with one
        # deterministic full download instead of a wrong hint.
        self.full_fetch = None

    def publish(self, patch: HintPatch) -> int:
        """Append the next epoch's patch; returns the new head epoch.

        Patches are SEALED here (integrity checksum stamped) — publication
        is the wire boundary, so everything `chain_since`/`download_chain`
        hands out is client-verifiable.  With compaction enabled, a head
        landing on a ``compact_every`` boundary folds the completed run
        into its segment here — publish time, not sync time — so every
        client downloading that span shares one precomputed segment.
        """
        assert patch.from_epoch == self.epoch, (patch.from_epoch, self.epoch)
        assert patch.to_epoch == self.epoch + 1
        self._patches.append(patch.sealed())
        self.epoch = patch.to_epoch
        c = self.compact_every
        if c and self.epoch % c == 0:
            lo = self.epoch - c
            seg = compact_chain(self._patches[lo:self.epoch]).sealed()
            self._segments[lo] = seg
            if self.obs is not None:
                self.obs.counter("epoch.compactions").inc()
                self.obs.instant("epoch.compact", from_epoch=lo,
                                 to_epoch=self.epoch,
                                 segment_bytes=seg.wire_bytes)
        if self.obs is not None:
            self.obs.gauge("epoch.stored_bytes").set(self.stored_bytes)
        return self.epoch

    def patches_since(self, epoch: int) -> list[HintPatch]:
        """The RAW patch chain a client at `epoch` needs to reach the head.

        A full patch in the chain subsumes everything before it, so only the
        suffix from the last full patch onward is returned.  `chain_since`
        is the compaction-aware variant every client-facing path uses.
        """
        if not 0 <= epoch <= self.epoch:
            raise StaleEpochError(epoch, self.epoch)
        return _subsume_full(self._patches[epoch:])

    def chain_since(self, epoch: int,
                    until: int | None = None) -> list[HintPatch]:
        """The MINIMAL patch chain from `epoch` to `until` (default: head).

        Greedy walk preferring compacted segments: at each epoch take the
        segment starting there if one exists and does not overshoot the
        target, else the raw patch.  A full patch anywhere in the chain
        (rebuild epoch, or a segment that absorbed one) drops everything
        before it.
        """
        goal = self.epoch if until is None else until
        if not 0 <= epoch <= goal <= self.epoch:
            raise StaleEpochError(epoch, self.epoch)
        chain: list[HintPatch] = []
        e = epoch
        while e < goal:
            p = self._segments.get(e)
            if p is None or p.to_epoch > goal:
                p = self._patches[e]
            chain.append(p)
            e = p.to_epoch
        return _subsume_full(chain)

    def chain_bytes(self, epoch: int, until: int | None = None) -> int:
        """Exact downlink bytes of `chain_since(epoch, until)` (0 if fresh)."""
        return sum(p.wire_bytes for p in self.chain_since(epoch, until))

    def download_chain(self, epoch: int,
                       until: int | None = None) -> list[HintPatch]:
        """`chain_since`, as seen over the WIRE (the fault-injectable copy).

        Every client-side sync path downloads through here.  With a fault
        injector armed, the "update.hint.chain" site can corrupt one patch
        of the returned list — a bit flip on a COPY, the log's own storage
        is untouched — which the client's `HintPatch.verify` catches at
        decode time.  Unarmed, this IS `chain_since` (same objects, no
        copies), so the no-fault path stays allocation- and bit-identical.
        """
        chain = self.chain_since(epoch, until)
        if self.faults is not None and chain:
            due = self.faults.fire(SITE_CHAIN_CORRUPT)
            if due:
                i = due[0].device % len(chain)
                chain = list(chain)
                chain[i] = _tampered(chain[i])
                if self.obs is not None:
                    self.obs.counter("fleet.chain_corruptions").inc()
        return chain

    @property
    def stored_bytes(self) -> int:
        """Server-side storage: raw patches plus compacted segments."""
        return (sum(p.wire_bytes for p in self._patches)
                + sum(p.wire_bytes for p in self._segments.values()))

    def check_fresh(self, epoch: int):
        """Raise StaleEpochError unless `epoch` is the published head."""
        if epoch != self.epoch:
            raise StaleEpochError(epoch, self.epoch)


def _tampered(patch: HintPatch) -> HintPatch:
    """A transit-corrupted copy of `patch`: one payload bit flipped, the
    stamped crc kept — exactly what `HintPatch.verify` must catch."""
    if patch.is_full:
        full = np.array(patch.full_hint, copy=True)
        full.flat[0] ^= 1
        return dataclasses.replace(patch, full_hint=full)
    delta = np.array(patch.delta, copy=True)
    delta.flat[0] ^= 1
    return dataclasses.replace(patch, delta=delta)


def _subsume_full(chain: list[HintPatch]) -> list[HintPatch]:
    """Suffix of `chain` from its last full patch onward (whole chain if
    none): a full patch carries the complete hint, so nothing before it
    needs to travel."""
    for i in range(len(chain) - 1, -1, -1):
        if chain[i].is_full:
            return chain[i:]
    return chain


class HintCache:
    """Client-side cached hint with patch-based freshness tracking.

    Accounts every byte the client downloads (`bytes_downloaded`) so the
    freshness cost can be compared against re-fetching `cfg.hint_bytes`.
    """

    def __init__(self, hint: torch.Tensor, cfg: pir.PIRConfig,
                 epoch: int = 0):
        self.hint = hint
        self.cfg = cfg
        self.epoch = epoch
        self.bytes_downloaded = cfg.hint_bytes      # bootstrap download
        self.resyncs = 0          # corrupt-chain recoveries (full downloads)
        self._a_mat = self._public_matrix()

    def _public_matrix(self) -> torch.Tensor:
        return lwe.gen_public_matrix(self.cfg.a_seed, self.cfg.n,
                                     self.cfg.params.k,
                                     device=self.hint.device)

    def apply(self, patch: HintPatch):
        """Patch the cached (m, k) u32 hint one epoch forward (exact)."""
        if patch.from_epoch != self.epoch:
            raise StaleEpochError(self.epoch, patch.from_epoch)
        if patch.is_full and patch.cfg is not None and patch.cfg != self.cfg:
            self.cfg = patch.cfg
            self._a_mat = self._public_matrix()
        self.hint = patch.apply(self.hint, self._a_mat)
        self.epoch = patch.to_epoch
        self.bytes_downloaded += patch.wire_bytes

    def sync(self, log: EpochLog) -> int:
        """Catch up to the log head; returns bytes downloaded for the sync.

        Downloads the MINIMAL chain (`EpochLog.download_chain`): compacted
        segments where the log has them, raw patches elsewhere.  Applying
        the chain is bit-identical to applying every raw patch — and to a
        fresh full-hint download.

        Every patch is checksum-verified BEFORE it touches the cached
        hint; a corrupt or truncated download triggers one deterministic
        full re-sync (the wasted chain bytes AND the full download are
        both charged to `bytes_downloaded` — corruption costs downlink,
        never correctness).
        """
        before = self.bytes_downloaded
        chain = log.download_chain(self.epoch)
        if not all(p.verify() for p in chain):
            self.bytes_downloaded += sum(p.wire_bytes for p in chain)
            self.resyncs += 1
            if log.obs is not None:
                log.obs.counter("fleet.full_resyncs").inc()
            if getattr(log, "full_fetch", None) is None:
                raise CorruptPatchError(
                    f"corrupt patch chain from epoch {self.epoch} and no "
                    "full-hint fallback on the log")
            full = log.full_fetch(self.epoch)
            assert full.is_full and full.verify(), "fallback must be clean"
            self.apply(full)
            return self.bytes_downloaded - before
        for patch in chain:
            if patch.from_epoch != self.epoch and patch.is_full:
                self.epoch = patch.from_epoch   # full patch subsumes the gap
            self.apply(patch)
        return self.bytes_downloaded - before

    def client(self) -> pir.PIRClient:
        """A PIRClient snapshotting this cache's current cfg + hint."""
        return pir.PIRClient(self.cfg, self.hint, a_mat=self._a_mat)
