"""Shadow-epoch commits for the pipelined engine (twin of
``repro/serve/epochs.py``).

The synchronous loop folds a mutation batch into an epoch between two
query batches.  The pipelined engine drives the same commit through the
two phases `update.live.LiveIndex` exposes:

stage (shadow)
    The batch is planned, the touched columns are re-packed, and ΔH, the
    patched hint and the per-bucket patches are queued on the device into
    fresh buffers.  Batches already dispatched keep reading the live
    epoch's tensors: they hold their own references to them.

publish (swap)
    The pointer swap (and the in-place column write into the flat DB and
    the bucket sub-DBs) plus the epoch-log append.
    This is the only instant at which a freshly formed query can go stale.

On a row-sharded index (``mesh=``) the shadow buffers are per shard: ΔH
is staged shard by shard and gathered on the client's device, and publish
writes each shard's new columns into its live tensor, on its device, in
the same swap.

Every device write of both phases is queued on the one current stream, so
a donated column write lands after the answer products of every batch
dispatched before it, and before those of every batch dispatched after.
Hints are never written in place: a retiring hint stays alive exactly as
long as some in-flight batch still holds it.
"""
from __future__ import annotations

import time
from collections import deque


class ShadowCommitter:
    """Runs LiveIndex commits in stage/publish form for a serving engine.

    Stages with ``donate=True``: the new DB and sub-DB columns are written
    into the live tensors at publish instead of copied.  Accounts stage and
    swap seconds (host clock) apart.
    """

    def __init__(self, live):
        if live is None:
            raise ValueError("shadow commits need a LiveIndex")
        self.live = live
        self.commits = 0
        self.stage_seconds = 0.0     # shadow-patch compute (overlappable)
        self.swap_seconds = 0.0      # pointer swaps (the stale window)

    def commit(self, mutations: deque):
        """Drain `mutations` into the journal and commit them as one epoch.

        Returns the published HintPatch, or None if nothing was pending.
        A batch can already sit in the journal with the deque empty when a
        previous attempt failed after draining (an injected commit fault),
        so the journal's pending batch is part of the guard.
        """
        if not mutations and not self.live.journal.pending():
            return None
        while mutations:
            self.live.journal.append(mutations.popleft())
        t0 = time.perf_counter()
        staged = self.live.stage(donate=True)
        if staged is None:
            return None
        t1 = time.perf_counter()
        patch = self.live.publish(staged)
        t2 = time.perf_counter()
        self.commits += 1
        self.stage_seconds += t1 - t0
        self.swap_seconds += t2 - t1
        return patch
