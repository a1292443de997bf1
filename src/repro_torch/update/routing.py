"""Cluster → bucket routing of live-index deltas into batch-PIR state (twin
of ``repro/update/routing.py``).

The live index patches the flat system hint with ΔH = ΔD[:,J]·A[J,:].  When
batch-PIR is enabled the same mutated columns ALSO live as replicas inside
up to three cuckoo buckets each, every bucket carrying its own hint
H_b = D_b·A_b.  This module routes each touched cluster of a committed
mutation batch to its owning buckets and lets
`BatchPIRServer.stage_update_columns` queue the exact per-bucket sub-DB
swap and sparse hint patch (or a single-bucket rebuild on row-budget
overflow).  `LiveIndex` calls here once per commit, so both hint families
advance in the same epoch.
"""
from __future__ import annotations

import numpy as np
import torch


def touched_buckets(partition, cols) -> list[int]:
    """Sorted bucket ids owning a replica of any touched cluster."""
    out: set[int] = set()
    for j in cols:
        out.update(partition.buckets_of(int(j)))
    return sorted(out)


def patch_batch_hints(system, cols: np.ndarray, new_cols,
                      new_used: dict[int, int]) -> list:
    """Propagate one committed mutation batch into the batch-PIR subsystem.

    No-op (empty list) when batch-PIR isn't enabled.  Otherwise returns the
    per-bucket `BucketUpdate` records (delta-patched or rebuilt).
    """
    staged = stage_batch_hints(system, cols, new_cols, new_used)
    return staged.publish() if staged is not None else []


def stage_batch_hints(system, cols: np.ndarray, new_cols,
                      new_used: dict[int, int], *, donate: bool = False):
    """The staged bucket patches of one commit; the swap is deferred.

    Returns the `StagedBucketPatch` (None when batch-PIR is off); the live
    index's publish step calls its ``publish()`` inside the same pointer
    swap that flips the flat DB and hint.  ``new_cols`` is the (m, J)
    uint8 re-packed columns, numpy or a tensor; they go to the buckets'
    device once.
    """
    bp = getattr(system, "batch", None)
    if bp is None:
        return None
    new_t = torch.as_tensor(new_cols).to(bp.server.device)
    return bp.server.stage_update_columns(np.asarray(cols), new_t, new_used,
                                          donate=donate)


def rebuild_batch(old_system, new_system) -> None:
    """Full-rebuild epochs re-bucketize: cluster contents and column
    geometry may all have changed, so the subsystem is rebuilt on the fresh
    system with the SAME (kappa, n_buckets, seed) knobs the old one used."""
    bp = getattr(old_system, "batch", None)
    if bp is None:
        return
    new_system.enable_batch(kappa=bp.kappa,
                            n_buckets=bp.partition.n_buckets,
                            seed=bp.seed)
