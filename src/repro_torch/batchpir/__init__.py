"""Batch-PIR subsystem: κ private cluster fetches in one database pass
(twin of ``repro/batchpir``).

  partition — public 3-way cuckoo bucketization of the cluster axis
  server    — per-bucket replica sub-DBs + hints, one-pass batched answer
  client    — cuckoo placement, per-bucket one-hot/dummy encryption, decode

`BatchPIR` bundles the three for in-process use.  Enable it on a built
system with `PirRagSystem.enable_batch()`; ``multi_probe > 1`` queries then
route through it.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch._common import sync
from repro_torch.batchpir.client import (BatchAccounting, BatchPIRClient,
                                         BatchQueryState, KeyedQueryState)
from repro_torch.batchpir.partition import (CuckooPartition, KeyedLayout,
                                            PlacementError)
from repro_torch.batchpir.server import (BatchPIRServer, BucketUpdate,
                                         StagedBucketPatch)

__all__ = [
    "BatchAccounting", "BatchPIR", "BatchPIRClient", "BatchPIRServer",
    "BatchQueryState", "BucketUpdate", "CuckooPartition", "KeyedLayout",
    "KeyedQueryState", "PlacementError", "StagedBucketPatch", "build",
]


@dataclasses.dataclass
class BatchPIR:
    """The assembled subsystem plus the knobs needed to rebuild it."""
    partition: CuckooPartition
    server: BatchPIRServer
    client: BatchPIRClient
    kappa: int                  # max probes the geometry was sized for
    seed: int
    setup_seconds: float


def build(matrix: torch.Tensor, used_bytes: np.ndarray, params, *,
          kappa: int = 8, n_buckets: int | None = None, seed: int = 101,
          a_seed: int = 7, impl: str = "auto", mesh=None) -> BatchPIR:
    """Bucketize a chunk-transposed DB and hint every bucket (offline).

    ``matrix`` is the (m, n) uint8 DB on the device the buckets live on
    (a system's ``server.db``); the sub-DBs are gathered from it there.
    With ``mesh=`` the buckets spread over the mesh's shards (`matrix`
    may then be a host tensor) and the answers stay bitwise the same.
    """
    t0 = time.perf_counter()
    n_buckets = n_buckets if n_buckets is not None else 3 * kappa
    part = CuckooPartition.build(matrix.shape[1], n_buckets, seed)
    server = BatchPIRServer(matrix, used_bytes, part, params,
                            a_seed=a_seed, impl=impl, mesh=mesh)
    server.install_hints()
    client = BatchPIRClient.from_server(server)
    sync(server.device)
    return BatchPIR(partition=part, server=server, client=client,
                    kappa=kappa, seed=seed,
                    setup_seconds=time.perf_counter() - t0)
