"""Shard-local building blocks of the sharded PIR path (twin of the PIR part
of ``repro/distributed/collectives.py``).

The JAX package runs these under ``shard_map``; the port runs them from one
process over a `launch.mesh.DeviceMesh`: each shard is a tensor on its own
device, and each function launches every shard's kernel on that device's
current stream, one shard after another, with no host synchronisation
between them.  The only cross-device copies are the replicated operand
going in (`replicate`) and the results coming out (`gather`).

  * ``row_shard_gemm`` — the row-sharded answer and hint, D_s·Q mod 2^32
    through `ops.modmatmul`, with the modulus switch shard-local.  The
    contraction (cluster) axis is never split, so every shard's rows are
    final: zero collectives.
  * ``row_shard_delta_gemm`` / ``row_shard_scatter`` — a live-index column
    swap: each shard patches its own hint rows (`ops.delta_gemm`) and its
    own DB rows.
  * ``bucket_shard_gemm`` — batch PIR with whole buckets spread over the
    shards: one grouped `ops.bucketed_modmatmul` per shard over its own
    ragged list of buckets (the JAX package multiplies a zero-padded stack
    of buckets in XLA instead), placed by ``balanced_bucket_order``.

The sharded offline build (k-means over row shards, the balanced-assign
distances) lives in `core.clustering`, which uses `replicate`, `gather` and
`place_rows` from here.

Every function takes and returns lists of per-shard tensors in shard order.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch._common import on_device
from repro_torch.core import lwe
from repro_torch.kernels import ops


def replicate(t: torch.Tensor, devices: Sequence[torch.device]
              ) -> list[torch.Tensor]:
    """``t`` on each of ``devices``: one copy per distinct device, shared by
    the shards that live there (none where ``t`` already is)."""
    copies: dict[torch.device, torch.Tensor] = {}
    out = []
    for d in devices:
        if d not in copies:
            copies[d] = t.to(d)
        out.append(copies[d])
    return out


def gather(parts: Sequence[torch.Tensor], device: torch.device
           ) -> torch.Tensor:
    """The shards' row blocks concatenated in shard order on ``device``."""
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([p.to(device) for p in parts])


def place_rows(x, devices: Sequence[torch.device]) -> list[torch.Tensor]:
    """``x`` ((rows, ...) numpy array or tensor, rows a multiple of the
    shard count) split into equal row slices, slice s placed on
    ``devices[s]``: no device receives more than its own rows."""
    n = len(devices)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} shards")
    rows = x.shape[0] // n
    out = []
    for s, dev in enumerate(devices):
        part = x[s * rows:(s + 1) * rows]
        if isinstance(part, np.ndarray):
            part = torch.from_numpy(np.ascontiguousarray(part))
        out.append(part.to(dev))
    return out


def row_shard_gemm(shards: Sequence[torch.Tensor], q: torch.Tensor, *,
                   impl: str = "auto", q_switch: int | None = None
                   ) -> list[torch.Tensor]:
    """D_s·q mod 2^32 for every row shard D_s ((rows_s, n) uint8); q: (n,)
    or (n, b) int32-held u32, replicated.  With ``q_switch`` each shard's
    answer leaves modulus-switched.  Returns each shard's rows on its
    device."""
    out = []
    for d, qq in zip(shards, replicate(q, [s.device for s in shards])):
        with on_device(d.device):
            ans = ops.modmatmul(d, qq, impl=impl)
            if q_switch is not None:
                ans = lwe.switch_modulus(ans, q_switch)
        out.append(ans)
    return out


def row_shard_delta_gemm(new_shards: Sequence[torch.Tensor],
                         old_shards: Sequence[torch.Tensor],
                         a_j: torch.Tensor, *, impl: str = "auto"
                         ) -> list[torch.Tensor]:
    """Each shard's rows of ΔH = (new − old)·A_J mod 2^32; new/old: the
    shard's (rows_s, J) uint8 columns, a_j: (J, k) replicated."""
    out = []
    for new, old, a in zip(new_shards, old_shards,
                           replicate(a_j, [s.device for s in new_shards])):
        with on_device(new.device):
            out.append(ops.delta_gemm(new, old, a, impl=impl))
    return out


def row_shard_scatter(shards: Sequence[torch.Tensor], cols: torch.Tensor,
                      new_shards: Sequence[torch.Tensor], *,
                      donate: bool = False) -> list[torch.Tensor]:
    """Each shard with columns ``cols`` replaced by its rows of the new
    columns (`ops.scatter_columns`; ``donate=True`` writes in place)."""
    return [ops.scatter_columns(d, cols, new, donate=donate)
            for d, new in zip(shards, new_shards)]


def bucket_shard_gemm(dbs_by_shard: Sequence[Sequence[torch.Tensor]],
                      qs_by_shard: Sequence[torch.Tensor], *,
                      impl: str = "auto") -> list[list[torch.Tensor]]:
    """Per shard, one grouped product over the buckets it owns: shard s's
    (m_b, W) uint8 sub-DBs against its (B_s, W, C) int32-held queries, on
    its device.  A shard that owns no bucket launches nothing."""
    out = []
    for dbs, qs in zip(dbs_by_shard, qs_by_shard):
        if not dbs:
            out.append([])
            continue
        with on_device(qs.device):
            out.append(ops.bucketed_modmatmul(list(dbs), qs, impl=impl))
    return out


def balanced_bucket_order(heights, n_shards: int) -> np.ndarray:
    """LPT bucket → shard packing; returns a device-major permutation.

    The bucket count pads up to a multiple of ``n_shards`` with zero-height
    virtual buckets (indices ≥ len(heights)); buckets then go longest first
    to the least-loaded shard with room, each shard taking exactly
    B'/n_shards of them.  Slice s of the result is shard s's buckets.  Ties
    break by (height desc, bucket index asc) and by the lowest shard id.
    """
    h = np.asarray(heights, np.int64)
    b_pad = (-len(h)) % n_shards
    if b_pad:
        h = np.concatenate([h, np.zeros(b_pad, np.int64)])
    cap = len(h) // n_shards
    by_h = np.lexsort((np.arange(len(h)), -h))      # height desc, index asc
    loads = np.zeros(n_shards, np.int64)
    counts = np.zeros(n_shards, np.int64)
    slots: list[list[int]] = [[] for _ in range(n_shards)]
    for b in by_h:
        open_devs = np.nonzero(counts < cap)[0]
        dev = int(open_devs[np.argmin(loads[open_devs])])
        slots[dev].append(int(b))
        loads[dev] += h[b]
        counts[dev] += 1
    return np.concatenate([np.asarray(s, np.int64) for s in slots])


def shard_row_loads(heights, n_shards: int, order=None) -> np.ndarray:
    """Per-shard useful-row totals of a bucket layout: the sequential one
    with ``order=None``, else the one ``order`` (`balanced_bucket_order`)
    gives.  Its max/mean is the imbalance of the layout."""
    h = np.asarray(heights, np.int64)
    b_pad = (-len(h)) % n_shards
    if b_pad:
        h = np.concatenate([h, np.zeros(b_pad, np.int64)])
    if order is not None:
        h = h[np.asarray(order)]
    return h.reshape(n_shards, -1).sum(axis=1)
