"""CUDA grouped bucketed mod-2^32 product (twin of the Pallas branch of
``repro/kernels/ops.py`` ``bucketed_modmatmul``).

The kernel (``csrc/bucketed_modmatmul.cu``) computes ``D_b @ Q_b mod 2^32``
for every batch-PIR bucket in one launch.  The sub-DBs keep their own
heights: a device table of base pointers, output row offsets and row-tile
offsets maps each row tile of the grid to its bucket, so nothing is padded
or stacked and no padded row is read.  u32 operands are int32 tensors
holding the same bits.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import _build


def bucketed_modmatmul_cuda(dbs: Sequence[torch.Tensor], qs: torch.Tensor
                            ) -> list[torch.Tensor]:
    """Launch the kernel once: dbs B (m_b, W) uint8, qs (B, W, C) int32-held
    u32, all on one CUDA device → B (m_b, C) int32-held u32 tensors (views
    of one (Σ m_b, C) buffer)."""
    dev = qs.device
    if not qs.is_cuda or any(not d.is_cuda or d.device != dev for d in dbs):
        raise ValueError("bucketed_modmatmul_cuda needs every operand on "
                         "one CUDA device")
    if qs.dtype != torch.int32 or qs.dim() != 3:
        raise TypeError("qs must be a (B, W, C) int32-held u32 tensor")
    n_b, w, c = qs.shape
    if len(dbs) != n_b or n_b == 0:
        raise ValueError(f"{len(dbs)} buckets but qs has leading dim {n_b}")
    for d in dbs:
        if d.dtype != torch.uint8 or d.dim() != 2 or d.shape[1] != w:
            raise ValueError(f"sub-DBs must be (m_b, {w}) uint8, got "
                             f"{tuple(d.shape)} {d.dtype}")
    qs = qs.contiguous()
    # the word-wide loads need 4-byte aligned rows when W % 4 == 0
    dbs = [d if d.is_contiguous() and d.data_ptr() % 4 == 0
           else d.clone(memory_format=torch.contiguous_format) for d in dbs]
    heights = [int(d.shape[0]) for d in dbs]
    row_off = [0]
    for h in heights:
        row_off.append(row_off[-1] + h)
    out = torch.empty((row_off[-1], c), dtype=torch.int32, device=dev)
    views = [out[row_off[b]:row_off[b + 1]] for b in range(n_b)]
    if row_off[-1] == 0 or c == 0:
        return views                      # an empty grid is no launch
    lib = _build.library("bucketed_modmatmul")
    tile = int(lib.bucketed_modmatmul_tile_rows())
    tile_off = [0]
    for h in heights:
        tile_off.append(tile_off[-1] + -(-h // tile))
    # from pinned memory, asynchronously: the pass waits on nothing queued
    table = torch.tensor([d.data_ptr() for d in dbs] + row_off + tile_off,
                         dtype=torch.int64).pin_memory().to(dev,
                                                            non_blocking=True)
    code = lib.bucketed_modmatmul_u8(table.data_ptr(), n_b, qs.data_ptr(),
                                     out.data_ptr(), tile_off[-1], w, c,
                                     _build.stream_ptr(dev))
    _build.LAUNCHES["bucketed_modmatmul"] += 1
    _build.check(code, "bucketed_modmatmul")
    return views
