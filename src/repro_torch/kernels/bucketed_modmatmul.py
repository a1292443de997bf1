"""CUDA grouped bucketed mod-2^32 product (twin of the Pallas branch of
``repro/kernels/ops.py`` ``bucketed_modmatmul``).

``csrc/bucketed_modmatmul.cu`` computes ``D_b @ Q_b mod 2^32`` for every
batch-PIR bucket in one pass on the u8 limb tile of ``modmatmul_u8``.  A
prep kernel writes every bucket's limb planes into one scratch
(`ref.bucketed_planes`); the persistent tile kernel walks (bucket, band,
column tile) back to back.  The sub-DBs keep their own heights: a table of
per-bucket tensor maps, base pointers, output row offsets and tile offsets,
encoded here on the host and copied to the card, maps each tile to its
bucket, so nothing is padded or stacked and no padded row is read.
`ref.bucketed_modmatmul_limbs_ref` is the same algorithm in int64.  u32
operands are int32 tensors holding the same bits.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import _build, ref


def grouped_product(dbs: Sequence[torch.Tensor], qs: torch.Tensor
                    ) -> tuple[list[torch.Tensor], torch.Tensor, int]:
    """Launch the kernel once: dbs B (m_b, W) uint8, qs (B, W, C) int32-held
    u32, all on one CUDA device → (B (m_b, C) int32-held u32 views of one
    (Σ m_b, C) buffer, the plane scratch the prep wrote, how many non-empty
    buckets the predicated producer read: a base or W off 16 bytes)."""
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
    dbs = [d.contiguous() for d in dbs]     # rows W bytes apart
    n_stacked, bno, b_pad = ref.limb_plan(c)
    planes = torch.empty((n_b * 4 * b_pad, -(-w // 16) * 16),
                         dtype=torch.uint8, device=dev)
    heights = [int(d.shape[0]) for d in dbs]
    row_off = [0]
    for h in heights:
        row_off.append(row_off[-1] + h)
    out = torch.empty((row_off[-1], c), dtype=torch.int32, device=dev)
    views = [out[row_off[b]:row_off[b + 1]] for b in range(n_b)]
    if row_off[-1] == 0 or c == 0:
        return views, planes, 0             # an empty grid is no launch
    lib = _build.library("bucketed_modmatmul")
    tile, n_ct = int(lib.bucketed_modmatmul_tile_rows()), b_pad // bno
    tile_off = [0]
    for h in heights:
        tile_off.append(tile_off[-1] + -(-h // tile) * n_ct)
    info = torch.tensor([[d.data_ptr(), h, row_off[b], tile_off[b]]
                         for b, (d, h) in enumerate(zip(dbs, heights))],
                        dtype=torch.int64)
    host = torch.empty(n_b * int(lib.bucketed_modmatmul_group_bytes()),
                       dtype=torch.uint8, pin_memory=True)
    predicated = lib.bucketed_modmatmul_groups(host.data_ptr(),
                                               info.data_ptr(), n_b, w)
    if predicated < 0:
        _build.check(predicated, "bucketed_modmatmul groups")
    # from pinned memory, asynchronously: the pass waits on nothing queued
    groups = host.to(dev, non_blocking=True)
    code = lib.bucketed_modmatmul_u8(
        groups.data_ptr(), n_b, int(predicated == 0), qs.data_ptr(),
        planes.data_ptr(), out.data_ptr(), row_off[-1], tile_off[-1], w, c,
        n_stacked, _build.stream_ptr(dev))
    _build.LAUNCHES["bucketed_modmatmul"] += 1
    _build.check(code, "bucketed_modmatmul")
    return views, planes, predicated


def bucketed_modmatmul_cuda(dbs: Sequence[torch.Tensor], qs: torch.Tensor
                            ) -> list[torch.Tensor]:
    """Launch the kernel once: dbs B (m_b, W) uint8, qs (B, W, C) int32-held
    u32, all on one CUDA device → B (m_b, C) int32-held u32 tensors (views
    of one (Σ m_b, C) buffer)."""
    return grouped_product(dbs, qs)[0]
