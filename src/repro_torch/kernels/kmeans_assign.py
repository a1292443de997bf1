"""CUDA fused k-means assignment (twin of ``repro/kernels/kmeans_assign.py``).

The kernel (``csrc/kmeans_assign.cu``) fuses ``|x|² − 2·x·c + |c|²`` into a
running (min, argmin) over centroid tiles held in shared memory, in fp32
FMA with no TF32; strict ``<`` keeps the earliest index on ties.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def kmeans_assign_cuda(x: torch.Tensor, c: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (N, d) f32, c (K, d) f32 on one CUDA device → (assign (N,) i32,
    min_d2 (N,) f32)."""
    if not (x.is_cuda and c.is_cuda) or x.device != c.device:
        raise ValueError("kmeans_assign_cuda needs both operands on one CUDA device")
    if x.dtype != torch.float32 or c.dtype != torch.float32:
        raise TypeError(f"kmeans_assign needs float32, got {x.dtype}, {c.dtype}")
    if x.dim() != 2 or c.dim() != 2 or x.shape[1] != c.shape[1]:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, c {tuple(c.shape)}")
    n, d = x.shape
    k = c.shape[0]
    if k == 0:
        raise ValueError("kmeans_assign needs at least one centroid")
    x = x.contiguous()
    c = c.contiguous()
    assign = torch.empty(n, dtype=torch.int32, device=x.device)
    mind2 = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return assign, mind2
    fn = _build.library("kmeans_assign").kmeans_assign_f32
    code = fn(x.data_ptr(), c.data_ptr(), assign.data_ptr(), mind2.data_ptr(),
              n, k, d, _build.stream_ptr(x.device))
    _build.LAUNCHES["kmeans_assign"] += 1
    _build.check(code, "kmeans_assign")
    return assign, mind2
