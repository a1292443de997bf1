"""CUDA exact mod-2^32 GEMM (twin of ``repro/kernels/modmatmul.py``).

The kernel (``csrc/modmatmul.cu``) computes ``C = (L @ R) mod 2^32`` for an
L of uint8 (DB·Q answers, DB·A hint) or u32 (A·S encryption, H·S decode)
and an R of u32, with unsigned 32-bit multiply-add whose wraparound is the
modulus.  u32 operands are int32 tensors holding the same bits.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def modmatmul_cuda(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: left (m, n) u8 or int32-held u32, right (n, b)
    int32-held u32, both contiguous on one CUDA device → (m, b) int32-held.
    """
    if not (left.is_cuda and right.is_cuda) or left.device != right.device:
        raise ValueError("modmatmul_cuda needs both operands on one CUDA device")
    if left.dtype == torch.uint8:
        entry = "modmatmul_u8"
    elif left.dtype == torch.int32:
        entry = "modmatmul_u32"
    else:
        raise TypeError(f"left must be uint8 or int32-held u32, got {left.dtype}")
    if right.dtype != torch.int32 or right.dim() != 2 or left.dim() != 2:
        raise TypeError("right must be a 2-D int32-held u32 tensor")
    m, n = left.shape
    n2, b = right.shape
    if n != n2:
        raise ValueError(f"inner dims differ: {left.shape} @ {right.shape}")
    left = left.contiguous()
    right = right.contiguous()
    out = torch.empty((m, b), dtype=torch.int32, device=left.device)
    if m == 0 or b == 0:
        return out
    fn = getattr(_build.library("modmatmul"), entry)
    code = fn(left.data_ptr(), right.data_ptr(), out.data_ptr(), m, n, b,
              _build.stream_ptr(left.device))
    _build.LAUNCHES[entry] += 1
    _build.check(code, entry)
    return out
