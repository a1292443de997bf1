"""CUDA exact mod-2^32 GEMM (twin of ``repro/kernels/modmatmul.py``).

``csrc/modmatmul.cu`` computes ``C = (L @ R) mod 2^32`` for an R of u32:

* L of uint8 (the answer D·Q, the hints D·A): the TPU kernel's limb
  identity on the int8 tensor cores.  A prep kernel writes R's four u8
  limb planes, stacked and transposed (`ref.limb_planes`), into a scratch
  this wrapper allocates; the product runs ``wgmma`` u8 × u8 → s32 on them
  and recombines ``Σ_l sum_l << 8l`` in registers.  `ref.modmatmul_limbs_ref`
  is the same algorithm in int64 on any device.
* L of u32 (A·S encryption, H·S decode): unsigned 32-bit multiply-add on
  the CUDA cores, whose wraparound is the modulus.

u32 operands are int32 tensors holding the same bits.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def _check(left: torch.Tensor, right: torch.Tensor) -> None:
    if not (left.is_cuda and right.is_cuda) or left.device != right.device:
        raise ValueError("modmatmul_cuda needs both operands on one CUDA device")
    if left.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"left must be uint8 or int32-held u32, got {left.dtype}")
    if right.dtype != torch.int32 or right.dim() != 2 or left.dim() != 2:
        raise TypeError("right must be a 2-D int32-held u32 tensor")
    if left.shape[1] != right.shape[0]:
        raise ValueError(f"inner dims differ: {left.shape} @ {right.shape}")


def limb_product(left: torch.Tensor, right: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``modmatmul_u8``: left (m, n) uint8, right (n, b) int32-held
    u32 on one CUDA device → ((m, b) int32-held product, the limb-plane
    scratch the prep kernel wrote, laid out as `ref.limb_planes`)."""
    _check(left, right)
    if left.dtype != torch.uint8:
        raise TypeError(f"left must be uint8, got {left.dtype}")
    left = left.contiguous()
    right = right.contiguous()
    m, n = left.shape
    b = right.shape[1]
    n_stacked, _, b_pad = ref.limb_plan(b)
    planes = torch.empty((4 * b_pad, -(-n // 16) * 16), dtype=torch.uint8,
                         device=left.device)
    out = torch.empty((m, b), dtype=torch.int32, device=left.device)
    if m == 0 or b == 0:
        return out, planes
    code = _build.library("modmatmul").modmatmul_u8(
        left.data_ptr(), right.data_ptr(), planes.data_ptr(), out.data_ptr(),
        m, n, b, n_stacked, _build.stream_ptr(left.device))
    _build.LAUNCHES["modmatmul_u8"] += 1
    _build.check(code, "modmatmul_u8")
    return out, planes


def u8_producer(left: torch.Tensor) -> str:
    """How `limb_product` fills its ring with ``left``'s bytes: ``"tma"``
    (row stride a multiple of 16 bytes, base 16-byte aligned) or
    ``"predicated"`` (byte loads, the same swizzle); the C entry's own test."""
    left = left.contiguous()
    tma = _build.library("modmatmul").modmatmul_u8_tma(left.data_ptr(),
                                                       left.shape[1])
    return "tma" if tma else "predicated"


def modmatmul_cuda(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: left (m, n) u8 or int32-held u32, right (n, b)
    int32-held u32, both on one CUDA device → (m, b) int32-held.
    """
    _check(left, right)
    if left.dtype == torch.uint8:
        return limb_product(left, right)[0]
    left = left.contiguous()
    right = right.contiguous()
    m, n = left.shape
    b = right.shape[1]
    out = torch.empty((m, b), dtype=torch.int32, device=left.device)
    if m == 0 or b == 0:
        return out
    code = _build.library("modmatmul").modmatmul_u32(
        left.data_ptr(), right.data_ptr(), out.data_ptr(), m, n, b,
        _build.stream_ptr(left.device))
    _build.LAUNCHES["modmatmul_u32"] += 1
    _build.check(code, "modmatmul_u32")
    return out
