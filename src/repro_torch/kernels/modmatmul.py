"""CUDA exact mod-2^32 GEMM (twin of ``repro/kernels/modmatmul.py``).

``csrc/modmatmul.cu`` computes ``C = (L @ R) mod 2^32`` for an R of u32:

* L of uint8 (the answer D·Q, the hints D·A): the TPU kernel's limb
  identity on the int8 tensor cores.  A prep kernel writes R's four u8
  limb planes, stacked and transposed (`ref.limb_planes`), into a scratch
  this wrapper allocates; the product runs ``wgmma`` u8 × u8 → s32 on them
  and recombines ``Σ_l sum_l << 8l`` in registers.  `ref.modmatmul_limbs_ref`
  is the same algorithm in int64 on any device.
* L of u32 (A·S encryption, H·S decode): the same limb tile.  L read as
  bytes is a u8 matrix (m, 4k); a prep kernel writes R's four shift planes
  (`ref.shift_planes`: byte j − i of each word at limb i ≤ j of plane j)
  into the scratch, and the same ``wgmma`` kernel forms ``Σ_j sum_j << 8j``.
  `ref.modmatmul_u32_limbs_ref` is that algorithm in int64.

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


def _launch(entry: str, left_u8: torch.Tensor, right: torch.Tensor, n: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Allocate the product and the plane scratch (one row of left's bytes
    wide, padded to 16), launch ``entry`` (n: its contraction in left's own
    elements) and count one launch."""
    right = right.contiguous()
    m, width = left_u8.shape
    b = right.shape[1]
    n_stacked, _, b_pad = ref.limb_plan(b)
    planes = torch.empty((4 * b_pad, -(-width // 16) * 16),
                         dtype=torch.uint8, device=left_u8.device)
    out = torch.empty((m, b), dtype=torch.int32, device=left_u8.device)
    if m == 0 or b == 0:
        return out, planes
    code = getattr(_build.library("modmatmul"), entry)(
        left_u8.data_ptr(), right.data_ptr(), planes.data_ptr(),
        out.data_ptr(), m, n, b, n_stacked, _build.stream_ptr(left_u8.device))
    _build.LAUNCHES[entry] += 1
    _build.check(code, entry)
    return out, planes


def limb_product(left: torch.Tensor, right: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``modmatmul_u8``: left (m, n) uint8, right (n, b) int32-held
    u32 on one CUDA device → ((m, b) int32-held product, the limb-plane
    scratch the prep kernel wrote, laid out as `ref.limb_planes`)."""
    _check(left, right)
    if left.dtype != torch.uint8:
        raise TypeError(f"left must be uint8, got {left.dtype}")
    left = left.contiguous()
    return _launch("modmatmul_u8", left, right, left.shape[1])


def shift_product(left: torch.Tensor, right: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``modmatmul_u32``: left (m, k) and right (k, b), both
    int32-held u32 on one CUDA device → ((m, b) int32-held product, the
    shift-plane scratch the prep kernel wrote, laid out as
    `ref.shift_planes`).  The kernel reads left as u8 (m, 4k)."""
    _check(left, right)
    if left.dtype != torch.int32:
        raise TypeError(f"left must be int32-held u32, got {left.dtype}")
    return _launch("modmatmul_u32", left.contiguous().view(torch.uint8),
                   right, left.shape[1])


def u8_producer(left: torch.Tensor) -> str:
    """How the limb kernel fills its ring with ``left``'s bytes (a u32 left
    is read as u8, 4 bytes a word): ``"tma"`` (row stride a multiple of 16
    bytes, base 16-byte aligned) or ``"predicated"`` (byte loads, the same
    swizzle); the C entry's own test."""
    left = left.contiguous()
    if left.dtype == torch.int32:
        left = left.view(torch.uint8)
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
    return shift_product(left, right)[0]
