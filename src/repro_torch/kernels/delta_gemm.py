"""CUDA sparse hint delta and exact u32 add (twin of the Pallas branch of
``repro/kernels/ops.py`` ``delta_gemm``).

The kernel (``csrc/delta_gemm.cu``) computes ``ΔH = (new − old) @ A_J mod
2^32`` in one pass: it forms the u8 difference in registers and multiplies
it by A_J with unsigned 32-bit multiply-add.  ``add_delta_u32`` folds ΔH
into the hint elementwise, writing into ΔH's buffer.  u32 operands are
int32 tensors holding the same bits.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _same_cuda_device(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError("operands must all lie on one CUDA device")


def delta_gemm_cuda(new_cols: torch.Tensor, old_cols: torch.Tensor,
                    a_j: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: new, old (m, J) uint8, a_j (J, k) int32-held u32,
    on one CUDA device → ΔH (m, k) int32-held u32."""
    _same_cuda_device(new_cols, old_cols, a_j)
    if new_cols.dtype != torch.uint8 or old_cols.dtype != torch.uint8:
        raise TypeError(f"new/old columns must be uint8, got "
                        f"{new_cols.dtype}, {old_cols.dtype}")
    if a_j.dtype != torch.int32 or a_j.dim() != 2:
        raise TypeError("a_j must be a 2-D int32-held u32 tensor")
    if new_cols.dim() != 2 or new_cols.shape != old_cols.shape:
        raise ValueError(f"new {tuple(new_cols.shape)} and old "
                         f"{tuple(old_cols.shape)} must be equal (m, J)")
    m, j = new_cols.shape
    if a_j.shape[0] != j:
        raise ValueError(f"inner dims differ: ({m}, {j}) @ {tuple(a_j.shape)}")
    k = a_j.shape[1]
    new_cols = new_cols.contiguous()
    old_cols = old_cols.contiguous()
    a_j = a_j.contiguous()
    out = torch.empty((m, k), dtype=torch.int32, device=new_cols.device)
    if m == 0 or k == 0:
        return out
    fn = _build.library("delta_gemm").delta_gemm_u8
    code = fn(new_cols.data_ptr(), old_cols.data_ptr(), a_j.data_ptr(),
              out.data_ptr(), m, j, k, _build.stream_ptr(new_cols.device))
    _build.LAUNCHES["delta_gemm"] += 1
    _build.check(code, "delta_gemm")
    return out


def add_delta_cuda(hint: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """``delta ← hint + delta`` (mod 2^32) in place; returns ``delta``.

    Both int32-held u32, the same shape, contiguous, on one CUDA device.
    """
    _same_cuda_device(hint, delta)
    if hint.dtype != torch.int32 or delta.dtype != torch.int32:
        raise TypeError(f"add_delta needs int32-held u32, got {hint.dtype}, "
                        f"{delta.dtype}")
    if hint.shape != delta.shape:
        raise ValueError(f"shapes differ: {tuple(hint.shape)} vs "
                         f"{tuple(delta.shape)}")
    if not (hint.is_contiguous() and delta.is_contiguous()):
        raise ValueError("add_delta needs contiguous operands (it writes "
                         "into delta's own buffer)")
    if delta.numel() == 0:
        return delta
    fn = _build.library("delta_gemm").add_delta_u32
    code = fn(hint.data_ptr(), delta.data_ptr(), delta.numel(),
              _build.stream_ptr(delta.device))
    _build.LAUNCHES["add_delta"] += 1
    _build.check(code, "add_delta")
    return delta
