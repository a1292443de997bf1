"""Plain PyTorch versions of the port's kernels (twin of ``repro/kernels/ref.py``).

They run on any device, so the CPU tests use them and the chip check holds
each CUDA kernel against them on the card.  torch has no integer matmul on
CUDA and no uint32 arithmetic anywhere, so `modmatmul_ref` splits the u32
operands into 16-bit limbs and multiplies in float64: every limb product
sum is an integer below 2^53, hence exact in any summation order, and the
limbs recombine in int64 under ``& MASK``.
"""
from __future__ import annotations

import torch

from repro_torch._common import MASK, as_i64, wrap_i32

#: float64 limb products stay exact while (2^16−1)^2 · n < 2^53.
_MAX_INNER = (1 << 53) // ((1 << 16) - 1) ** 2


def _limbs(x64: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return ((x64 & 0xFFFF).to(torch.float64),
            (x64 >> 16).to(torch.float64))


def modmatmul_ref(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Exact ``(left @ right) mod 2^32`` as int32-held u32.

    left:  (m, n) uint8, or int32-held u32.
    right: (n,) or (n, b) int32-held u32.
    """
    if right.dtype != torch.int32:
        raise TypeError(f"right must be int32-held u32, got {right.dtype}")
    n = left.shape[1]
    if n > _MAX_INNER:
        raise ValueError(f"inner dim {n} exceeds exact float64 range")
    r_lo, r_hi = _limbs(as_i64(right))
    if left.dtype == torch.uint8:
        lf = left.to(torch.float64)
        lo = (lf @ r_lo).long()
        hi = (lf @ r_hi).long() & 0xFFFF
        return wrap_i32(lo + (hi << 16))
    l_lo, l_hi = _limbs(as_i64(left))
    lo = (l_lo @ r_lo).long() & MASK
    # the l_hi·r_hi term is a multiple of 2^32 and vanishes
    mid = ((l_lo @ r_hi).long() + (l_hi @ r_lo).long()) & 0xFFFF
    return wrap_i32(lo + (mid << 16))


def delta_gemm_ref(new_cols: torch.Tensor, old_cols: torch.Tensor,
                   a_j: torch.Tensor) -> torch.Tensor:
    """Exact ``ΔH = (new − old) @ a_j mod 2^32`` as int32-held u32.

    new_cols, old_cols: (m, J) uint8; a_j: (J, k) int32-held u32.  The
    difference wraps to its mod-2^32 residue in int64, then goes through
    `modmatmul_ref` as a u32 left operand.
    """
    diff = wrap_i32(new_cols.to(torch.int64) - old_cols.to(torch.int64))
    return modmatmul_ref(diff, a_j)


def bucketed_modmatmul_ref(dbs, qs: torch.Tensor) -> list[torch.Tensor]:
    """Per-bucket exact ``dbs[b] @ qs[b] mod 2^32``: `modmatmul_ref` on each
    bucket.  dbs: B (m_b, W) uint8; qs: (B, W, C) int32-held u32 → B
    (m_b, C) int32-held u32 tensors."""
    return [modmatmul_ref(d, qs[b]) for b, d in enumerate(dbs)]


def add_delta_ref(hint: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """``hint + delta mod 2^32`` of two int32-held u32 tensors (new tensor)."""
    return wrap_i32(as_i64(hint) + as_i64(delta))


def kmeans_assign_ref(x: torch.Tensor, c: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Unfused nearest-centroid assignment: (assign (N,) i32, min_d2 (N,) f32).

    ``torch.argmin`` returns the first minimal index, like ``jnp.argmin``.
    """
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    c2 = torch.sum(c * c, dim=1)[None, :]
    d2 = x2 - 2.0 * (x @ c.T) + c2
    return torch.argmin(d2, dim=1).to(torch.int32), torch.min(d2, dim=1).values
