"""Kernel dispatch (twin of ``repro/kernels/ops.py``).

Every entry takes ``impl``:

  impl="auto"  — the CUDA kernel for CUDA tensors, the plain PyTorch
                 version (`ref`) for CPU tensors
  impl="cuda"  — the CUDA kernel; a CPU tensor raises
  impl="torch" — the plain PyTorch version on whatever device

There is no fallback: a CUDA tensor either launches its kernel or raises.
u32 operands are int32 tensors holding the same bits (see ``_common``).
The kernels mask ragged edges themselves, so nothing here pads.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.kmeans_assign import kmeans_assign_cuda
from repro_torch.kernels.modmatmul import modmatmul_cuda


def _route(impl: str, *tensors: torch.Tensor) -> str:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"operands on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if impl == "auto":
        return "cuda" if dev.type == "cuda" else "torch"
    if impl == "cuda":
        if dev.type != "cuda":
            raise ValueError(f"impl='cuda' needs CUDA tensors, got {dev}")
        return "cuda"
    if impl == "torch":
        return "torch"
    raise ValueError(f"unknown impl {impl!r}")


def _matmul_u32(left: torch.Tensor, right: torch.Tensor, impl: str
                ) -> torch.Tensor:
    if right.dtype != torch.int32:
        raise TypeError(f"right must be int32-held u32, got {right.dtype}")
    was_vec = right.dim() == 1
    r2 = right[:, None] if was_vec else right
    if _route(impl, left, r2) == "cuda":
        out = modmatmul_cuda(left, r2)
    else:
        out = ref.modmatmul_ref(left, r2)
    return out[:, 0] if was_vec else out


def modmatmul(db: torch.Tensor, q: torch.Tensor, *, impl: str = "auto"
              ) -> torch.Tensor:
    """Exact (db @ q) mod 2^32.

    db: (m, n) uint8 (entries < plaintext modulus p ≤ 256).
    q:  (n,) or (n, b) int32-held u32.
    Returns int32-held u32 of shape (m,) or (m, b).
    """
    if db.dtype != torch.uint8:
        raise TypeError(f"db must be uint8, got {db.dtype}")
    return _matmul_u32(db, q, impl)


def hint_gemm(db: torch.Tensor, a_mat: torch.Tensor, *, impl: str = "auto"
              ) -> torch.Tensor:
    """Offline hint H = D · A (mod 2^32); same kernel, k query columns."""
    return modmatmul(db, a_mat, impl=impl)


def mod_u32_matmul(left: torch.Tensor, right: torch.Tensor, *,
                   impl: str = "auto") -> torch.Tensor:
    """Exact (left @ right) mod 2^32 with both operands int32-held u32.

    The LWE products A·S (encryption) and H·S (hint strip), which the JAX
    package leaves to XLA's uint32 matmul.
    """
    if left.dtype != torch.int32:
        raise TypeError(f"left must be int32-held u32, got {left.dtype}")
    return _matmul_u32(left, right, impl)


def kmeans_assign(x: torch.Tensor, c: torch.Tensor, *, impl: str = "auto"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused nearest-centroid assignment: (assign (N,) i32, min_d2 (N,) f32).

    x: (N, d) f32 points; c: (k, d) f32 centroids.  The offline build's
    K-means calls it once per corpus block per Lloyd step
    (`core.clustering._lloyd`).
    """
    if _route(impl, x, c) == "cuda":
        return kmeans_assign_cuda(x, c)
    return ref.kmeans_assign_ref(x, c)


def launch_counts() -> dict[str, int]:
    """Kernel launches per entry since the last `reset_launch_counts`."""
    return dict(_build.LAUNCHES)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for name in _build.LAUNCHES:
        _build.LAUNCHES[name] = 0
