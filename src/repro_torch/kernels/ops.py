"""Kernel dispatch (twin of ``repro/kernels/ops.py``).

Every kernel entry takes ``impl``:

  impl="auto"  — the CUDA kernel for CUDA tensors, the plain PyTorch
                 version (`ref`) for CPU tensors
  impl="cuda"  — the CUDA kernel; a CPU tensor raises
  impl="torch" — the plain PyTorch version on whatever device

There is no fallback: a CUDA tensor either launches its kernel or raises.
The products wear `obs.kernel_annotation` (a no-op unless turned on).
`scatter_columns` has no kernel (the JAX package leaves it to XLA too): it
is ``index_copy`` on every device.
u32 operands are int32 tensors holding the same bits (see ``_common``).
The kernels mask ragged edges themselves, so nothing here pads.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.bucketed_modmatmul import bucketed_modmatmul_cuda
from repro_torch.kernels.delta_gemm import add_delta_cuda, delta_gemm_cuda
from repro_torch.kernels.kmeans_assign import kmeans_assign_cuda
from repro_torch.kernels.modmatmul import modmatmul_cuda
from repro_torch.obs.trace import kernel_annotation


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
    route = _route(impl, left, r2)
    with kernel_annotation(f"pirrag.modmatmul.{route}"):
        out = (modmatmul_cuda(left, r2) if route == "cuda"
               else ref.modmatmul_ref(left, r2))
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


def bucketed_modmatmul(dbs: Sequence[torch.Tensor], qs: torch.Tensor, *,
                       impl: str = "auto") -> list[torch.Tensor]:
    """Per-bucket exact ``(D_b @ q_b) mod 2^32``: the batch-PIR server op.

    dbs: B uint8 sub-DBs (m_b, W) sharing one padded width W (heights may
         differ: each bucket is row-truncated to its tallest member).
    qs:  (B, W) or (B, W, C) int32-held u32: one query (or C stacked client
         queries) per bucket.
    Returns B int32-held u32 tensors, (m_b,) or (m_b, C).

    On a card this is ONE pass of the u8 limb tile over every bucket's own
    height (the JAX package's Pallas form pads the buckets to the tallest
    and stacks them); on the CPU, `ref.bucketed_modmatmul_ref`.
    """
    if qs.dtype != torch.int32:
        raise TypeError(f"qs must be int32-held u32, got {qs.dtype}")
    n_b = len(dbs)
    if qs.shape[0] != n_b:
        raise ValueError(f"{n_b} buckets but qs has leading dim {qs.shape[0]}")
    was_vec = qs.dim() == 2
    q3 = qs[:, :, None] if was_vec else qs
    for d in dbs:
        if d.dtype != torch.uint8:
            raise TypeError(f"bucket sub-DBs must be uint8, got {d.dtype}")
        if d.dim() != 2 or d.shape[1] != q3.shape[1]:
            raise ValueError(f"bucket width {tuple(d.shape)} != query width "
                             f"{q3.shape[1]}")
    route = _route(impl, q3, *dbs)
    with kernel_annotation(f"pirrag.bucketed_modmatmul.{route}"):
        out = (bucketed_modmatmul_cuda(dbs, q3) if route == "cuda"
               else ref.bucketed_modmatmul_ref(dbs, q3))
    return [o[:, 0] for o in out] if was_vec else out


def delta_gemm(new_cols: torch.Tensor, old_cols: torch.Tensor,
               a_j: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """Sparse hint delta ΔH = (new − old)·A_J, exact mod 2^32.

    The live-index hot path (`PIRServer.stage_delta`).  new_cols/old_cols:
    (m, J) uint8; a_j: (J, k) int32-held u32 → (m, k) int32-held u32.  On a
    card, one product on the u8 limb tile: ``[new | old] · [A_J ; −A_J]``
    (the TPU's two limb products, subtracted, in one pass).
    """
    if new_cols.dtype != torch.uint8 or old_cols.dtype != torch.uint8:
        raise TypeError(f"new/old columns must be uint8, got "
                        f"{new_cols.dtype}, {old_cols.dtype}")
    if a_j.dtype != torch.int32:
        raise TypeError(f"a_j must be int32-held u32, got {a_j.dtype}")
    route = _route(impl, new_cols, old_cols, a_j)
    with kernel_annotation(f"pirrag.delta_gemm.{route}"):
        if route == "cuda":
            return delta_gemm_cuda(new_cols, old_cols, a_j)
        return ref.delta_gemm_ref(new_cols, old_cols, a_j)


def scatter_columns(db: torch.Tensor, cols: torch.Tensor,
                    new_cols: torch.Tensor, *, donate: bool = False
                    ) -> torch.Tensor:
    """db with columns ``cols`` replaced by ``new_cols``.

    ``donate=False`` returns a fresh tensor and leaves ``db`` as it was.
    ``donate=True`` writes the columns into ``db`` itself (``index_copy_``)
    and returns it: on a card the write is queued on the stream that serves
    reads, so answers enqueued before it still read the old columns.
    cols: (J,) int64 distinct column ids; new_cols: (m, J) uint8.
    """
    cols = cols.to(device=db.device, dtype=torch.int64)
    if donate:
        return db.index_copy_(1, cols, new_cols)
    return db.index_copy(1, cols, new_cols)


def add_delta(hint: torch.Tensor, delta: torch.Tensor, *,
              impl: str = "auto") -> torch.Tensor:
    """hint + delta (exact mod 2^32), written into ``delta``'s buffer.

    ΔH exists only to be folded into the hint, so its buffer becomes the
    patched hint; the hint itself is never written, since in-flight decodes
    may still read it.  Returns ``delta``.  On a card the add is the CUDA
    kernel, with no int64 temporaries the size of the hint.
    """
    if hint.shape != delta.shape:
        raise ValueError(f"shapes differ: {tuple(hint.shape)} vs "
                         f"{tuple(delta.shape)}")
    if _route(impl, hint, delta) == "cuda":
        return add_delta_cuda(hint, delta)
    return delta.copy_(ref.add_delta_ref(hint, delta))


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
