"""CUDA sparse hint delta and exact u32 add (twin of the Pallas branch of
``repro/kernels/ops.py`` ``delta_gemm``).

``csrc/delta_gemm.cu`` computes ``ΔH = (new − old) @ A_J mod 2^32`` as ONE
product on the u8 limb tile of ``modmatmul_u8``: ``[new | old] · [A_J ;
(0 − A_J) mod 2^32]``.  A prep kernel writes the limb planes of the stacked
right operand (`ref.delta_right`, `ref.limb_planes`) into a scratch this
wrapper allocates.  The left operand is a pack ``[new | old | 0]``
(`ref.delta_pack`) the same launch writes first, or new and old read in
place by two tensor maps (`packs` chooses).
`ref.delta_gemm_limbs_ref` is the same algorithm in int64 (on the CPU:
torch has no int64 matmul on CUDA).
``add_delta_u32`` folds ΔH into the hint elementwise, writing into ΔH's
buffer.  u32 operands are int32 tensors holding the same bits.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def _same_cuda_device(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError("operands must all lie on one CUDA device")


def _check_cols(new_cols: torch.Tensor, old_cols: torch.Tensor) -> None:
    if new_cols.dtype != torch.uint8 or old_cols.dtype != torch.uint8:
        raise TypeError(f"new/old columns must be uint8, got "
                        f"{new_cols.dtype}, {old_cols.dtype}")
    if new_cols.dim() != 2 or new_cols.shape != old_cols.shape:
        raise ValueError(f"new {tuple(new_cols.shape)} and old "
                         f"{tuple(old_cols.shape)} must be equal (m, J)")


def two_maps(new_cols: torch.Tensor, old_cols: torch.Tensor) -> bool:
    """Whether the kernel can read contiguous new and old in place by two
    tensor maps: J % 16 == 0 and both bases 16-byte aligned."""
    return (new_cols.shape[1] % 16 == 0 and new_cols.data_ptr() % 16 == 0
            and old_cols.data_ptr() % 16 == 0)


def packs(new_cols: torch.Tensor, old_cols: torch.Tensor) -> bool:
    """The layout `delta_product` takes by default: packed where the kernel
    cannot read new and old in place, or where the packed contraction is
    one 128-byte stage (2J <= 128; two maps would make it two), else two
    maps, which skip the pack's pass over new and old."""
    return not two_maps(new_cols, old_cols) or 2 * new_cols.shape[1] <= 128


def delta_product(new_cols: torch.Tensor, old_cols: torch.Tensor,
                  a_j: torch.Tensor, *, pack: bool | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Launch ``delta_gemm_u8``: new, old (m, J) uint8, a_j (J, k)
    int32-held u32, on one CUDA device → (ΔH (m, k) int32-held u32, the
    plane scratch the prep wrote (`ref.limb_planes` of `ref.delta_right`),
    the pack it wrote or None).  ``pack=None`` takes the layout `packs`
    chooses; ``pack=False`` raises where `two_maps` is false."""
    _same_cuda_device(new_cols, old_cols, a_j)
    _check_cols(new_cols, old_cols)
    if a_j.dtype != torch.int32 or a_j.dim() != 2:
        raise TypeError("a_j must be a 2-D int32-held u32 tensor")
    m, j = new_cols.shape
    if a_j.shape[0] != j:
        raise ValueError(f"inner dims differ: ({m}, {j}) @ {tuple(a_j.shape)}")
    k = a_j.shape[1]
    new_cols = new_cols.contiguous()
    old_cols = old_cols.contiguous()
    a_j = a_j.contiguous()
    if pack is None:
        pack = packs(new_cols, old_cols)
    elif not pack and not two_maps(new_cols, old_cols):
        raise ValueError("two maps need J % 16 == 0 and 16-byte aligned "
                         "new and old")
    _, n = ref.delta_layout(j, two_maps=not pack)
    n_stacked, _, b_pad = ref.limb_plan(k)
    dev = new_cols.device
    planes = torch.empty((4 * b_pad, -(-n // 16) * 16), dtype=torch.uint8,
                         device=dev)
    packed = (torch.empty((m, n), dtype=torch.uint8, device=dev) if pack
              else None)
    out = torch.empty((m, k), dtype=torch.int32, device=dev)
    if m == 0 or k == 0:
        return out, planes, packed
    code = _build.library("delta_gemm").delta_gemm_u8(
        new_cols.data_ptr(), old_cols.data_ptr(),
        None if packed is None else packed.data_ptr(), a_j.data_ptr(),
        planes.data_ptr(), out.data_ptr(), m, j, k, n_stacked,
        _build.stream_ptr(dev))
    _build.LAUNCHES["delta_gemm"] += 1
    _build.check(code, "delta_gemm")
    return out, planes, packed


def delta_gemm_cuda(new_cols: torch.Tensor, old_cols: torch.Tensor,
                    a_j: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: new, old (m, J) uint8, a_j (J, k) int32-held u32,
    on one CUDA device → ΔH (m, k) int32-held u32."""
    return delta_product(new_cols, old_cols, a_j)[0]


def pack_cuda(new_cols: torch.Tensor, old_cols: torch.Tensor
              ) -> torch.Tensor:
    """The pack alone, as ``delta_gemm_u8`` writes it (`ref.delta_pack`):
    for timing it apart.  No path calls it, so it counts no launch."""
    _same_cuda_device(new_cols, old_cols)
    _check_cols(new_cols, old_cols)
    new_cols = new_cols.contiguous()
    old_cols = old_cols.contiguous()
    m, j = new_cols.shape
    out = torch.empty((m, ref.delta_layout(j)[1]), dtype=torch.uint8,
                      device=new_cols.device)
    code = _build.library("delta_gemm").delta_pack_u8(
        new_cols.data_ptr(), old_cols.data_ptr(), out.data_ptr(), m, j,
        _build.stream_ptr(new_cols.device))
    _build.check(code, "delta_pack")
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
