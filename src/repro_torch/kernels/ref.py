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


#: contraction chunk of the limb kernel: a u8 x u8 limb sum over it stays
#: below 2^31 (255 * 255 * 32768 < 2^31)
LIMB_CHUNK = 32768


def limb_plan(b: int) -> tuple[int, int, int]:
    """(N, bno, b_pad) of `modmatmul_u8` for b query columns: N stacked
    columns per wgmma tile (32, 64, 128 or 256), bno = N / 4 output columns
    per tile, and b rounded up to whole tiles.  The CUDA wrapper passes N
    to the kernel, so the choice is made here only; bno ≥ 8 keeps the four
    limbs of an output in one thread's accumulator registers."""
    n_stacked = 32 if b <= 8 else 64 if b <= 16 else 128 if b <= 32 else 256
    bno = n_stacked // 4
    return n_stacked, bno, -(-b // bno) * bno


def limb_planes(right: torch.Tensor) -> torch.Tensor:
    """R's four u8 limb planes, stacked and transposed as `modmatmul_u8`'s
    prep kernel writes them: (4 b_pad, n16) uint8 with n16 = 16 ceil(n/16).

    Row ``t·4·bno + l·bno + c`` holds byte l of column ``t·bno + c`` of R
    (zero past b and past n), so each tile of bno output columns is four
    limb blocks of bno stacked columns.  right: (n, b) int32-held u32.
    """
    n, b = right.shape
    _, bno, b_pad = limb_plan(b)
    n16 = -(-n // 16) * 16
    padded = torch.zeros((n16, b_pad), dtype=torch.int64, device=right.device)
    padded[:n, :b] = as_i64(right)
    limbs = torch.stack([(padded >> (8 * l)) & 0xFF for l in range(4)])
    # (l, k, t·bno + c) -> (t, l, c, k)
    planes = limbs.reshape(4, n16, b_pad // bno, bno).permute(2, 0, 3, 1)
    return planes.reshape(4 * b_pad, n16).to(torch.uint8).contiguous()


def _chunked_limb_product(left_u8: torch.Tensor, planes: torch.Tensor,
                          b: int) -> torch.Tensor:
    """The limb tile's arithmetic: u8 rows times stacked u8 planes (laid
    out per `limb_plan`) as int64 sums over contraction chunks of
    `LIMB_CHUNK` bytes, each chunk's sums asserted below 2^31 (the s32
    accumulator's range), then ``Σ_l sum_l << 8l`` and the chunks added
    under the mask → (m, b) int32-held u32."""
    m, n = left_u8.shape
    _, bno, b_pad = limb_plan(b)
    out = torch.zeros((m, b_pad), dtype=torch.int64, device=left_u8.device)
    for k0 in range(0, n, LIMB_CHUNK):
        k1 = min(n, k0 + LIMB_CHUNK)
        sums = left_u8[:, k0:k1].to(torch.int64) @ planes[:, k0:k1].to(
            torch.int64).T
        if sums.numel() and int(sums.max()) >= 1 << 31:
            raise AssertionError("a limb sum left the s32 range")
        sums = sums.reshape(m, b_pad // bno, 4, bno)
        part = sum(sums[:, :, l, :] << (8 * l) for l in range(4))
        out = (out + part.reshape(m, b_pad)) & MASK
    return wrap_i32(out[:, :b])


def modmatmul_limbs_ref(db_u8: torch.Tensor, right: torch.Tensor
                        ) -> torch.Tensor:
    """``(db_u8 @ right) mod 2^32`` the way `modmatmul_u8` computes it: the
    u8 DB times `limb_planes` of R on the limb tile's arithmetic.
    db_u8: (m, n) uint8; right: (n, b) int32-held u32 → (m, b) int32-held
    u32.
    """
    return _chunked_limb_product(db_u8, limb_planes(right), right.shape[1])


def shift_planes(right: torch.Tensor) -> torch.Tensor:
    """R's four shift planes against a u32 left operand read as bytes, as
    `modmatmul_u32`'s prep kernel writes them: (4 b_pad, n16) uint8 with
    n16 = 16 ceil(4k/16).

    Row ``t·4·bno + j·bno + c``, column ``4κ + i`` holds byte ``j − i`` of
    ``R[κ, t·bno + c]`` where i ≤ j, and 0 where i > j, past b or past 4k.
    right: (k, b) int32-held u32.
    """
    k, b = right.shape
    _, bno, b_pad = limb_plan(b)
    n16 = -(-4 * k // 16) * 16
    padded = torch.zeros((k, b_pad), dtype=torch.int64, device=right.device)
    padded[:, :b] = as_i64(right)
    planes = torch.zeros((4, n16, b_pad), dtype=torch.int64,
                         device=right.device)
    for j in range(4):
        for i in range(j + 1):
            planes[j, i:4 * k:4] = (padded >> (8 * (j - i))) & 0xFF
    # (j, 4κ + i, t·bno + c) -> (t, j, c, 4κ + i)
    planes = planes.reshape(4, n16, b_pad // bno, bno).permute(2, 0, 3, 1)
    return planes.reshape(4 * b_pad, n16).to(torch.uint8).contiguous()


def modmatmul_u32_limbs_ref(left_u32: torch.Tensor, right: torch.Tensor
                            ) -> torch.Tensor:
    """``(left_u32 @ right) mod 2^32`` the way `modmatmul_u32` computes it:
    left read as little-endian bytes (m, 4k) times `shift_planes` of R on
    the limb tile's arithmetic, ``Σ_j sum_j << 8j`` (the limb products with
    i + l ≥ 4 vanish mod 2^32).  left_u32: (m, k), right: (k, b), both
    int32-held u32 → (m, b) int32-held u32.
    """
    left_u8 = left_u32.contiguous().view(torch.uint8)
    return _chunked_limb_product(left_u8, shift_planes(right), right.shape[1])


def delta_gemm_ref(new_cols: torch.Tensor, old_cols: torch.Tensor,
                   a_j: torch.Tensor) -> torch.Tensor:
    """Exact ``ΔH = (new − old) @ a_j mod 2^32`` as int32-held u32.

    new_cols, old_cols: (m, J) uint8; a_j: (J, k) int32-held u32.  The
    difference wraps to its mod-2^32 residue in int64, then goes through
    `modmatmul_ref` as a u32 left operand.
    """
    diff = wrap_i32(new_cols.to(torch.int64) - old_cols.to(torch.int64))
    return modmatmul_ref(diff, a_j)


def delta_layout(j: int, two_maps: bool = False) -> tuple[int, int]:
    """(split, n) of `delta_gemm`'s contraction on the limb tile: old's
    first byte and the contraction's bytes.  Packed: old right after new
    (split = J), n = 16 ceil(2J/16).  Two maps (the kernel reads new and old
    in place, J % 16 == 0): old from the first 128-byte stage past new,
    split = 128 ceil(J/128), n = split + J."""
    if two_maps:
        split = -(-j // 128) * 128
        return split, split + j
    return j, -(-2 * j // 16) * 16


def delta_pack(new_cols: torch.Tensor, old_cols: torch.Tensor, *,
               two_maps: bool = False) -> torch.Tensor:
    """The delta product's u8 left operand (m, n): new at bytes [0, J), old
    at [split, split + J), zero elsewhere (`delta_layout`).  Packed, it is
    what the kernel's pack writes; with two maps, what its two tensor maps
    read."""
    m, j = new_cols.shape
    split, n = delta_layout(j, two_maps)
    out = torch.zeros((m, n), dtype=torch.uint8, device=new_cols.device)
    out[:, :j] = new_cols
    out[:, split:split + j] = old_cols
    return out


def delta_right(a_j: torch.Tensor, *, two_maps: bool = False) -> torch.Tensor:
    """The delta product's right operand (n, k) int32-held u32: A_J at rows
    [0, J), (0 − A_J) mod 2^32 at [split, split + J), zero elsewhere."""
    j, k = a_j.shape
    split, n = delta_layout(j, two_maps)
    out = torch.zeros((n, k), dtype=torch.int64, device=a_j.device)
    out[:j] = as_i64(a_j)
    out[split:split + j] = (-as_i64(a_j)) & MASK
    return wrap_i32(out)


def delta_gemm_limbs_ref(new_cols: torch.Tensor, old_cols: torch.Tensor,
                         a_j: torch.Tensor, *, two_maps: bool = False
                         ) -> torch.Tensor:
    """``ΔH = (new − old) @ a_j mod 2^32`` the way `delta_gemm` computes it:
    ``[new | old] · [A_J ; −A_J]`` as one product, `delta_pack` times the
    `limb_planes` of `delta_right` on the limb tile's arithmetic.
    new_cols, old_cols: (m, J) uint8; a_j: (J, k) int32-held u32 → (m, k)
    int32-held u32."""
    return _chunked_limb_product(
        delta_pack(new_cols, old_cols, two_maps=two_maps),
        limb_planes(delta_right(a_j, two_maps=two_maps)), a_j.shape[1])


def bucketed_planes(qs: torch.Tensor) -> torch.Tensor:
    """Every bucket's `limb_planes` stacked as `bucketed_modmatmul`'s prep
    writes them: (B · 4 b_pad, W16) uint8, bucket b's planes from row
    b · 4 b_pad.  qs: (B, W, C) int32-held u32."""
    return torch.cat([limb_planes(q) for q in qs])


def bucketed_modmatmul_limbs_ref(dbs, qs: torch.Tensor) -> list[torch.Tensor]:
    """Per-bucket ``dbs[b] @ qs[b] mod 2^32`` the way `bucketed_modmatmul`
    computes it: each bucket on the limb tile's arithmetic, its planes taken
    from the stacked `bucketed_planes` scratch.  dbs: B (m_b, W) uint8; qs:
    (B, W, C) int32-held u32 → B (m_b, C) int32-held u32 tensors."""
    n_b, _, c = qs.shape
    rows = 4 * limb_plan(c)[2]
    planes = bucketed_planes(qs) if n_b else None
    return [_chunked_limb_product(d, planes[b * rows:(b + 1) * rows], c)
            for b, d in enumerate(dbs)]


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
