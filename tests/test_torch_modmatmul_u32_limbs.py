"""The u32 × u32 algorithm of the port's ``modmatmul_u32`` against the JAX package.

`ref.modmatmul_u32_limbs_ref` computes ``(H @ S) mod 2^32`` the way the
card's kernel does: H read as little-endian bytes (m, 4k), times the four
shift planes its prep kernel writes (`ref.shift_planes`), u8 × u8 sums over
contraction chunks of 32,768 bytes (each asserted below 2^31), then
``Σ_j sum_j << 8j`` under the mask.  Here it runs in int64 on the CPU and
must equal, bitwise, the JAX package's uint32 ``jnp.matmul`` as
``repro/core/lwe.py`` computes A·s and H·s, and the port's float64 version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lwe as jlwe
from repro_torch._common import u32_to_numpy, u32_to_torch
from repro_torch.kernels import ref

CPU = torch.device("cpu")


def _inputs(seed, m, k, b):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2**32, (m, k), dtype=np.uint32),
            rng.integers(0, 2**32, (k, b), dtype=np.uint32))


def _limbs(h, s):
    return u32_to_numpy(ref.modmatmul_u32_limbs_ref(u32_to_torch(h, CPU),
                                                    u32_to_torch(s, CPU)))


def _assert_all_agree(h, s):
    got = _limbs(h, s)
    # lwe.py's products: jnp.matmul of two uint32 arrays, exact mod 2^32
    np.testing.assert_array_equal(
        got, np.asarray(jnp.matmul(jnp.asarray(h), jnp.asarray(s))))
    np.testing.assert_array_equal(got, u32_to_numpy(ref.modmatmul_ref(
        u32_to_torch(h, CPU), u32_to_torch(s, CPU))))
    return got


@pytest.mark.parametrize("k", [1, 3, 1025])
@pytest.mark.parametrize("b", [1, 8, 9, 63, 65, 257])
def test_u32_limbs_match_jax_matmul(b, k):
    """Every stacked width (b = 1, 8 → N = 32; 9 → 64; 63, 65, 257 → 256
    with one to five column tiles) and 4k off the 16-byte row stride."""
    _assert_all_agree(*_inputs(11 * b + k, 7, k, b))


def test_u32_limbs_wraparound_match_jax():
    """All-0xFFFFFFFF operands: every limb and shift plane at 255."""
    h = np.full((5, 1100), 2**32 - 1, np.uint32)
    s = np.full((1100, 70), 2**32 - 1, np.uint32)
    got = _assert_all_agree(h, s)
    exact = (h.astype(object) @ s.astype(object)) % (1 << 32)
    np.testing.assert_array_equal(got, exact.astype(np.uint32))


@pytest.mark.parametrize("b", [1, 3])
def test_u32_limbs_cross_a_contraction_chunk(b):
    """k = 8,193 words: 4k = 32,772 bytes, past one chunk of 32,768."""
    k = 8_193
    assert 4 * k > ref.LIMB_CHUNK
    _assert_all_agree(*_inputs(k + b, 4, k, b))
    h = np.full((3, k), 2**32 - 1, np.uint32)
    s = np.full((k, b), 2**32 - 1, np.uint32)
    _assert_all_agree(h, s)


def test_u32_limbs_equal_lwe_encrypt_and_hint_strip():
    """Through the JAX package's own functions: ``hint_strip(0, H, s)`` is
    −H·s and ``encrypt_vector``'s mask is A·s (lwe.py)."""
    h, s = _inputs(5, 300, 1024, 1)
    got = _limbs(h, s)[:, 0]
    strip = np.asarray(jlwe.hint_strip(jnp.zeros(300, jnp.uint32),
                                       jnp.asarray(h), jnp.asarray(s[:, 0])))
    np.testing.assert_array_equal((-got.astype(np.int64)) % (1 << 32),
                                  strip.astype(np.int64))
    a_mat, sv = _inputs(6, 256, 1024, 1)
    mask = np.asarray(jnp.matmul(jnp.asarray(a_mat),
                                 jnp.asarray(sv[:, 0]).astype(jnp.uint32)))
    np.testing.assert_array_equal(_limbs(a_mat, sv)[:, 0], mask)


@pytest.mark.parametrize("k,b", [(1, 1), (3, 9), (5, 65), (4, 8)])
def test_shift_planes_by_definition(k, b):
    """Row t·4·bno + j·bno + c, column 4κ + i is byte j − i of R[κ, t·bno
    + c] for i ≤ j and 0 for i > j; rows past b and columns past 4k are 0."""
    s = np.random.default_rng(k * b).integers(0, 2**32, (k, b),
                                              dtype=np.uint32)
    planes = ref.shift_planes(u32_to_torch(s, CPU)).numpy()
    _, bno, b_pad = ref.limb_plan(b)
    n16 = -(-4 * k // 16) * 16
    assert planes.shape == (4 * b_pad, n16)
    for row in range(4 * b_pad):
        t, rest = divmod(row, 4 * bno)
        j, c = divmod(rest, bno)
        col = t * bno + c
        for byte in range(n16):
            kappa, i = divmod(byte, 4)
            want = 0
            if col < b and kappa < k and i <= j:
                want = (int(s[kappa, col]) >> (8 * (j - i))) & 0xFF
            assert planes[row, byte] == want, (row, byte)


def test_u32_limb_sum_guard_trips_when_a_chunk_is_too_long(monkeypatch):
    """With one chunk over 4k = 40,000 bytes of all-max operands a limb sum
    passes 2^31, and the emulation's guard trips."""
    monkeypatch.setattr(ref, "LIMB_CHUNK", 40_000)
    h = torch.full((2, 10_000), -1, dtype=torch.int32)
    s = torch.full((10_000, 1), -1, dtype=torch.int32)
    with pytest.raises(AssertionError, match="s32"):
        ref.modmatmul_u32_limbs_ref(h, s)
