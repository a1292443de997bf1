"""The u8 limb algorithm of the port's ``modmatmul_u8`` against the JAX package.

`ref.modmatmul_limbs_ref` computes ``(D @ R) mod 2^32`` the way the card's
kernel does: the stacked, transposed u8 limb planes its prep kernel writes
(`ref.limb_planes`), u8 × u8 sums over contraction chunks of 32,768 (each
limb sum asserted below 2^31, the range of the kernel's s32 accumulator),
then ``Σ_l sum_l << 8l`` under the mask.  Here it runs in int64 on the CPU
and must equal, bitwise, the JAX package's `modmatmul` in Pallas interpret
mode and in XLA, the JAX plain reference and the port's float64 version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch._common import u32_to_numpy, u32_to_torch
from repro_torch.kernels import ref

CPU = torch.device("cpu")


def _inputs(seed, m, n, b):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (m, n), dtype=np.uint8),
            rng.integers(0, 2**32, (n, b), dtype=np.uint32))


def _limbs(db, q):
    return u32_to_numpy(ref.modmatmul_limbs_ref(torch.from_numpy(db),
                                                u32_to_torch(q, CPU)))


def _assert_all_agree(db, q):
    got = _limbs(db, q)
    jd, jq = jnp.asarray(db), jnp.asarray(q)
    np.testing.assert_array_equal(
        got, np.asarray(jops.modmatmul(jd, jq, impl="pallas")))
    np.testing.assert_array_equal(
        got, np.asarray(jops.modmatmul(jd, jq, impl="xla")))
    np.testing.assert_array_equal(got, np.asarray(jref.modmatmul_ref(jd, jq)))
    np.testing.assert_array_equal(got, u32_to_numpy(ref.modmatmul_ref(
        torch.from_numpy(db), u32_to_torch(q, CPU))))


@pytest.mark.parametrize("n", [1, 300, 513, 4096])
@pytest.mark.parametrize("b", [1, 3, 63, 64, 65, 257])
def test_limbs_match_jax_modmatmul(b, n):
    """Every stacked width (b = 1, 3 → N = 32; 63-65, 257 → N = 256 with
    one to five column tiles) and n off the 16-byte row stride and on it."""
    _assert_all_agree(*_inputs(7 * b + n, 9, n, b))


def test_limb_sums_past_two_to_the_31_match_jax():
    """All-255 D times all-0xFFFFFFFF R at n = 33,100: a single limb sum
    would be 255·255·33,100 ≥ 2^31, so the chunking carries the result."""
    n = 33_100
    assert 255 * 255 * n >= 2**31 > 255 * 255 * ref.LIMB_CHUNK
    db = np.full((5, n), 255, np.uint8)
    q = np.full((n, 3), 2**32 - 1, np.uint32)
    _assert_all_agree(db, q)
    exact = (db.astype(object) @ q.astype(object)) % (1 << 32)
    np.testing.assert_array_equal(_limbs(db, q), exact.astype(np.uint32))


def test_limbs_two_chunks_seeded_match_jax():
    """Random operands over two contraction chunks (n = 33,100)."""
    _assert_all_agree(*_inputs(33_100, 6, 33_100, 5))


def test_limb_sum_guard_trips_when_a_chunk_is_too_long(monkeypatch):
    """The emulation holds its chunk sums to the s32 range: with one chunk
    over the whole of n = 33,100 the all-max case must trip the guard."""
    monkeypatch.setattr(ref, "LIMB_CHUNK", 40_000)
    db = torch.full((2, 33_100), 255, dtype=torch.uint8)
    q = torch.full((33_100, 1), -1, dtype=torch.int32)
    with pytest.raises(AssertionError, match="s32"):
        ref.modmatmul_limbs_ref(db, q)


@pytest.mark.parametrize("b,n_stacked,b_pad", [
    (1, 32, 8), (8, 32, 8), (9, 64, 16), (16, 64, 16), (17, 128, 32),
    (32, 128, 32), (33, 256, 64), (64, 256, 64), (65, 256, 128),
    (1024, 256, 1024),
])
def test_limb_plan(b, n_stacked, b_pad):
    assert ref.limb_plan(b) == (n_stacked, n_stacked // 4, b_pad)


@pytest.mark.parametrize("n,b", [(3, 9), (5, 65)])
def test_limb_planes_stacked_order_by_hand(n, b):
    """Row t·4·bno + l·bno + c of the planes is byte l of R's column
    t·bno + c; rows past b and columns past n are zero."""
    q = np.random.default_rng(n * b).integers(0, 2**32, (n, b),
                                              dtype=np.uint32)
    planes = ref.limb_planes(u32_to_torch(q, CPU)).numpy()
    _, bno, b_pad = ref.limb_plan(b)
    want = np.zeros((4 * b_pad, 16), np.uint8)
    for col in range(b):
        t, c = divmod(col, bno)
        for l in range(4):
            for k in range(n):
                want[t * 4 * bno + l * bno + c, k] = (int(q[k, col]) >> (8 * l)) & 0xFF
    np.testing.assert_array_equal(planes, want)
