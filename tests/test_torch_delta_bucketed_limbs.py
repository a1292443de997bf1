"""The limb-tile algorithms of the port's ``delta_gemm`` and ``bucketed_modmatmul``
against the JAX package.

`ref.delta_gemm_limbs_ref` computes ΔH the way the card's kernel does: one
product ``[new | old] · [A_J ; (0 − A_J) mod 2^32]``, the left operand packed
(`ref.delta_pack`) or laid out as the kernel's two tensor maps read it, the
right operand's limb planes (`ref.delta_right`, `ref.limb_planes`), u8 × u8
sums over contraction chunks of 32,768 bytes (each asserted below 2^31),
then ``Σ_l sum_l << 8l`` under the mask.  `ref.bucketed_modmatmul_limbs_ref`
runs each bucket on the same arithmetic with its planes taken from the
stacked scratch (`ref.bucketed_planes`).  Both run in int64 on the CPU and
must equal, bitwise, the JAX package's ``ops.delta_gemm`` and
``ops.bucketed_modmatmul`` in Pallas interpret mode and in XLA, and the
port's float64 versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch._common import u32_to_numpy, u32_to_torch
from repro_torch.kernels import ref

CPU = torch.device("cpu")


def _delta_inputs(seed, m, j, k):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (m, j), dtype=np.uint8),
            rng.integers(0, 256, (m, j), dtype=np.uint8),
            rng.integers(0, 2**32, (j, k), dtype=np.uint32))


def _delta_limbs(new, old, a, two_maps):
    return u32_to_numpy(ref.delta_gemm_limbs_ref(
        torch.from_numpy(new), torch.from_numpy(old), u32_to_torch(a, CPU),
        two_maps=two_maps))


def _assert_delta_agrees(new, old, a):
    """Every layout of the kernel (packed; two maps where J % 16 == 0)
    equals JAX's Pallas and XLA delta_gemm and the port's float64 one."""
    jn, jo, ja = jnp.asarray(new), jnp.asarray(old), jnp.asarray(a)
    want = np.asarray(jops.delta_gemm(jn, jo, ja, impl="xla"))
    np.testing.assert_array_equal(
        want, np.asarray(jops.delta_gemm(jn, jo, ja, impl="pallas")))
    np.testing.assert_array_equal(want, u32_to_numpy(ref.delta_gemm_ref(
        torch.from_numpy(new), torch.from_numpy(old), u32_to_torch(a, CPU))))
    layouts = (False, True) if new.shape[1] % 16 == 0 else (False,)
    for two_maps in layouts:
        np.testing.assert_array_equal(_delta_limbs(new, old, a, two_maps),
                                      want)


@pytest.mark.parametrize("j", [1, 51, 64, 65, 256])
@pytest.mark.parametrize("m,k", [(9, 70), (130, 1024)])
def test_delta_limbs_match_jax(j, m, k):
    """J off and on 16 and on and past one 128-byte stage; k = 70 (N = 256,
    two column tiles, the last ragged) and the LWE width 1024."""
    _assert_delta_agrees(*_delta_inputs(7 * j + m + k, m, j, k))


def test_delta_limbs_past_one_contraction_chunk_match_jax():
    """2J = 32,800 > 32,768 at 3 rows: the tile's second chunk is added in
    u32, in both layouts (J % 16 == 0)."""
    j = 16_400
    assert 2 * j > ref.LIMB_CHUNK
    _assert_delta_agrees(*_delta_inputs(j, 3, j, 5))


@pytest.mark.parametrize("new_val,old_val", [(255, 0), (0, 255)])
def test_delta_limbs_special_values_match_jax(new_val, old_val):
    """new − old = ±255 against A_J holding 0, 1, 0x80000000 and
    0xFFFFFFFF, whose negations are 0, 0xFFFFFFFF, 0x80000000 and 1."""
    m, j = 5, 64
    specials = np.array([0, 1, 0x80000000, 0xFFFFFFFF], np.uint32)
    a = np.tile(specials, (j, 3))
    new = np.full((m, j), new_val, np.uint8)
    old = np.full((m, j), old_val, np.uint8)
    _assert_delta_agrees(new, old, a)
    exact = ((new.astype(object) - old.astype(object)) @ a.astype(object)
             ) % (1 << 32)
    np.testing.assert_array_equal(_delta_limbs(new, old, a, False),
                                  exact.astype(np.uint32))


def test_delta_right_negates_in_u32():
    a = np.array([[0, 1, 0x80000000, 0xFFFFFFFF]], np.uint32)
    right = u32_to_numpy(ref.delta_right(u32_to_torch(a, CPU)))
    assert right.shape == (16, 4)
    np.testing.assert_array_equal(right[0], a[0])
    np.testing.assert_array_equal(
        right[1], np.array([0, 0xFFFFFFFF, 0x80000000, 1], np.uint32))
    assert not right[2:].any()


@pytest.mark.parametrize("j,two_maps,split,n", [
    (1, False, 1, 16), (51, False, 51, 112), (64, False, 64, 128),
    (65, False, 65, 144), (256, False, 256, 512), (64, True, 128, 192),
    (256, True, 256, 512), (16_400, True, 16_512, 32_912),
])
def test_delta_layout(j, two_maps, split, n):
    assert ref.delta_layout(j, two_maps) == (split, n)


@pytest.mark.parametrize("two_maps", [False, True])
def test_delta_pack_by_hand(two_maps):
    """new at bytes [0, J), old at [split, split + J), zero elsewhere."""
    new, old, _ = _delta_inputs(3, 4, 32, 1)
    got = ref.delta_pack(torch.from_numpy(new), torch.from_numpy(old),
                         two_maps=two_maps).numpy()
    split, n = ref.delta_layout(32, two_maps)
    want = np.zeros((4, n), np.uint8)
    want[:, :32] = new
    want[:, split:split + 32] = old
    np.testing.assert_array_equal(got, want)


def _bucket_inputs(seed, heights, w, c):
    rng = np.random.default_rng(seed)
    return ([rng.integers(0, 256, (m, w), dtype=np.uint8) for m in heights],
            rng.integers(0, 2**32, (len(heights), w, c), dtype=np.uint32))


@pytest.mark.parametrize("w", [128, 255, 256])
@pytest.mark.parametrize("c", [1, 16, 17])
@pytest.mark.parametrize("heights", [(1, 130, 257), (64, 200)])
def test_bucketed_limbs_match_jax(heights, w, c):
    """Heights off 128 with a one-row bucket; W on and off 16 bytes; C = 1
    (N = 32), 16 (N = 64) and 17 (N = 128)."""
    dbs, qs = _bucket_inputs(sum(heights) + w + c, heights, w, c)
    jd = [jnp.asarray(d) for d in dbs]
    jq = jnp.asarray(qs)
    xla = jops.bucketed_modmatmul(jd, jq, impl="xla")
    pallas = jops.bucketed_modmatmul(jd, jq, impl="pallas")
    td = [torch.from_numpy(d) for d in dbs]
    tq = u32_to_torch(qs, CPU)
    got = ref.bucketed_modmatmul_limbs_ref(td, tq)
    plain = ref.bucketed_modmatmul_ref(td, tq)
    for b in range(len(dbs)):
        want = np.asarray(xla[b])
        np.testing.assert_array_equal(np.asarray(pallas[b]), want)
        np.testing.assert_array_equal(u32_to_numpy(got[b]), want)
        np.testing.assert_array_equal(u32_to_numpy(plain[b]), want)


def test_bucketed_limbs_all_max_match_jax():
    """All-255 sub-DBs against all-0xFFFFFFFF queries: every limb sum at
    its largest for W = 256."""
    dbs = [np.full((m, 256), 255, np.uint8) for m in (3, 129)]
    qs = np.full((2, 256, 5), 0xFFFFFFFF, np.uint32)
    xla = jops.bucketed_modmatmul([jnp.asarray(d) for d in dbs],
                                  jnp.asarray(qs), impl="xla")
    got = ref.bucketed_modmatmul_limbs_ref([torch.from_numpy(d) for d in dbs],
                                           u32_to_torch(qs, CPU))
    for g, want in zip(got, xla):
        np.testing.assert_array_equal(u32_to_numpy(g), np.asarray(want))


@pytest.mark.parametrize("c", [1, 16, 65])
def test_bucketed_planes_stack_each_buckets_limb_planes(c):
    """Bucket b's planes start at row b · 4 b_pad and equal its own
    `limb_planes`."""
    _, qs = _bucket_inputs(c, (1, 1, 1), 33, c)
    tq = u32_to_torch(qs, CPU)
    planes = ref.bucketed_planes(tq)
    rows = 4 * ref.limb_plan(c)[2]
    assert planes.shape == (3 * rows, 48)
    for b in range(3):
        assert torch.equal(planes[b * rows:(b + 1) * rows],
                           ref.limb_planes(tq[b]))
