"""The port's kernel dispatch on the CPU against the JAX package's kernels.

On CPU tensors `repro_torch.kernels.ops` takes the plain PyTorch versions
(`repro_torch.kernels.ref`); they are held here against the JAX package's
Pallas kernels (interpret mode) and its XLA oracle.  Integer products must
match bitwise; k-means assignments exactly, distances within 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch._common import u32_to_numpy, u32_to_torch
from repro_torch.kernels import ops, ref

CPU = torch.device("cpu")


def _db_q(seed, m, n, b):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (m, n), dtype=np.uint8),
            rng.integers(0, 2**32, (n, b), dtype=np.uint32))


@pytest.mark.parametrize("m,n,b", [
    (100, 300, 1), (257, 513, 3), (31, 1025, 129), (256, 512, 128),
])
def test_modmatmul_u8_matches_pallas_and_xla(m, n, b):
    db, q = _db_q(m + n + b, m, n, b)
    got = u32_to_numpy(ops.modmatmul(torch.from_numpy(db), u32_to_torch(q, CPU)))
    pallas = np.asarray(jops.modmatmul(jnp.asarray(db), jnp.asarray(q),
                                       impl="pallas"))
    xla = np.asarray(jops.modmatmul(jnp.asarray(db), jnp.asarray(q), impl="xla"))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, xla)


def test_modmatmul_vector_query():
    db, q = _db_q(3, 77, 90, 1)
    got = ops.modmatmul(torch.from_numpy(db), u32_to_torch(q[:, 0], CPU))
    assert got.shape == (77,)
    want = np.asarray(jops.modmatmul(jnp.asarray(db), jnp.asarray(q[:, 0]),
                                     impl="xla"))
    np.testing.assert_array_equal(u32_to_numpy(got), want)


@pytest.mark.parametrize("m,n,b", [(1, 1, 1), (50, 1024, 7), (129, 300, 64)])
def test_mod_u32_matmul_matches_xla(m, n, b):
    """The u32×u32 product (A·S, H·S) against XLA's wrapping uint32 matmul."""
    rng = np.random.default_rng(m * n + b)
    left = rng.integers(0, 2**32, (m, n), dtype=np.uint32)
    right = rng.integers(0, 2**32, (n, b), dtype=np.uint32)
    got = ops.mod_u32_matmul(u32_to_torch(left, CPU), u32_to_torch(right, CPU))
    want = np.asarray(jref.modmatmul_ref(jnp.asarray(left), jnp.asarray(right)))
    np.testing.assert_array_equal(u32_to_numpy(got), want)


@pytest.mark.parametrize("left", ["u8", "u32"])
def test_modmatmul_wraparound_extremes(left):
    """All-max operands stress every carry of the limb recombination."""
    m, n, b = 64, 1100, 9
    lhs = (np.full((m, n), 255, np.uint8) if left == "u8"
           else np.full((m, n), 2**32 - 1, np.uint32))
    rhs = np.full((n, b), 2**32 - 1, np.uint32)
    lt = torch.from_numpy(lhs) if left == "u8" else u32_to_torch(lhs, CPU)
    got = u32_to_numpy(ops._matmul_u32(lt, u32_to_torch(rhs, CPU), "auto"))
    want = np.asarray(jref.modmatmul_ref(jnp.asarray(lhs), jnp.asarray(rhs)))
    np.testing.assert_array_equal(got, want)
    exact = (lhs.astype(object) @ rhs.astype(object)) % (1 << 32)
    np.testing.assert_array_equal(got, exact.astype(np.uint32))


def test_hint_gemm_is_modmatmul():
    db, a = _db_q(4, 40, 60, 33)
    dbt, at = torch.from_numpy(db), u32_to_torch(a, CPU)
    assert torch.equal(ops.hint_gemm(dbt, at), ops.modmatmul(dbt, at))


def _xc(seed, n, k, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((k, d)).astype(np.float32))


def _check_assign(x, c, **pallas_kw):
    got_a, got_d = ops.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c))
    want_a, want_d = jops.kmeans_assign(jnp.asarray(x), jnp.asarray(c),
                                        impl="pallas", **pallas_kw)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                               rtol=1e-5, atol=1e-5)
    return got_a.numpy()


@pytest.mark.parametrize("n,k,d", [
    (256, 512, 64), (300, 700, 96), (64, 8, 32), (129, 65, 768),
])
def test_kmeans_assign_matches_pallas(n, k, d):
    _check_assign(*_xc(n + k + d, n, k, d))


def test_kmeans_assign_ragged_k_never_picks_padding():
    """K=5 pads to a 512-wide tile in the Pallas kernel; the port masks."""
    got = _check_assign(*_xc(1, 128, 5, 16), block=(128, 512))
    assert got.max() < 5


def test_kmeans_assign_earliest_index_on_ties():
    x = np.random.default_rng(2).standard_normal((64, 8)).astype(np.float32)
    c0 = np.random.default_rng(3).standard_normal((4, 8)).astype(np.float32)
    got = _check_assign(x, np.concatenate([c0, c0]), block=(64, 4))
    assert got.max() < 4


def test_kmeans_assign_ref_is_the_plain_formula():
    x, c = _xc(5, 200, 16, 32)
    a, d = ref.kmeans_assign_ref(torch.from_numpy(x), torch.from_numpy(c))
    ja, jd = jref.kmeans_assign_ref(jnp.asarray(x), jnp.asarray(c))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)


def test_cuda_impl_on_cpu_tensor_raises():
    db, q = _db_q(6, 8, 8, 2)
    x, c = _xc(6, 8, 3, 4)
    with pytest.raises(ValueError, match="cuda"):
        ops.modmatmul(torch.from_numpy(db), u32_to_torch(q, CPU), impl="cuda")
    with pytest.raises(ValueError, match="cuda"):
        ops.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c), impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c), impl="xla")


def test_cpu_path_does_not_count_launches():
    ops.reset_launch_counts()
    db, q = _db_q(7, 8, 8, 2)
    ops.modmatmul(torch.from_numpy(db), u32_to_torch(q, CPU))
    assert set(ops.launch_counts()) == {"modmatmul_u8", "modmatmul_u32",
                                        "kmeans_assign", "delta_gemm",
                                        "add_delta", "bucketed_modmatmul"}
    assert all(v == 0 for v in ops.launch_counts().values())
