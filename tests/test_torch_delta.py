"""The port's live-index kernel dispatch on the CPU against the JAX package's.

`ops.delta_gemm`, `ops.scatter_columns` and `ops.add_delta` take their plain
PyTorch versions on CPU tensors; each is held bitwise against
``repro.kernels.ops`` on the same numpy inputs: the XLA oracle everywhere
and, at one small shape, the Pallas branch in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch._common import u32_to_numpy, u32_to_torch
from repro_torch.kernels import ops, ref

CPU = torch.device("cpu")


def _operands(seed, m, j, k):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (m, j), dtype=np.uint8),
            rng.integers(0, 256, (m, j), dtype=np.uint8),
            rng.integers(0, 2**32, (j, k), dtype=np.uint32))


def _port_delta(new, old, a_j, impl="torch"):
    return u32_to_numpy(ops.delta_gemm(torch.from_numpy(new),
                                       torch.from_numpy(old),
                                       u32_to_torch(a_j, CPU), impl=impl))


def _jax_delta(new, old, a_j, impl="xla"):
    return np.asarray(jops.delta_gemm(jnp.asarray(new), jnp.asarray(old),
                                      jnp.asarray(a_j), impl=impl))


@pytest.mark.parametrize("m,j,k", [
    (1, 1, 1), (37, 1, 64), (100, 7, 33), (257, 51, 129), (129, 64, 256),
])
def test_delta_gemm_matches_xla(m, j, k):
    new, old, a_j = _operands(m * 31 + j * 7 + k, m, j, k)
    np.testing.assert_array_equal(_port_delta(new, old, a_j),
                                  _jax_delta(new, old, a_j))


def test_delta_gemm_matches_pallas_interpret():
    """The TPU branch (two u8 Pallas products, subtracted) at one shape."""
    new, old, a_j = _operands(5, 70, 9, 40)
    np.testing.assert_array_equal(_port_delta(new, old, a_j),
                                  _jax_delta(new, old, a_j, impl="pallas"))


@pytest.mark.parametrize("new_val,old_val", [(255, 0), (0, 255)])
def test_delta_gemm_wraps_both_ways(new_val, old_val):
    """All-255 against all-0 (and back) times all-0xFFFFFFFF A: the largest
    positive and negative differences, every product wrapping."""
    m, j, k = 300, 70, 45
    new = np.full((m, j), new_val, np.uint8)
    old = np.full((m, j), old_val, np.uint8)
    a_j = np.full((j, k), 0xFFFFFFFF, np.uint32)
    got = _port_delta(new, old, a_j)
    np.testing.assert_array_equal(got, _jax_delta(new, old, a_j))
    want = np.uint32((j * (new_val - old_val) * -1) % 2**32)
    assert (got == want).all()


def test_delta_gemm_auto_routes_cpu_to_plain():
    new, old, a_j = _operands(9, 20, 3, 8)
    np.testing.assert_array_equal(_port_delta(new, old, a_j, impl="auto"),
                                  _port_delta(new, old, a_j, impl="torch"))
    with pytest.raises(ValueError, match="CUDA"):
        _port_delta(new, old, a_j, impl="cuda")


@pytest.mark.parametrize("donate", [False, True])
def test_scatter_columns_matches_reference(donate):
    rng = np.random.default_rng(3)
    db = rng.integers(0, 256, (64, 12), dtype=np.uint8)
    cols = np.array([1, 4, 5, 11], np.int64)
    new = rng.integers(0, 256, (64, 4), dtype=np.uint8)
    want = np.asarray(jops.scatter_columns(jnp.asarray(db), jnp.asarray(cols),
                                           jnp.asarray(new), donate=False))
    t_db = torch.from_numpy(db.copy())
    got = ops.scatter_columns(t_db, torch.from_numpy(cols),
                              torch.from_numpy(new), donate=donate)
    np.testing.assert_array_equal(got.numpy(), want)
    # donate writes into the given tensor; otherwise it is left as it was
    assert (got.data_ptr() == t_db.data_ptr()) == donate
    np.testing.assert_array_equal(t_db.numpy(), want if donate else db)


@pytest.mark.parametrize("shape", [(1, 1), (77, 13), (128, 256)])
def test_add_delta_matches_reference(shape):
    rng = np.random.default_rng(shape[0])
    hint = rng.integers(0, 2**32, shape, dtype=np.uint32)
    delta = rng.integers(0, 2**32, shape, dtype=np.uint32)
    delta[0, 0] = 0xFFFFFFFF
    hint[0, 0] = 0xFFFFFFFF                       # wraps
    want = np.asarray(jops.add_delta(jnp.asarray(hint), jnp.asarray(delta)))
    t_hint = u32_to_torch(hint.copy(), CPU)      # (shares the copy's memory)
    t_delta = u32_to_torch(delta.copy(), CPU)
    got = ops.add_delta(t_hint, t_delta)
    np.testing.assert_array_equal(u32_to_numpy(got), want)
    # the sum lands in delta's buffer; the hint is never written
    assert got.data_ptr() == t_delta.data_ptr()
    np.testing.assert_array_equal(u32_to_numpy(t_hint), hint)
    np.testing.assert_array_equal(
        u32_to_numpy(ref.add_delta_ref(u32_to_torch(hint, CPU),
                                       u32_to_torch(delta, CPU))), want)


@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("cols", [[3], [0, 5, 6, 9, 17], list(range(20))])
def test_update_columns_matches_reference(cols, donate):
    """`PIRServer.update_columns`: the same ΔH and DB as the reference's
    (which pads J to a power of two), and hint + ΔH == setup() after."""
    from repro.core import pir as jpir
    from repro_torch.core import pir
    rng = np.random.default_rng(len(cols))
    m, n = 80, 20
    db = rng.integers(0, 256, (m, n), dtype=np.uint8)
    new = rng.integers(0, 256, (m, len(cols)), dtype=np.uint8)
    jserver = jpir.PIRServer(jpir.make_config(m, n, impl="xla", a_seed=5),
                             jnp.asarray(db))
    server = pir.PIRServer(pir.make_config(m, n, a_seed=5),
                           torch.from_numpy(db.copy()))
    hint = server.setup()
    want = np.asarray(jserver.update_columns(jnp.asarray(cols),
                                             jnp.asarray(new)))
    got = server.update_columns(torch.tensor(cols), torch.from_numpy(new),
                                donate=donate)
    np.testing.assert_array_equal(u32_to_numpy(got), want)
    np.testing.assert_array_equal(server.db.numpy(), np.asarray(jserver.db))
    assert torch.equal(ops.add_delta(hint, got), server.setup())
