"""The port's threefry PRNG and LWE layer against ``jax.random`` and
``repro.core.lwe``, bitwise.

The public matrix A and the build's ``a_seed`` must equal JAX's bit for bit.
Client secrets and errors are the JAX package's own draws, injected, so every
ciphertext and decode can be compared exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import lwe as jlwe
from repro.core import pipeline as jpipeline
from repro_torch._common import u32_to_numpy, u32_to_torch
from repro_torch.core import lwe, pipeline, threefry

CPU = "cpu"
SEEDS = [0, 1, 7, 2**31 - 1, 2**32 - 1]


def _key(k):
    return tuple(int(v) for v in np.asarray(k).tolist())


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_fold_in_split(seed):
    root = jax.random.PRNGKey(seed)
    assert threefry.PRNGKey(seed) == _key(root)
    for data in (0, 1, 0x5157, 2**32 - 1):
        assert threefry.fold_in(threefry.PRNGKey(seed), data) == _key(
            jax.random.fold_in(root, data))
    for num in (2, 5):
        want = [_key(k) for k in jax.random.split(root, num)]
        assert threefry.split(threefry.PRNGKey(seed), num) == want


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (7,), (5, 13), (3, 4, 2)])
def test_bits(seed, shape):
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape,
                                      dtype=jnp.uint32))
    got = threefry.bits(threefry.PRNGKey(seed), shape, device=CPU)
    np.testing.assert_array_equal(u32_to_numpy(got), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", [(0, 2**31 - 1), (0, 10), (-5, 100),
                                   (3, 3), (-(2**31), 2**31 - 1)])
def test_randint(seed, lo, hi):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.randint(key, (17,), lo, hi))
    got = threefry.randint(threefry.PRNGKey(seed), (17,), lo, hi)
    np.testing.assert_array_equal(got.numpy(), want)
    assert threefry.randint(threefry.PRNGKey(seed), (), lo, hi) == int(
        jax.random.randint(key, (), lo, hi))


@pytest.mark.parametrize("seed,n,k", [(7, 33, 17), (12345, 64, 1024),
                                      (2**31 - 2, 5, 3)])
def test_gen_public_matrix(seed, n, k):
    want = np.asarray(jlwe.gen_public_matrix(seed, n, k))
    got = lwe.gen_public_matrix(seed, n, k, device=CPU)
    np.testing.assert_array_equal(u32_to_numpy(got), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_build_streams(seed):
    k_km, a_seed = jpipeline._derive_build_streams(seed)
    got_km, got_a = pipeline._derive_build_streams(seed)
    assert got_a == a_seed
    assert got_km == _key(k_km)


def test_params_mirror_reference():
    for n in (16, 512, 4096, 65536):
        for qs in (None, 1 << 16):
            want = jlwe.choose_params(n, q_switch=qs)
            got = lwe.choose_params(n, q_switch=qs)
            assert (got.p, got.k, got.delta, got.q_switch) == (
                want.p, want.k, want.delta, want.q_switch)
            assert lwe.noise_bound(got, n) == jlwe.noise_bound(want, n)


def _jax_query(seed, n, params, index):
    """The reference client's (s, e, ct) for one one-hot query."""
    a_mat = jlwe.gen_public_matrix(99, n, params.k)
    k_sec, k_err = jax.random.split(jax.random.PRNGKey(seed))
    s = jlwe.keygen(k_sec, params)
    e = jlwe.sample_error(k_err, (n,), params.sigma)
    msg = jnp.zeros((n,), jnp.uint32).at[index].set(1)
    ct = jlwe.encrypt_vector(k_err, s, a_mat, msg, params.delta, params.sigma)
    return a_mat, msg, np.asarray(s), np.asarray(e), np.asarray(ct)


@pytest.mark.parametrize("index", [0, 5, 63])
def test_encrypt_with_injected_secret_and_error(index):
    params = lwe.LWEParams(k=64)
    a_mat, msg, s, e, ct = _jax_query(index, 64, jlwe.LWEParams(k=64), index)
    got = lwe.encrypt_vector(u32_to_torch(s, CPU), u32_to_torch(a_mat, CPU),
                             u32_to_torch(np.asarray(msg), CPU), params.delta,
                             u32_to_torch(e, CPU))
    np.testing.assert_array_equal(u32_to_numpy(got), ct)


@pytest.mark.parametrize("q_switch", [None, 1 << 16])
def test_strip_switch_and_decode(q_switch):
    """A DB·ct answer decoded through both paths equals the reference."""
    rng = np.random.default_rng(0)
    m, n, k = 48, 64, 64
    jp = jlwe.LWEParams(k=k, q_switch=q_switch)
    tp = lwe.LWEParams(k=k, q_switch=q_switch)
    db = rng.integers(0, jp.p, (m, n), dtype=np.uint8)
    a_mat, _, s, _, ct = _jax_query(3, n, jp, 11)
    hint = np.asarray(jnp.matmul(jnp.asarray(db, jnp.uint32), a_mat))
    ans = np.asarray(jnp.matmul(jnp.asarray(db, jnp.uint32), jnp.asarray(ct)))
    th, ts, ta = (u32_to_torch(hint, CPU), u32_to_torch(s, CPU),
                  u32_to_torch(ans, CPU))
    if q_switch is None:
        rec = jlwe.hint_strip(jnp.asarray(ans), jnp.asarray(hint),
                              jnp.asarray(s))
        got_rec = lwe.hint_strip(ta, th, ts)
        np.testing.assert_array_equal(u32_to_numpy(got_rec), np.asarray(rec))
        want = np.asarray(jlwe.decode(rec, jp))
        got = lwe.decode(got_rec, tp).numpy()
    else:
        sw = np.asarray(jlwe.switch_modulus(jnp.asarray(ans), q_switch))
        got_sw = lwe.switch_modulus(ta, q_switch)
        np.testing.assert_array_equal(got_sw.numpy(), sw.astype(np.int32))
        want = np.asarray(jlwe.decode_switched(jnp.asarray(sw),
                                               jnp.asarray(hint),
                                               jnp.asarray(s), jp))
        got = lwe.decode_switched(got_sw, th, ts, tp).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    np.testing.assert_array_equal(got, db[:, 11])


def test_switch_and_decode_extremes():
    """Values next to 0 and 2^32 round and wrap as the reference does."""
    vals = np.array([0, 1, 2**15 - 1, 2**15, 2**16 - 1, 2**31, 2**32 - 2**15,
                     2**32 - 2**15 - 1, 2**32 - 1], np.uint32)
    for qs in (1 << 8, 1 << 16):
        np.testing.assert_array_equal(
            lwe.switch_modulus(u32_to_torch(vals, CPU), qs).numpy(),
            np.asarray(jlwe.switch_modulus(jnp.asarray(vals), qs)))
    p = lwe.LWEParams()
    np.testing.assert_array_equal(
        lwe.decode(u32_to_torch(vals, CPU), p).numpy(),
        np.asarray(jlwe.decode(jnp.asarray(vals), jlwe.LWEParams())))
