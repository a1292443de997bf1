"""The port's one-device PIR protocol against ``repro.core.pir``, bitwise.

Same DB, same public seed: the hint must be equal; the same ciphertext must
give the same answer; the same secret must decode to the same column.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lwe as jlwe
from repro.core import pir as jpir
from repro_torch._common import u32_to_numpy, u32_to_torch
from repro_torch.core import pir

CPU = torch.device("cpu")


def _pair(m=192, n=512, q_switch=1 << 16, seed=0):
    jcfg = jpir.make_config(m, n, impl="xla", q_switch=q_switch, a_seed=11)
    tcfg = pir.make_config(m, n, q_switch=q_switch, a_seed=11)
    db = np.random.default_rng(seed).integers(0, jcfg.params.p, (m, n),
                                              dtype=np.uint8)
    jserver = jpir.PIRServer(jcfg, jnp.asarray(db))
    tserver = pir.PIRServer(tcfg, torch.from_numpy(db))
    return db, jcfg, jserver, tcfg, tserver


def _jax_queries(jclient, jcfg, seed, indices):
    """Reference ciphertexts plus the (s, e) each one drew."""
    qus, ss, es = [], [], []
    for j, idx in enumerate(indices):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), j)
        qu, st = jclient.query(key, idx)
        _, k_err = jax.random.split(key)
        qus.append(np.asarray(qu))
        ss.append(np.asarray(st.secret))
        es.append(np.asarray(jlwe.sample_error(k_err, (jcfg.n,),
                                               jcfg.params.sigma)))
    return np.stack(qus, 1), np.stack(ss, 1), np.stack(es, 1)


@pytest.mark.parametrize("q_switch", [None, 1 << 16])
def test_hint_answer_recover_bitwise(q_switch):
    db, jcfg, jserver, tcfg, tserver = _pair(q_switch=q_switch)
    jhint = jserver.setup()
    thint = tserver.setup()
    np.testing.assert_array_equal(u32_to_numpy(thint), np.asarray(jhint))
    np.testing.assert_array_equal(u32_to_numpy(tserver.a_matrix),
                                  np.asarray(jserver.a_matrix))

    jclient = jpir.PIRClient(jcfg, jhint)
    tclient = pir.PIRClient(tcfg, thint)
    idx = [0, 17, 511, 17]
    qus, ss, es = _jax_queries(jclient, jcfg, 5, idx)

    # the port's encryption with the reference's draws injected
    tqs, tss = tclient.query_batch(None, idx, secrets=u32_to_torch(ss, CPU),
                                   errors=u32_to_torch(es, CPU))
    np.testing.assert_array_equal(u32_to_numpy(tqs), qus)

    jans = np.asarray(jserver.answer(jnp.asarray(qus)))
    tans = tserver.answer(tqs)
    if q_switch is None:
        np.testing.assert_array_equal(u32_to_numpy(tans), jans)
    else:
        np.testing.assert_array_equal(tans.numpy(), jans.astype(np.int32))

    want = np.asarray(jclient.recover_batch(jnp.asarray(jans), jnp.asarray(ss)))
    got = tclient.recover_batch(tans, tss).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, db[:, idx])
    for j, i in enumerate(idx):
        st = pir.ClientQueryState(secret=tss[:, j], index=i)
        one = tclient.recover(tans[:, j], st).numpy()
        np.testing.assert_array_equal(one, db[:, i])


def test_single_query_with_own_randomness():
    db, _, _, tcfg, tserver = _pair(m=64, n=128, seed=1)
    client = pir.PIRClient(tcfg, tserver.setup())
    gen = torch.Generator().manual_seed(3)
    for i in (0, 64, 127):
        qu, st = client.query(gen, i)
        assert qu.shape == (128,)
        col = client.recover(tserver.answer(qu), st)
        assert col.dtype == torch.uint8
        np.testing.assert_array_equal(col.numpy(), db[:, i])


def test_same_column_twice_gives_different_ciphertexts():
    _, _, _, tcfg, tserver = _pair(m=32, n=64, seed=2)
    client = pir.PIRClient(tcfg, tserver.setup())
    gen = torch.Generator().manual_seed(0)
    a, _ = client.query(gen, 5)
    b, _ = client.query(gen, 5)
    assert not torch.equal(a, b)


def test_config_accounting_and_checks():
    jcfg = jpir.make_config(1000, 4096, q_switch=1 << 16)
    tcfg = pir.make_config(1000, 4096, q_switch=1 << 16)
    for attr in ("uplink_bytes", "downlink_bytes", "hint_bytes"):
        assert getattr(tcfg, attr) == getattr(jcfg, attr)
    assert tcfg.params.p == jcfg.params.p
    with pytest.raises(ValueError, match="noise budget"):
        pir.PIRConfig(m=8, n=1 << 20, params=pir.lwe.LWEParams(p=256))
    with pytest.raises(ValueError, match="uint8"):
        pir.PIRServer(tcfg, torch.zeros((1000, 4096), dtype=torch.int32))
