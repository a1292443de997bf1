"""The port's hint epochs against the JAX package's, on the same patches.

A seeded walk over u8 databases D_0 … D_E (a few columns change per epoch,
one epoch may be a full rebuild) gives the patches; the port's and the
reference's `HintPatch`, `compose_patches`, `compact_chain`, `EpochLog` and
`HintCache` must agree on every field, CRC and byte count, and every synced
hint must equal D_E·A bit for bit.  Every case comes from a fixed seed.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pir as jpir
from repro.kernels import ops as jops
from repro.update import epochs as jepochs
from repro_torch._common import u32_to_numpy, u32_to_torch
from repro_torch.core import lwe, pir
from repro_torch.update import epochs

M, N = 96, 24
CPU = torch.device("cpu")


def _walk(seed, n_epochs, full_at=None):
    """(databases, hints, port patches, reference patches)."""
    rng = np.random.default_rng(seed)
    pcfg = pir.make_config(M, N, a_seed=seed + 3)
    rcfg = jpir.make_config(M, N, impl="xla", a_seed=seed + 3)
    a_mat = jpir.PIRServer(rcfg, jnp.zeros((M, N), jnp.uint8)).a_matrix
    dbs = [rng.integers(0, 256, (M, N), dtype=np.uint8)]
    for _ in range(n_epochs):
        d = dbs[-1].copy()
        cols = np.sort(rng.choice(N, int(rng.integers(1, 5)), replace=False))
        rows = int(rng.integers(8, M))
        d[:rows, cols] = rng.integers(0, 256, (rows, len(cols)),
                                      dtype=np.uint8)
        dbs.append(d)
    hints = [np.asarray(jops.hint_gemm(jnp.asarray(d), a_mat, impl="xla"))
             for d in dbs]
    port, ref = [], []
    for e in range(n_epochs):
        if e == full_at:
            kw = dict(full_hint=hints[e + 1])
            port.append(epochs.HintPatch(e, e + 1, cfg=pcfg, **kw))
            ref.append(jepochs.HintPatch(e, e + 1, cfg=rcfg, **kw))
            continue
        cols = np.nonzero((dbs[e + 1] != dbs[e]).any(0))[0].astype(np.int64)
        rows = int(np.nonzero((dbs[e + 1] != dbs[e]).any(1))[0].max()) + 1
        delta = (dbs[e + 1][:rows, cols].astype(np.int16)
                 - dbs[e][:rows, cols].astype(np.int16))
        port.append(epochs.HintPatch(e, e + 1, cols=cols, delta=delta))
        ref.append(jepochs.HintPatch(e, e + 1, cols=cols, delta=delta))
    return dbs, hints, port, ref, pcfg, rcfg


def _same_patch(got, want):
    assert (got.from_epoch, got.to_epoch) == (want.from_epoch, want.to_epoch)
    assert got.is_full == want.is_full
    if got.is_full:
        np.testing.assert_array_equal(got.full_hint, np.asarray(want.full_hint))
    else:
        np.testing.assert_array_equal(got.cols, want.cols)
        assert got.delta.dtype == want.delta.dtype == np.int16
        np.testing.assert_array_equal(got.delta, want.delta)
    assert got.crc == want.crc
    assert got.wire_bytes == want.wire_bytes
    assert got.payload_crc() == want.payload_crc()


@pytest.mark.parametrize("seed,full_at", [(0, None), (1, 2), (2, 0), (3, 4)])
def test_compose_and_compact_match_reference(seed, full_at):
    _, hints, port, ref, pcfg, _ = _walk(seed, 6, full_at)
    for i in range(len(port) - 1):
        _same_patch(epochs.compose_patches(port[i], port[i + 1]),
                    jepochs.compose_patches(ref[i], ref[i + 1]))
    whole = epochs.compact_chain(port)
    _same_patch(whole, jepochs.compact_chain(ref))
    _same_patch(whole.sealed(), jepochs.compact_chain(ref).sealed())
    # the compacted patch takes D_0's hint to D_6's
    a_mat = lwe.gen_public_matrix(pcfg.a_seed, N, pcfg.params.k, device=CPU)
    got = whole.apply(u32_to_torch(hints[0], CPU), a_mat)
    np.testing.assert_array_equal(u32_to_numpy(got), hints[-1])


@pytest.mark.parametrize("compact_every", [None, 2, 3])
@pytest.mark.parametrize("seed,full_at", [(4, None), (5, 3)])
def test_epoch_log_chains_and_cache_sync_match_reference(seed, full_at,
                                                         compact_every):
    dbs, hints, port, ref, pcfg, rcfg = _walk(seed, 7, full_at)
    plog = epochs.EpochLog(compact_every=compact_every)
    rlog = jepochs.EpochLog(compact_every=compact_every)
    for p, r in zip(port, ref):
        assert plog.publish(p) == rlog.publish(r)
    assert plog.stored_bytes == rlog.stored_bytes
    for e0 in range(len(port) + 1):
        for until in (None, len(port) - 1 if e0 < len(port) else None):
            pc, rc = plog.chain_since(e0, until), rlog.chain_since(e0, until)
            assert len(pc) == len(rc)
            for a, b in zip(pc, rc):
                _same_patch(a, b)
            assert plog.chain_bytes(e0, until) == rlog.chain_bytes(e0, until)
        assert [p.to_epoch for p in plog.download_chain(e0)] == \
               [p.to_epoch for p in rlog.download_chain(e0)]
        assert len(plog.patches_since(e0)) == len(rlog.patches_since(e0))
        cache = epochs.HintCache(u32_to_torch(hints[e0], CPU), pcfg, epoch=e0)
        rcache = jepochs.HintCache(jnp.asarray(hints[e0]), rcfg, epoch=e0)
        assert cache.sync(plog) == rcache.sync(rlog)
        assert cache.epoch == rcache.epoch == len(port)
        np.testing.assert_array_equal(u32_to_numpy(cache.hint), hints[-1])
        np.testing.assert_array_equal(u32_to_numpy(cache.hint),
                                      np.asarray(rcache.hint))
        assert cache.bytes_downloaded == rcache.bytes_downloaded
    with pytest.raises(epochs.StaleEpochError):
        plog.chain_since(len(port) + 1)
    with pytest.raises(epochs.StaleEpochError):
        plog.check_fresh(0)
    plog.check_fresh(len(port))


class _FireOnce:
    """A fault hook that fires its site once (as the reference injector's
    event would), then never again."""

    @dataclasses.dataclass
    class Event:
        device: int

    def __init__(self, device=0):
        self.left = [self.Event(device)]

    def fire(self, site):
        assert site == "update.hint.chain"
        out, self.left = self.left, []
        return out


@pytest.mark.parametrize("seed,full_at", [(6, None), (7, 1)])
def test_tampered_download_is_caught_and_resynced(seed, full_at):
    _, hints, port, ref, pcfg, _ = _walk(seed, 4, full_at)
    log = epochs.EpochLog(compact_every=2)
    for p in port:
        log.publish(p)
    sealed = log.chain_since(0)
    assert all(p.crc is not None and p.verify() for p in sealed)
    rlog = jepochs.EpochLog(compact_every=2)
    for r in ref:
        rlog.publish(r)
    assert [p.crc for p in sealed] == [p.crc for p in rlog.chain_since(0)]
    bad = epochs._tampered(sealed[0])
    assert not bad.verify() and bad.crc == sealed[0].crc

    def full_fetch(e0):
        return epochs.HintPatch(e0, log.epoch, full_hint=hints[-1],
                                cfg=pcfg).sealed()

    log.faults = _FireOnce()
    cache = epochs.HintCache(u32_to_torch(hints[0], CPU), pcfg)
    with pytest.raises(epochs.CorruptPatchError):
        cache.sync(log)                      # no full-hint fallback yet
    assert cache.epoch == 0 and cache.resyncs == 1
    log.faults, log.full_fetch = _FireOnce(1), full_fetch
    before = cache.bytes_downloaded
    spent = cache.sync(log)
    assert cache.resyncs == 2 and cache.epoch == log.epoch
    np.testing.assert_array_equal(u32_to_numpy(cache.hint), hints[-1])
    chain_bytes = log.chain_bytes(0)
    assert spent == cache.bytes_downloaded - before == (
        chain_bytes + full_fetch(0).wire_bytes)
    assert cache.sync(log) == 0              # fresh: nothing to download
