"""Keyed embedding-row lookups through batch-PIR: the port against the JAX
package, on the CPU.

`PirRagSystem.build_keyed` has no k-means, so the port builds the same
keyed DB, hint, partition, sub-DBs and bucket hints as the reference from
the same table and seeds, bit for bit.  Recovered rows must equal
``table[ids]`` and the reference's output exactly, for duplicated and
empty id multisets, one request or a batch, through the legacy fallback,
across a `replace_row` commit and through the serve loop.  Tables come
from fixed seeds.
"""
import jax
import numpy as np
import pytest
import torch

from repro.batchpir import KeyedLayout as JKeyedLayout
from repro.core import pipeline as jpipeline
from repro.obs import Obs as JObs
from repro.serve.engine import PIRServeLoop as JLoop
from repro.update import LiveIndex as JLiveIndex
from repro_torch._common import u32_to_numpy
from repro_torch.batchpir import KeyedLayout, PlacementError
from repro_torch.core import pipeline
from repro_torch.obs import Obs
from repro_torch.serve import PIRServeLoop
from repro_torch.update import LiveIndex

V, D = 600, 8
KW = dict(kappa=4, seed=0, batch_seed=101)


def _table(seed=17, v=V, d=D):
    return np.random.default_rng(seed).standard_normal((v, d)).astype(
        np.float32)


@pytest.fixture(scope="module")
def pair():
    table = _table()
    jsys = jpipeline.PirRagSystem.build_keyed(table, impl="xla", **KW)
    tsys = pipeline.PirRagSystem.build_keyed(table, device="cpu", **KW)
    return jsys, tsys, table


class FakeClock:
    def __init__(self, step: float = 1e-4):
        self.t = 0.0
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


@pytest.mark.parametrize("n_rows,dim,group_size", [(600, 8, None),
                                                   (1000, 3, 7), (5, 64, 1)])
def test_layout_matches_reference(n_rows, dim, group_size):
    want = JKeyedLayout.build(n_rows, dim, group_size)
    got = KeyedLayout.build(n_rows, dim, group_size)
    assert (got.group_size, got.n_groups, got.record_stride) == \
        (want.group_size, want.n_groups, want.record_stride)
    rng = np.random.default_rng(n_rows)
    ids = rng.integers(0, n_rows, 20)
    assert got.groups_of(ids) == want.groups_of(ids)
    row = rng.standard_normal(dim).astype(np.float32)
    assert got.row_text(row) == want.row_text(row)
    for bad in (-1, n_rows):
        with pytest.raises(IndexError):
            got.group_of(bad)


def test_keyed_build_matches_reference(pair):
    jsys, tsys, _ = pair
    assert tsys.cfg.a_seed == jsys.cfg.a_seed
    np.testing.assert_array_equal(tsys.db.matrix, jsys.db.matrix)
    np.testing.assert_array_equal(tsys.centroids, np.asarray(jsys.centroids))
    np.testing.assert_array_equal(u32_to_numpy(tsys.hint),
                                  np.asarray(jsys.hint))
    jb, tb = jsys.batch.server, tsys.batch.server
    np.testing.assert_array_equal(tsys.batch.partition.candidates,
                                  jsys.batch.partition.candidates)
    for b in range(jb.partition.n_buckets):
        np.testing.assert_array_equal(tb.sub_dbs[b].numpy(),
                                      np.asarray(jb.sub_dbs[b]))
        np.testing.assert_array_equal(u32_to_numpy(tb.hints[b]),
                                      np.asarray(jb.hints[b]))


@pytest.mark.parametrize("ids", [[5, 5, 599, 0, 123, 5], [42], [],
                                 list(range(0, 96, 24))])
def test_lookup_rows_equal_table_and_reference(pair, ids):
    jsys, tsys, table = pair
    rows, st = tsys.lookup(ids, generator=torch.Generator().manual_seed(1))
    jrows, jst = jsys.lookup(ids, key=jax.random.PRNGKey(1))
    np.testing.assert_array_equal(rows, table[ids].reshape(len(ids), D))
    np.testing.assert_array_equal(rows, jrows)
    for f in ("uplink_bytes", "downlink_bytes", "kappa", "groups", "mode",
              "n_buckets", "hint_bytes"):
        assert getattr(st, f) == getattr(jst, f), f


def test_lookup_batch_matches_table_and_reference(pair):
    jsys, tsys, table = pair
    rng = np.random.default_rng(3)
    batch = [rng.integers(0, V, k).tolist() for k in (1, 4, 7, 2)]
    infl = tsys.lookup_batch_async(batch,
                                   generator=torch.Generator().manual_seed(2))
    assert [tuple(a.shape) for a in infl.pending] == \
        [(c.m, len(batch)) for c in tsys.batch.server.cfgs]
    got = infl.complete()
    want = jsys.lookup_batch(batch, seed=2)
    for ids, g, w in zip(batch, got, want):
        np.testing.assert_array_equal(g, table[ids])
        np.testing.assert_array_equal(g, w)


def test_placement_failure_falls_back_exactly():
    """More distinct groups than buckets never place: `query_rows` raises
    and `lookup` / `lookup_batch` take the legacy path, bit-exact."""
    table = _table(5, v=640)
    kw = dict(kappa=4, n_buckets=6, seed=3)
    jsys = jpipeline.PirRagSystem.build_keyed(table, impl="xla", **kw)
    tsys = pipeline.PirRagSystem.build_keyed(table, device="cpu", **kw)
    gs = tsys.keyed.group_size
    ids = (np.arange(7) * gs).tolist()
    with pytest.raises(PlacementError):
        tsys.batch.client.query_rows(None, tsys.keyed, ids)
    rows, st = tsys.lookup(ids, generator=torch.Generator().manual_seed(9))
    jrows, jst = jsys.lookup(ids, key=jax.random.PRNGKey(9))
    assert st.mode == jst.mode == "legacy"
    np.testing.assert_array_equal(rows, table[ids])
    np.testing.assert_array_equal(rows, jrows)
    assert (st.uplink_bytes, st.groups) == (jst.uplink_bytes, jst.groups)
    both = tsys.lookup_batch([ids, [1, 2]],
                             generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(both[0], table[ids])
    np.testing.assert_array_equal(both[1], table[[1, 2]])


def test_replace_row_commit_matches_reference():
    table = _table(7)
    ref_live = JLiveIndex.build_keyed(table, impl="xla", **KW)
    port = LiveIndex.build_keyed(table, device="cpu", **KW)
    rng = np.random.default_rng(8)
    new_table = table.copy()
    for epoch in (1, 2):
        for i in rng.choice(V, 3, replace=False):
            row = rng.standard_normal(D).astype(np.float32)
            new_table[i] = row
            ref_live.replace_row(int(i), row)
            port.replace_row(int(i), row)
        jpatch, tpatch = ref_live.commit(), port.commit()
        assert not tpatch.is_full and port.epoch == epoch
        np.testing.assert_array_equal(tpatch.cols, jpatch.cols)
        np.testing.assert_array_equal(tpatch.delta, jpatch.delta)
        assert tpatch.crc == jpatch.crc
        jb, tb = ref_live.system.batch.server, port.system.batch.server
        for b in range(jb.partition.n_buckets):
            np.testing.assert_array_equal(tb.sub_dbs[b].numpy(),
                                          np.asarray(jb.sub_dbs[b]))
            np.testing.assert_array_equal(u32_to_numpy(tb.hints[b]),
                                          np.asarray(jb.hints[b]))
        for h, f in zip(tb.hints, tb.setup()):
            assert torch.equal(h, f)
        ids = [int(i) for i in rng.integers(0, V, 6)]
        rows, _ = port.lookup(ids, epoch=port.epoch,
                              generator=torch.Generator().manual_seed(epoch))
        np.testing.assert_array_equal(rows, new_table[ids])
        both = port.lookup_batch([ids, ids[:2]], epoch=port.epoch)
        np.testing.assert_array_equal(both[1], new_table[ids[:2]])
    port.insert(V, b"x", table[0])
    with pytest.raises(ValueError, match="replace only"):
        port.commit()
    texts = [b"a", b"b", b"c"]
    plain = LiveIndex(pipeline.PirRagSystem.build(
        texts, table[:3], n_clusters=1, kmeans_iters=1, device="cpu"),
        texts, table[:3])
    with pytest.raises(ValueError, match="keyed"):
        plain.replace_row(0, table[0])


def test_serve_loop_lookups_match_reference(pair):
    """Lookups and queries in one tick: one bucketed pass for the lookups,
    the same responses and trace as the reference's loop."""
    jsys, tsys, table = pair
    rng = np.random.default_rng(11)
    loops = []
    for cls, sysm, obs_cls in ((JLoop, jsys, JObs), (PIRServeLoop, tsys, Obs)):
        clock = FakeClock()
        loops.append(cls(sysm, max_batch=4, deadline_ms=1e9, clock=clock,
                         seed=7, obs=obs_cls(clock=clock, trace=True)))
    asks = {}
    for rid in range(9):
        if rid % 3 == 2:
            q = table[int(rng.integers(V))]
            for lp in loops:
                lp.submit(rid, q, top_k=2)
        else:
            ids = rng.integers(0, V, int(rng.integers(1, 6))).tolist()
            asks[rid] = ids
            for lp in loops:
                lp.submit_lookup(rid, ids)
        for lp in loops:
            lp.tick()
    for lp in loops:
        lp.drain()
    ref_loop, port_loop = loops
    got = {r.rid: r for r in port_loop.responses}
    want = {r.rid: r for r in ref_loop.responses}
    assert sorted(got) == sorted(want) == list(range(9))
    for rid, r in got.items():
        w = want[rid]
        assert (r.epoch, r.retries, r.batch_size, r.failed) == \
            (w.epoch, w.retries, w.batch_size, w.failed)
        if rid in asks:
            np.testing.assert_array_equal(r.top, table[asks[rid]])
            np.testing.assert_array_equal(r.top, w.top)
        else:
            assert [d for d, _, _ in r.top] == [d for d, _, _ in w.top]
    assert port_loop.obs.tracer.to_chrome() == ref_loop.obs.tracer.to_chrome()
