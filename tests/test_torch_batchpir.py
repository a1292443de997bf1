"""The port's batch-PIR subsystem against the JAX package's, on the CPU.

Placement, per-bucket sub-DBs, hints and answers, and the per-bucket hint
deltas and sub-DBs across two live commits and an overflow-forced bucket
rebuild must be bitwise the reference's.  Both sides start from the same
clustering (`convert.system_from_state` / `live_from_state` with the
reference's ``a_seed`` and batch knobs).  The plain grouped product is also
held against the reference's ``ops.bucketed_modmatmul`` in both of its
forms, XLA and the Pallas kernel in interpret mode.  Inputs come from fixed
seeds; expected values from the reference at test time.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import batchpir as jbatchpir
from repro.core import chunking as jchunking
from repro.core import pipeline as jpipeline
from repro.data import corpus as jcorpus
from repro.kernels import ops as jops
from repro.update import LiveIndex as JLiveIndex
from repro_torch import batchpir, convert
from repro_torch._common import u32_to_numpy, u32_to_torch
from repro_torch.kernels import ops, ref

CPU = torch.device("cpu")


def _u32(t):
    return u32_to_numpy(t)


def _knobs(jsys):
    bp = jsys.batch
    return dict(kappa=bp.kappa, n_buckets=bp.partition.n_buckets,
                seed=bp.seed)


# ---------------------------------------------------------------------------
# partition and placement (a numpy copy)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,n_buckets,seed", [(64, 12, 3), (40, 9, 0),
                                              (1024, 12, 101), (7, 3, 5)])
def test_partition_matches_reference(n, n_buckets, seed):
    want = jbatchpir.CuckooPartition.build(n, n_buckets, seed)
    got = batchpir.CuckooPartition.build(n, n_buckets, seed)
    np.testing.assert_array_equal(got.candidates, want.candidates)
    assert got.width == want.width
    for a, b in zip(got.members, want.members):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(seed)
    for walk in range(6):
        kappa = int(rng.integers(1, n_buckets // 3 + 1))
        probes = rng.choice(n, size=min(kappa, n), replace=False)
        try:
            placed = want.place(probes, walk_seed=walk)
        except jbatchpir.PlacementError:
            with pytest.raises(batchpir.PlacementError):
                got.place(probes, walk_seed=walk)
            continue
        assert got.place(probes, walk_seed=walk) == placed


def test_placement_errors_match_reference():
    part = batchpir.CuckooPartition.build(20, 6, seed=1)
    with pytest.raises(ValueError):
        part.place([3, 3])
    with pytest.raises(batchpir.PlacementError) as err:
        part.place(list(range(7)))
    assert err.value.clusters == tuple(range(7))


# ---------------------------------------------------------------------------
# the grouped product's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_plain_bucketed_matches_reference(impl):
    """At the reference's own Pallas test shapes (interpret mode)."""
    rng = np.random.default_rng(1)
    dbs = [rng.integers(0, 256, (m_b, 64), dtype=np.uint8)
           for m_b in (128, 256)]
    qs = rng.integers(0, 2**32, (2, 64, 3), dtype=np.uint32)
    kw = dict(block=(128, 64, 128)) if impl == "pallas" else {}
    want = jops.bucketed_modmatmul([jnp.asarray(d) for d in dbs],
                                   jnp.asarray(qs), impl=impl, **kw)
    tdbs = [torch.from_numpy(d) for d in dbs]
    tq = u32_to_torch(qs, CPU)
    for got in (ref.bucketed_modmatmul_ref(tdbs, tq),
                ops.bucketed_modmatmul(tdbs, tq)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_u32(g), np.asarray(w))


@pytest.mark.parametrize("heights,w,c", [((64, 1, 96), 32, 1),
                                         ((5, 300, 17), 7, 4),
                                         ((1,), 1, 2)])
def test_ragged_buckets_match_xla(heights, w, c):
    """Unequal heights, a bucket of one row, W off any tile, C = 1 and the
    vector form: bitwise the reference's XLA path."""
    rng = np.random.default_rng(sum(heights) + w)
    dbs = [rng.integers(0, 256, (m, w), dtype=np.uint8) for m in heights]
    qs = rng.integers(0, 2**32, (len(heights), w, c), dtype=np.uint32)
    want = jops.bucketed_modmatmul([jnp.asarray(d) for d in dbs],
                                   jnp.asarray(qs), impl="xla")
    tdbs = [torch.from_numpy(d) for d in dbs]
    got = ops.bucketed_modmatmul(tdbs, u32_to_torch(qs, CPU))
    for g, x in zip(got, want):
        np.testing.assert_array_equal(_u32(g), np.asarray(x))
    vec = ops.bucketed_modmatmul(tdbs, u32_to_torch(qs[:, :, 0], CPU))
    for g, x in zip(vec, want):
        np.testing.assert_array_equal(_u32(g), np.asarray(x)[:, 0])


def test_bucketed_validates_and_has_no_cpu_kernel():
    db = torch.zeros((8, 4), dtype=torch.uint8)
    q = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.bucketed_modmatmul([db, db], q)                 # B mismatch
    with pytest.raises(TypeError):
        ops.bucketed_modmatmul([db], q.to(torch.int64))
    with pytest.raises(ValueError):
        ops.bucketed_modmatmul([db[:, :3]], q)              # width mismatch
    with pytest.raises(ValueError, match="cuda"):
        ops.bucketed_modmatmul([db], q, impl="cuda")
    ops.reset_launch_counts()
    ops.bucketed_modmatmul([db], q)
    assert ops.launch_counts()["bucketed_modmatmul"] == 0


# ---------------------------------------------------------------------------
# server and client against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    corp = jcorpus.make_corpus(0, 400, emb_dim=24, n_topics=12)
    jsys = jpipeline.PirRagSystem.build(corp.texts, corp.embeddings,
                                        n_clusters=12, impl="xla", seed=0,
                                        kmeans_iters=8)
    jsys.enable_batch(kappa=4, seed=5)
    tsys = convert.system_from_state(
        corp.texts, corp.embeddings, centroids=np.asarray(jsys.centroids),
        assignment=jsys.assignment, n_clusters=12, a_seed=jsys.cfg.a_seed,
        batch=_knobs(jsys), device="cpu")
    return jsys, tsys, corp


def test_sub_dbs_and_bucket_hints_match_reference(pair):
    jsys, tsys, _ = pair
    jb, tb = jsys.batch.server, tsys.batch.server
    assert vars(tb.params) == vars(jb.params)
    assert [c.m for c in tb.cfgs] == [c.m for c in jb.cfgs]
    assert [c.a_seed for c in tb.cfgs] == [c.a_seed for c in jb.cfgs]
    for b in range(jb.partition.n_buckets):
        np.testing.assert_array_equal(tb.sub_dbs[b].numpy(),
                                      np.asarray(jb.sub_dbs[b]))
        np.testing.assert_array_equal(_u32(tb.a_matrix(b)),
                                      np.asarray(jb.a_matrix(b)))
        np.testing.assert_array_equal(_u32(tb.hints[b]),
                                      np.asarray(jb.hints[b]))
    assert (tb.hint_bytes, tb.uplink_bytes, tb.downlink_bytes,
            tb.stored_bytes) == (jb.hint_bytes, jb.uplink_bytes,
                                 jb.downlink_bytes, jb.stored_bytes)


@pytest.mark.parametrize("c", [1, 3])
def test_answers_match_reference(pair, c):
    jsys, tsys, _ = pair
    part = jsys.batch.partition
    rng = np.random.default_rng(c)
    qs = rng.integers(0, 2**32, (part.n_buckets, part.width, c),
                      dtype=np.uint32)
    if c == 1:
        qs = qs[:, :, 0]
    want = jsys.batch.server.answer_batch(jnp.asarray(qs))
    got = tsys.batch.server.answer_batch(u32_to_torch(qs, CPU))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _reference_noise(jbp, qs, placement):
    """The reference's per-bucket errors, recovered from its ciphertexts:
    e_b = qs_b − A_b·s_b − Δ·msg_b (mod 2^32)."""
    part = jbp.partition
    errs = []
    for b in range(part.n_buckets):
        cfg = jbp.server.cfgs[b]
        msg = np.zeros(cfg.n, np.uint32)
        if b in placement:
            msg[part.position(b, placement[b])] = 1
        errs.append(np.asarray(qs[b]) - msg * np.uint32(cfg.params.delta))
    return errs


def test_client_query_and_recover_match_reference(pair):
    jsys, tsys, _ = pair
    jbp, tbp = jsys.batch, tsys.batch
    probes = [0, 3, 7, 11]
    jq, jst = jbp.client.query(jax.random.PRNGKey(3), probes)
    secrets = np.stack([np.asarray(s) for s in jst.secrets])
    masks = [np.asarray(jnp.matmul(jbp.server.a_matrix(b), jst.secrets[b]))
             for b in range(jbp.partition.n_buckets)]
    errs = np.stack([e - m for e, m in zip(
        _reference_noise(jbp, jq, jst.placement), masks)])
    tq, tst = tbp.client.query(None, probes,
                               secrets=u32_to_torch(secrets, CPU),
                               errors=u32_to_torch(errs, CPU))
    assert tst.placement == jst.placement
    np.testing.assert_array_equal(_u32(tq), np.asarray(jq))
    got = tbp.client.recover(tbp.server.answer_batch(tq), tst)
    want = jbp.client.recover(jbp.server.answer_batch(jq), jst)
    assert got.keys() == want.keys() == set(probes)
    for cl in probes:
        np.testing.assert_array_equal(got[cl], want[cl])
        col = jsys.db.matrix[:, cl]
        np.testing.assert_array_equal(got[cl], col[:len(got[cl])])
        assert not col[len(got[cl]):].any()
    acc, jacc = tbp.client.accounting(tst), jbp.client.accounting(jst)
    assert vars(acc) == vars(jacc)


def test_dummy_queries_hide_probe_count(pair):
    _, tsys, _ = pair
    bp = tsys.batch
    gen = torch.Generator().manual_seed(4)
    q1, s1 = bp.client.query(gen, [2])
    q4, s4 = bp.client.query(gen, [0, 3, 7, 11])
    assert q1.shape == q4.shape == (bp.partition.n_buckets,
                                    bp.partition.width)
    assert len(s1.placement) == 1 and len(s4.placement) == 4


# ---------------------------------------------------------------------------
# bucket-routed live commits, bitwise the reference's
# ---------------------------------------------------------------------------

def _live_pair():
    corp = jcorpus.make_corpus(2, 300, emb_dim=16, n_topics=8)
    ref_live = JLiveIndex.build(corp.texts, corp.embeddings, n_clusters=8,
                                impl="xla", kmeans_iters=5)
    ref_live.system.enable_batch(kappa=3, n_buckets=9, seed=4)
    port = convert.live_from_state(
        corp.texts, corp.embeddings,
        centroids=np.asarray(ref_live.system.centroids),
        assignment=ref_live.system.assignment, n_clusters=8,
        a_seed=ref_live.system.cfg.a_seed, batch=_knobs(ref_live.system),
        device="cpu")
    return ref_live, port, corp


def _assert_buckets_equal(ref_live, port):
    jb, tb = ref_live.system.batch.server, port.system.batch.server
    assert [c.m for c in tb.cfgs] == [c.m for c in jb.cfgs]
    for b in range(jb.partition.n_buckets):
        np.testing.assert_array_equal(tb.sub_dbs[b].numpy(),
                                      np.asarray(jb.sub_dbs[b]))
        np.testing.assert_array_equal(_u32(tb.hints[b]),
                                      np.asarray(jb.hints[b]))
    for h, f in zip(tb.hints, tb.setup()):
        assert torch.equal(h, f)
    np.testing.assert_array_equal(_u32(port.system.hint),
                                  np.asarray(ref_live.system.hint))


def _overflow_insert(live, corp):
    """(cluster, text) of an insert that fits the flat DB's rows but not
    the shortest of the cluster's bucket budgets: a delta epoch that forces
    one bucket's rebuild."""
    system = live.system
    server, part = system.batch.server, system.batch.partition
    m = system.db.m
    for j in range(system.db.n):
        rows = min(server.cfgs[b].m for b in part.buckets_of(j))
        used = live._used[j]
        room = m - used
        extra = rows - used + 40
        if extra > 0 and extra <= room:
            text_len = extra - jchunking.record_bytes(system.db.emb_dim, 0)
            if text_len > 0:
                return j, b"o" * text_len
    raise AssertionError("no cluster can overflow only its bucket")


def test_bucket_deltas_match_reference_across_commits_and_overflow():
    ref_live, port, corp = _live_pair()
    jbp, tbp = ref_live.system.batch, port.system.batch
    emb = corp.embeddings
    # epoch 1: two replaces and a delete; epoch 2: replaces in other
    # clusters; epoch 3: an insert that outgrows one bucket's row budget
    batches = [[("replace", 7, b"patched seven", emb[7]),
                ("replace", 211, b"patched two-eleven", emb[211]),
                ("delete", 100, None, None)],
               [("replace", 3, b"three " * 9, emb[3]),
                ("replace", 150, b"x", emb[150])]]
    j, text = _overflow_insert(port, corp)
    batches.append([("insert", 9001, text, port.system.centroids[j])])
    for epoch, batch in enumerate(batches, 1):
        before = [h.clone() for h in tbp.server.hints]
        jbefore = [np.asarray(h).copy() for h in jbp.server.hints]
        for kind, d, t, e in batch:
            for live in (ref_live, port):
                if kind == "delete":
                    live.delete(d)
                else:
                    getattr(live, kind)(d, t, e)
        jpatch, tpatch = ref_live.commit(), port.commit()
        assert not tpatch.is_full and not jpatch.is_full
        assert port.system.batch is tbp and ref_live.system.batch is jbp
        np.testing.assert_array_equal(tpatch.cols, jpatch.cols)
        np.testing.assert_array_equal(tpatch.delta, jpatch.delta)
        _assert_buckets_equal(ref_live, port)
        # ΔH_b of every bucket, as the difference of consecutive hints
        for b in range(jbp.partition.n_buckets):
            if tbp.server.hints[b].shape != before[b].shape:
                continue                                  # rebuilt bucket
            got = _u32(tbp.server.hints[b]) - _u32(before[b])
            want = np.asarray(jbp.server.hints[b]) - jbefore[b]
            np.testing.assert_array_equal(got, want)
        if epoch == 3:
            rebuilt = [b for b in range(jbp.partition.n_buckets)
                       if tbp.server.cfgs[b].m != before[b].shape[0]]
            assert rebuilt, "the overflow insert rebuilt no bucket"
    gen = torch.Generator().manual_seed(0)
    top, st = port.query(emb[7], epoch=port.epoch, top_k=5, multi_probe=2,
                         generator=gen)
    jtop, jst = ref_live.query(emb[7], epoch=ref_live.epoch, top_k=5,
                               multi_probe=2, key=jax.random.PRNGKey(0))
    assert st.mode == jst.mode == "batch"
    assert [d for d, _, _ in top] == [d for d, _, _ in jtop]
    assert [t for d, _, t in top if d == 7] == [b"patched seven"]


def test_stage_update_columns_donating_publish_matches():
    """donate=True defers the column writes to publish: staged and dropped,
    the sub-DBs are untouched; published, they equal the copy path."""
    _, port, corp = _live_pair()
    server = port.system.batch.server
    keep = [d.clone() for d in server.sub_dbs]
    cols = np.array([1, 4])
    new_cols = torch.randint(0, 200, (port.system.db.m, 2),
                             dtype=torch.uint8,
                             generator=torch.Generator().manual_seed(1))
    used = {1: int(server.cfgs[0].m // 2), 4: 10}
    staged = server.stage_update_columns(cols, new_cols, used, donate=True)
    assert all(torch.equal(a, b) for a, b in zip(server.sub_dbs, keep))
    server.update_columns(cols, new_cols, used)
    want = [d.clone() for d in server.sub_dbs]
    server.sub_dbs[:] = [k.clone() for k in keep]
    staged.publish()
    assert all(torch.equal(a, b) for a, b in zip(server.sub_dbs, want))
    with pytest.raises(RuntimeError, match="twice"):
        staged.publish()


def test_full_rebuild_rebuckets_with_the_same_knobs():
    _, port, corp = _live_pair()
    old = port.system.batch
    port.insert(9999, b"x" * (port.system.db.m + 1), corp.embeddings[0])
    assert port.commit().is_full
    bp = port.system.batch
    assert bp is not None and bp is not old
    assert (bp.kappa, bp.partition.n_buckets, bp.seed) == (3, 9, 4)
    for h, f in zip(bp.server.hints, bp.server.setup()):
        assert torch.equal(h, f)


def test_routing_matches_reference():
    """`touched_buckets` and `patch_batch_hints` route one re-packed column
    batch into the same buckets with the same per-bucket log."""
    from repro.update import routing as jrouting
    from repro_torch.update import routing
    ref_live, port, _ = _live_pair()
    cols = np.array([2, 5])
    assert routing.touched_buckets(port.system.batch.partition, cols) == \
        jrouting.touched_buckets(ref_live.system.batch.partition, cols)
    rng = np.random.default_rng(6)
    new_cols = rng.integers(0, 256, (port.system.db.m, 2), dtype=np.uint8)
    new_cols[300:] = 0
    used = {2: 300, 5: 300}
    got = routing.patch_batch_hints(port.system, cols, new_cols, used)
    want = jrouting.patch_batch_hints(ref_live.system, cols, new_cols, used)
    assert [(u.bucket, u.rebuilt, list(u.cols)) for u in got] == \
        [(u.bucket, u.rebuilt, list(u.cols)) for u in want]
    _assert_buckets_equal(ref_live, port)
    plain = dataclasses.replace(port.system, batch=None)
    assert routing.patch_batch_hints(plain, cols, new_cols, used) == []
