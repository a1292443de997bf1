"""The port's live index against the JAX package's, on the CPU.

Both start from the same state (`convert.live_from_state` takes the JAX
build's centroids, assignment and ``a_seed``), take the same mutations and
must publish the same `HintPatch` (cols, int16 delta, epochs, CRC), hold the
same DB bytes and hint bit for bit, and return the same top-k.  A full
rebuild re-runs the port's own k-means, so there the port is held to the
invariants instead: a full patch whose hint equals `setup()`, every live doc
in the DB, doc ids kept.  Every mutation sequence comes from a fixed seed.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import chunking as jchunking
from repro.data import corpus as jcorpus
from repro.update import LiveIndex as JLiveIndex
from repro.update import journal as jjournal
from repro.update import planner as jplanner
from repro_torch import convert
from repro_torch._common import u32_to_numpy
from repro_torch.core import chunking
from repro_torch.update import (HintCache, LiveIndex, StaleEpochError,
                                journal, planner, routing)

CPU = torch.device("cpu")


def _corpus(seed=0, n_docs=120, emb_dim=12, n_topics=5):
    return jcorpus.make_corpus(seed, n_docs, emb_dim=emb_dim,
                               n_topics=n_topics)


def _pair(corp, n_clusters, doc_ids=None, **kw):
    """(JAX LiveIndex, port LiveIndex) over the same clustering."""
    ref = JLiveIndex.build(corp.texts, corp.embeddings, n_clusters=n_clusters,
                           impl="xla", kmeans_iters=6, doc_ids=doc_ids, **kw)
    port = convert.live_from_state(
        corp.texts, corp.embeddings, centroids=np.asarray(ref.system.centroids),
        assignment=ref.system.assignment, n_clusters=n_clusters,
        a_seed=ref.system.cfg.a_seed, doc_ids=doc_ids, device="cpu", **kw)
    return ref, port


def _port_live(seed=0, n_docs=80, emb_dim=8, n_clusters=4, **kw):
    corp = _corpus(seed, n_docs, emb_dim, n_clusters)
    return LiveIndex.build(corp.texts, corp.embeddings, n_clusters=n_clusters,
                           kmeans_iters=6, device="cpu", **kw), corp


def _random_mutations(lives, rng, n_ops, emb_dim):
    """One random insert/delete/replace batch, journaled into every index
    in ``lives`` alike (the id set tracks the batch so no op targets a doc
    the batch already deleted)."""
    ids = set(lives[0].doc_ids())
    for _ in range(n_ops):
        op = int(rng.integers(3))
        if op == 0:
            nid = int(10_000 + rng.integers(10_000))
            if nid not in ids:
                emb = rng.standard_normal(emb_dim).astype(np.float32)
                for lv in lives:
                    lv.insert(nid, f"ins {nid}".encode(), emb)
                ids.add(nid)
        elif op == 1 and len(ids) > 20:
            d = int(rng.choice(sorted(ids)))
            for lv in lives:
                lv.delete(d)
            ids.discard(d)
        else:
            d = int(rng.choice(sorted(ids)))
            emb = rng.standard_normal(emb_dim).astype(np.float32)
            for lv in lives:
                lv.replace(d, f"rep {d}".encode(), emb)


def _db_doc_ids(system):
    db = system.db
    return sorted(i for j in range(db.n)
                  for i, _, _ in chunking.deserialize_docs(db.matrix[:, j],
                                                           db.emb_dim))


def _assert_fresh(live):
    """Patched hint == setup() on the live DB, and the server's DB tensor
    == the host mirror."""
    fresh = live.system.server.setup()
    assert torch.equal(fresh, live.system.hint)
    np.testing.assert_array_equal(live.system.server.db.numpy(),
                                  live.system.db.matrix)


# ---------------------------------------------------------------------------
# journal, planner, column rebuild
# ---------------------------------------------------------------------------

def _mutations(mod, rng, emb_dim=6):
    return [mod.insert(5, b"five", rng.standard_normal(emb_dim)),
            mod.replace(2, b"two v2", rng.standard_normal(emb_dim)),
            mod.delete(3),
            mod.insert(70000, b"", rng.standard_normal(emb_dim)),
            mod.replace(5, b"\x00\xffbytes", rng.standard_normal(emb_dim))]


def test_journal_bytes_and_replay_match_reference():
    port_muts = _mutations(journal, np.random.default_rng(0))
    ref_muts = _mutations(jjournal, np.random.default_rng(0))
    pj, rj = journal.MutationJournal(), jjournal.MutationJournal()
    for a, b in zip(port_muts, ref_muts):
        assert a.to_bytes() == b.to_bytes()
        pj.append(a)
        rj.append(b)
    assert pj.to_bytes() == rj.to_bytes()
    back = journal.MutationJournal.from_bytes(pj.to_bytes())
    assert back.to_bytes() == pj.to_bytes() and len(back) == 5
    pj.mark_committed(1)
    assert [e for e, _ in pj.committed_records()] == [1] * 5
    assert pj.pending() == []
    rng = np.random.default_rng(1)
    base = {i: (f"d{i}".encode(), rng.standard_normal(6).astype(np.float32))
            for i in range(4)}
    got = journal.replay(base, port_muts)
    want = jjournal.replay(base, ref_muts)
    assert sorted(got) == sorted(want) == [0, 1, 2, 5, 70000]
    for i in got:
        assert got[i][0] == want[i][0]
        np.testing.assert_array_equal(got[i][1], want[i][1])


@pytest.mark.parametrize("case", ["delta", "overflow", "pad"])
def test_plan_updates_matches_reference(case):
    rng = np.random.default_rng(7)
    d, n = 6, 4
    cents = rng.standard_normal((n, d)).astype(np.float32)
    docs = {i: (f"doc {i}".encode(), rng.standard_normal(d).astype(np.float32))
            for i in range(30)}
    cluster_of = {i: planner.nearest_centroid(e, cents)
                  for i, (_, e) in docs.items()}
    used = {j: chunking.column_payload_bytes(
        d, [len(docs[i][0]) for i in docs if cluster_of[i] == j])
        for j in range(n)}
    m = max(used.values()) + 64
    text = b"x" * (200 if case == "overflow" else 3)
    muts = [journal.insert(100, text, rng.standard_normal(d)),
            journal.delete(4), journal.replace(7, b"seven",
                                               rng.standard_normal(d))]
    kw = dict(docs=docs, cluster_of=cluster_of, centroids=cents, m=m,
              used_bytes=used, n_clusters=n, emb_dim=d,
              max_pad_fraction=0.1 if case == "pad" else 0.95)
    got = planner.plan_updates(muts, **kw)
    want = jplanner.plan_updates(
        [jjournal.Mutation(x.kind, x.doc_id, x.text, x.emb) for x in muts],
        **kw)
    assert got.touched == want.touched
    assert (got.full_rebuild, got.reason) == (want.full_rebuild, want.reason)
    assert got.full_rebuild == (case != "delta")
    assert got.projected_pad_fraction == want.projected_pad_fraction
    assert got.new_cluster_of == want.new_cluster_of
    assert sorted(got.new_docs) == sorted(want.new_docs)
    for j in got.touched:
        assert ([t[0] for t in got.docs_by_cluster[j]]
                == [t[0] for t in want.docs_by_cluster[j]])
    with pytest.raises(KeyError):
        planner.plan_updates([journal.delete(999)], **kw)


def test_rebuild_columns_is_a_from_scratch_pack():
    rng = np.random.default_rng(2)
    docs_by_col = {
        j: [(int(i), rng.standard_normal(8).astype(np.float32),
             f"doc {i}".encode()) for i in rng.permutation(40)[:5 + j]]
        for j in (6, 1, 3)}
    cols, new, used = chunking.rebuild_columns(512, docs_by_col)
    rcols, rnew, rused = jchunking.rebuild_columns(512, docs_by_col)
    np.testing.assert_array_equal(cols, rcols)
    np.testing.assert_array_equal(new, rnew)
    assert used == rused and list(cols) == [1, 3, 6]
    for idx, j in enumerate(cols):
        payload = np.frombuffer(chunking.pack_column(docs_by_col[int(j)]),
                                np.uint8)
        np.testing.assert_array_equal(new[:len(payload), idx], payload)
        assert not new[len(payload):, idx].any()
    with pytest.raises(chunking.ColumnOverflowError) as err:
        chunking.rebuild_columns(64, docs_by_col)
    assert err.value.have == 64


# ---------------------------------------------------------------------------
# the port on its own: patched hint == setup(), client chain included
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n_batches", [(0, 3), (11, 2), (23, 3),
                                            (1234567, 1)])
def test_patched_hint_equals_fresh_setup(seed, n_batches):
    """Twin of the reference's property test, as a fixed seeded sweep:
    after every commit the patched hint equals the port's own setup()
    bit for bit, server-side and through the client's HintPatch chain."""
    live, _ = _port_live(seed=seed % 7)
    cache = HintCache(live.system.hint, live.system.cfg)
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        _random_mutations([live], rng, int(rng.integers(1, 5)), 8)
        if live.commit() is None:
            continue
        _assert_fresh(live)
        cache.sync(live.epochs)
        assert cache.epoch == live.epoch
        assert torch.equal(cache.hint, live.system.hint)


# ---------------------------------------------------------------------------
# lockstep against the JAX package's live index
# ---------------------------------------------------------------------------

def _same_top(got, want):
    assert [d for d, _, _ in got] == [d for d, _, _ in want]
    assert [t for _, _, t in got] == [t for _, _, t in want]
    np.testing.assert_allclose([s for _, s, _ in got],
                               [s for _, s, _ in want], rtol=0, atol=1e-6)


def test_lockstep_with_reference_through_delta_and_rebuild_epochs():
    """Inserts, deletes, replaces, an empty commit, then an overflow that
    forces a full rebuild: at every delta epoch the two indexes publish the
    same sealed patch and hold the same DB bytes, hint and top-k."""
    corp = _corpus(4, 150, emb_dim=16, n_topics=6)
    ref, port = _pair(corp, 6)
    hint0, cfg0 = port.system.hint, port.system.cfg
    rng = np.random.default_rng(5)
    queries = (corp.embeddings[[3, 50, 97]]
               + 0.05 * rng.standard_normal((3, 16))).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    for step in range(4):
        _random_mutations([ref, port], rng, 3 + step, 16)
        pr, pp = ref.commit(), port.commit()
        assert not pp.is_full
        sr, sp = ref.epochs._patches[-1], port.epochs._patches[-1]
        assert (sp.from_epoch, sp.to_epoch) == (sr.from_epoch, sr.to_epoch)
        np.testing.assert_array_equal(sp.cols, sr.cols)
        assert sp.delta.dtype == sr.delta.dtype == np.int16
        np.testing.assert_array_equal(sp.delta, sr.delta)
        assert sp.crc == sr.crc and sp.wire_bytes == sr.wire_bytes
        np.testing.assert_array_equal(port.system.db.matrix,
                                      ref.system.db.matrix)
        np.testing.assert_array_equal(port.system.server.db.numpy(),
                                      np.asarray(ref.system.server.db))
        np.testing.assert_array_equal(u32_to_numpy(port.system.hint),
                                      np.asarray(ref.system.hint))
        _assert_fresh(port)
        assert port.doc_ids() == ref.doc_ids()
        got = port.query_batch(queries, epoch=port.epoch, top_k=5,
                               generator=gen)
        want = ref.query_batch(queries, epoch=ref.epoch, top_k=5,
                               key=jax.random.PRNGKey(step))
        for g, w in zip(got, want):
            _same_top(g, w)
    assert ref.commit() is None and port.commit() is None   # empty commit
    assert port.epoch == ref.epoch == 4

    big = b"y" * (port.system.db.m + 1)                      # overflow
    for lv in (ref, port):
        lv.insert(77_777, big, corp.embeddings[9])
    ref.commit()
    patch = port.commit()
    assert patch.is_full and port.commits[-1].reason == "overflow"
    assert port.commits[-1].full_rebuild and port.epoch == ref.epoch == 5
    _assert_fresh(port)
    np.testing.assert_array_equal(
        patch.full_hint, u32_to_numpy(port.system.server.setup()))
    assert port.doc_ids() == ref.doc_ids() == _db_doc_ids(port.system)
    assert 77_777 in port.doc_ids()
    top, _ = port.query(corp.embeddings[9], epoch=port.epoch, top_k=10,
                        generator=gen)
    assert 77_777 in [d for d, _, _ in top]
    cache = HintCache(hint0, cfg0)            # a client still at epoch 0
    cache.sync(port.epochs)
    assert cache.epoch == 5 and torch.equal(cache.hint, port.system.hint)


def test_stale_epoch_is_refused_until_synced():
    corp = _corpus(1, 150, emb_dim=16, n_topics=6)
    _, port = _pair(corp, 6)
    cache = HintCache(port.system.hint, port.system.cfg)
    port.replace(7, b"revised seven", corp.embeddings[7])
    port.delete(23)
    port.insert(7777, b"inserted doc", corp.embeddings[40] + 0.01)
    port.commit()
    with pytest.raises(StaleEpochError):
        port.query(corp.embeddings[7], epoch=0)
    cache.sync(port.epochs)
    top, _ = port.query(corp.embeddings[7], epoch=cache.epoch, top_k=3,
                        generator=torch.Generator().manual_seed(0))
    assert [t for d, _, t in top if d == 7] == [b"revised seven"]
    ids = _db_doc_ids(port.system)
    assert 23 not in ids and 7777 in ids


# ---------------------------------------------------------------------------
# staged epochs: an abort or a drop leaves the serving epoch intact
# ---------------------------------------------------------------------------

def test_aborted_donating_stage_keeps_serving(monkeypatch):
    """Twin of the reference's: stage(donate=True) failing mid-stage leaves
    server.db and the hint serving the old epoch, and the journal batch
    lands on the next commit."""
    live, corp = _port_live(0, 100, 12, 5)
    live.replace(3, b"doomed edit", corp.embeddings[3])
    db_before = live.system.server.db.clone()

    def boom(*a, **k):
        raise RuntimeError("mid-stage failure")

    monkeypatch.setattr(routing, "stage_batch_hints", boom)
    with pytest.raises(RuntimeError, match="mid-stage"):
        live.stage(donate=True)
    monkeypatch.undo()
    assert torch.equal(live.system.server.db, db_before)
    gen = torch.Generator().manual_seed(11)
    top, _ = live.query(corp.embeddings[3], epoch=live.epoch, top_k=3,
                        generator=gen)
    assert [t for d, _, t in top if d == 3] == [corp.texts[3]]
    patch = live.commit(donate=True)
    assert patch is not None and live.epoch == 1
    top, _ = live.query(corp.embeddings[3], epoch=live.epoch, top_k=3,
                        generator=gen)
    assert [t for d, _, t in top if d == 3] == [b"doomed edit"]
    _assert_fresh(live)


def test_dropped_donating_staged_epoch_is_harmless():
    """Twin of the reference's: a StagedEpoch built with donate=True and
    never published leaves the live epoch serving and can be re-staged."""
    live, corp = _port_live(0, 100, 12, 5)
    live.replace(5, b"five v2", corp.embeddings[5])
    hint_before = live.system.hint.clone()
    staged = live.stage(donate=True)
    assert staged is not None
    del staged                                     # dropped, never published
    assert torch.equal(live.system.hint, hint_before)
    gen = torch.Generator().manual_seed(13)
    top, _ = live.query(corp.embeddings[5], epoch=live.epoch, top_k=3,
                        generator=gen)
    assert [t for d, _, t in top if d == 5] == [corp.texts[5]]
    patch = live.publish(live.stage(donate=True))
    assert patch is not None and live.epoch == 1
    top, _ = live.query(corp.embeddings[5], epoch=live.epoch, top_k=3,
                        generator=gen)
    assert [t for d, _, t in top if d == 5] == [b"five v2"]
    _assert_fresh(live)


# ---------------------------------------------------------------------------
# external doc ids
# ---------------------------------------------------------------------------

def test_external_doc_ids_survive_delta_and_rebuild():
    corp = _corpus(2, 90, emb_dim=8, n_topics=4)
    ids = [1000 + 7 * i for i in range(90)]
    ref, port = _pair(corp, 4, doc_ids=ids)
    np.testing.assert_array_equal(port.system.db.matrix, ref.system.db.matrix)
    assert _db_doc_ids(port.system) == sorted(ids) == port.doc_ids()
    for lv in (ref, port):
        lv.replace(1007, b"renamed", corp.embeddings[1])
        lv.delete(1014)
    ref.commit()
    port.commit()
    np.testing.assert_array_equal(port.system.db.matrix, ref.system.db.matrix)
    want = sorted(set(ids) - {1014})
    assert _db_doc_ids(port.system) == want == port.doc_ids()
    port.insert(5, b"z" * (port.system.db.m + 1), corp.embeddings[0])
    assert port.commit().is_full
    assert _db_doc_ids(port.system) == sorted(want + [5]) == port.doc_ids()
    _assert_fresh(port)
