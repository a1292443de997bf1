"""The batch client's stacked encode and decode against the per-client loop.

A serving batch draws every client's secrets and errors in the per-client
loop's order (per client, per bucket: secret, then error) and then runs one
A_b·S_b and one H_b·S_b per bucket.  Its ciphertexts and decoded bytes must
be bitwise those of the per-client loop (one GEMV per bucket per client,
written out here as the loop did it) for the same generator seed — with a
client that falls back to the legacy path in the middle of the batch, whose
own draws sit at its place in the order.  For the document path and the
keyed path; the results must also equal the reference's.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import pipeline as jpipeline
from repro.data import corpus as jcorpus
from repro_torch import convert
from repro_torch._common import wrap_i32
from repro_torch.batchpir import PlacementError
from repro_torch.batchpir.client import BatchQueryState
from repro_torch.core import lwe, pipeline
from repro_torch.kernels import ops

N_CLUSTERS = 8
KNOBS = dict(kappa=3, n_buckets=9, seed=4)
PROBES = 3


@pytest.fixture(scope="module")
def docs():
    corp = jcorpus.make_corpus(4, 240, emb_dim=16, n_topics=N_CLUSTERS,
                               text_len=(16, 64))
    jsys = jpipeline.PirRagSystem.build(corp.texts, corp.embeddings,
                                        n_clusters=N_CLUSTERS, impl="xla",
                                        kmeans_iters=6)
    jsys.enable_batch(**KNOBS)
    tsys = convert.system_from_state(
        corp.texts, corp.embeddings, centroids=np.asarray(jsys.centroids),
        assignment=jsys.assignment, n_clusters=N_CLUSTERS,
        a_seed=jsys.cfg.a_seed, batch=KNOBS, device="cpu")
    rng = np.random.default_rng(5)
    anchors = rng.choice(len(corp.texts), 5, replace=False)
    queries = (corp.embeddings[anchors]
               + 0.02 * rng.standard_normal((5, corp.d))).astype(np.float32)
    return jsys, tsys, queries


def _loop_query(client, gen, placement):
    """One client's batched query as the per-client loop formed it: per
    bucket, draw the secret, draw the error, one GEMV."""
    qs, secs = [], []
    for b in range(client.partition.n_buckets):
        cfg = client.cfgs[b]
        p = cfg.params
        s = wrap_i32(torch.randint(0, 1 << 32, (p.k,), dtype=torch.int64,
                                   generator=gen))
        e = torch.round(p.sigma * torch.randn(
            (cfg.n,), dtype=torch.float32, generator=gen)).to(torch.int32)
        msg = torch.zeros((cfg.n,), dtype=torch.int32)
        if b in placement:
            msg[client.partition.position(b, placement[b])] = 1
        qs.append(lwe.encrypt_vector(s, client._a_mats[b], msg, p.delta, e,
                                     impl="torch"))
        secs.append(s)
    return torch.stack(qs), secs


def _loop_recover(client, answers, c, placement, secs):
    """One client's decoded columns as the per-client loop decoded them:
    one H_b·s per placed bucket."""
    out = {}
    for b, cluster in placement.items():
        p = client.cfgs[b].params
        vals = lwe.decode_switched(answers[b][:, c], client.hints[b],
                                   secs[b], p, impl="torch")
        out[cluster] = vals.to(torch.uint8).numpy()
    return out


class _Spy:
    """Records the stacked ciphertexts handed to the bucketed answer."""

    def __init__(self, server):
        self.server, self.inner, self.qs = server, server.answer_batch, []
        server.answer_batch = self

    def __call__(self, qs):
        self.qs.append(qs.clone())
        return self.inner(qs)

    def close(self):
        del self.server.answer_batch


@pytest.mark.parametrize("fail_at", [None, 2])
def test_stacked_document_batch_equals_per_client_loop(docs, fail_at,
                                                       monkeypatch):
    jsys, tsys, queries = docs
    bp = tsys.batch
    orders = tsys._cluster_order(queries, PROBES)
    if fail_at is not None:      # force one client onto the legacy path
        cls = type(bp.partition)
        place = cls.place
        bad = [int(c) for c in orders[fail_at]]

        def placing(self, clusters, **kw):
            if [int(c) for c in clusters] == bad:
                raise PlacementError(clusters, self.n_buckets, 0)
            return place(self, clusters, **kw)

        monkeypatch.setattr(cls, "place", placing)
    spy = _Spy(bp.server)
    try:
        launches = ops.launch_counts()
        infl = tsys.query_batch_async(
            queries, top_k=4, multi_probe=PROBES,
            generator=torch.Generator().manual_seed(8))
        assert ops.launch_counts() == launches     # the plain CPU route
        got = infl.complete()
    finally:
        spy.close()

    # the per-client loop, on the same seed; the fallback draws in place
    gen = torch.Generator().manual_seed(8)
    live, want_q, states = [], [], []
    for i in range(len(queries)):
        if i == fail_at:
            fall = tsys.query(queries[i], top_k=4, multi_probe=PROBES,
                              generator=gen, mode="legacy")[0]
            continue
        placement = bp.partition.place([int(c) for c in orders[i]])
        q, secs = _loop_query(bp.client, gen, placement)
        live.append(i)
        want_q.append(q)
        states.append((placement, secs))
    assert len(spy.qs) == 1
    torch.testing.assert_close(spy.qs[0], torch.stack(want_q, dim=2),
                               rtol=0, atol=0)
    answers = bp.server.answer_batch(spy.qs[0])
    for c, (i, (placement, secs)) in enumerate(zip(live, states)):
        want_cols = _loop_recover(bp.client, answers, c, placement, secs)
        assert sorted(want_cols) == sorted(int(x) for x in orders[i])
    # the stacked decode, driven directly, equals the loop's columns
    decoded = bp.client.decode(answers, [
        BatchQueryState(placement=placement, secrets=torch.stack(secs))
        for placement, secs in states]).columns()
    for c, (placement, secs) in enumerate(states):
        want_cols = _loop_recover(bp.client, answers, c, placement, secs)
        assert decoded[c].keys() == want_cols.keys()
        for cl, col in want_cols.items():
            np.testing.assert_array_equal(decoded[c][cl], col)
            np.testing.assert_array_equal(
                col, tsys.db.matrix[:len(col), cl])
    # and the batch's results equal the reference's on the same queries
    want = jsys.query_batch(queries, top_k=4, multi_probe=PROBES,
                            key=jax.random.PRNGKey(8))
    assert [[(d, t) for d, _, t in r] for r in got] == \
        [[(d, t) for d, _, t in r] for r in want]
    if fail_at is not None:
        assert got[fail_at] == fall


def _keyed_pair():
    rng = np.random.default_rng(17)
    table = rng.standard_normal((600, 8)).astype(np.float32)
    kw = dict(kappa=4, n_buckets=6, seed=3)
    jsys = jpipeline.PirRagSystem.build_keyed(table, impl="xla", **kw)
    tsys = pipeline.PirRagSystem.build_keyed(table, device="cpu", **kw)
    return jsys, tsys, table


def test_stacked_keyed_batch_equals_per_client_loop():
    """Keyed lookups: the middle client spans more groups than buckets, so
    it falls back to the legacy path, drawing at its place in the order."""
    jsys, tsys, table = _keyed_pair()
    bp, lay = tsys.batch, tsys.keyed
    gs = lay.group_size
    batch = [[5, 5, 130, 0], (np.arange(7) * gs).tolist(), [42, 599],
             [3 * gs + 1, 1]]
    spy = _Spy(bp.server)
    try:
        infl = tsys.lookup_batch_async(
            batch, generator=torch.Generator().manual_seed(2))
        got = infl.complete()
    finally:
        spy.close()

    gen = torch.Generator().manual_seed(2)
    want_q, states = [], []
    for ids in batch:
        groups = lay.groups_of(ids)
        try:
            placement = bp.partition.place(groups)
        except PlacementError:
            rows, st = tsys._lookup_legacy(ids, gen, 0.0)
            assert st.mode == "legacy"
            continue
        q, secs = _loop_query(bp.client, gen, placement)
        want_q.append(q)
        states.append((placement, secs))
    assert len(want_q) == 3 and len(spy.qs) == 1
    torch.testing.assert_close(spy.qs[0], torch.stack(want_q, dim=2),
                               rtol=0, atol=0)
    answers = bp.server.answer_batch(spy.qs[0])
    live = [0, 2, 3]
    for c, (placement, secs) in enumerate(states):
        cols = _loop_recover(bp.client, answers, c, placement, secs)
        want_rows = np.stack([lay.decode_row(cols[lay.group_of(i)], i)
                              for i in batch[live[c]]])
        np.testing.assert_array_equal(got[live[c]], want_rows)
    for ids, rows in zip(batch, got):
        np.testing.assert_array_equal(rows, table[ids])
    want = jsys.lookup_batch(batch, seed=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_single_client_query_is_the_batch_of_one(docs):
    """`query` (draw, then encrypt a batch of one) gives the per-client
    loop's ciphertext and `recover` its columns."""
    _, tsys, _ = docs
    bp = tsys.batch
    qs, st = bp.client.query(torch.Generator().manual_seed(11), [0, 5, 6])
    want, secs = _loop_query(bp.client, torch.Generator().manual_seed(11),
                             st.placement)
    torch.testing.assert_close(qs, want, rtol=0, atol=0)
    answers = bp.server.answer_batch(qs)
    cols = bp.client.recover(answers, st)
    want_cols = _loop_recover(bp.client, [a[:, None] for a in answers], 0,
                              st.placement, secs)
    assert cols.keys() == want_cols.keys() == {0, 5, 6}
    for cl in cols:
        np.testing.assert_array_equal(cols[cl], want_cols[cl])
