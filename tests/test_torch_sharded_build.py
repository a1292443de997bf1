"""The port's sharded build against the JAX package, bitwise.

Packing (the vectorised record writer, every row-shard count), the sharded
k-means against the unsharded fit at the same block count, and the whole
sharded port system against the reference: first the reference's unsharded
build, its clustering carried across with ``convert`` onto a port system
row-sharded over S = 1, 2, 4 CPU shards (DB bytes, hint, answers, decoded
columns, top-k, a live commit, batch-PIR buckets, keyed rows), then, in one
subprocess with 4 fake XLA devices, the reference's own ``mesh=`` build,
whose row shards, hint and sharded answers the port must reproduce.  The
bucket layout (`balanced_bucket_order`, `shard_row_loads`) is held against
the reference's functions on random heights.
"""
import math

import jax
import numpy as np
import pytest
import torch

from _mesh_harness import run_sub
from repro.core import chunking as jchunking
from repro.core import pipeline as jpipeline
from repro.core import pir as jpir
from repro.data import corpus as jcorpus
from repro.distributed import collectives as jcollectives
from repro.update import LiveIndex as JLiveIndex
from repro_torch import convert
from repro_torch._common import u32_to_numpy, u32_to_torch
from repro_torch.core import chunking, clustering, pipeline, pir, threefry
from repro_torch.distributed import collectives
from repro_torch.launch.mesh import make_local_mesh

SHARDS = (1, 2, 4)
CPU = torch.device("cpu")


def _mesh(shards):
    return make_local_mesh(shards, devices=["cpu"] * shards)


@pytest.fixture(scope="module")
def corp():
    return jcorpus.make_corpus(2, 200, emb_dim=12, n_topics=6)


def _per_document_matrix(texts, embs, assign, n_clusters, chunk, ids):
    """The DB as one `pack_column` per cluster (the per-document path)."""
    cols = [chunking.pack_column([(int(ids[i]), embs[i], texts[i])
                                  for i in np.nonzero(assign == j)[0]])
            for j in range(n_clusters)]
    m = -(-max(map(len, cols)) // chunk) * chunk
    out = np.zeros((m, n_clusters), np.uint8)
    for j, c in enumerate(cols):
        out[:len(c), j] = np.frombuffer(c, np.uint8)
    return out


@pytest.mark.parametrize("shards", (1, 2, 3, 4))
@pytest.mark.parametrize("chunk", (90, 256))
def test_vectorised_packing_is_byte_identical(corp, shards, chunk):
    rng = np.random.default_rng(shards)
    assign = rng.integers(0, 9, len(corp.texts))
    assign[assign == 4] = 5                            # one empty column
    ids = rng.permutation(len(corp.texts)) * 7 + 3     # not in row order
    ids[10] = ids[11]                                  # a duplicate id
    got = chunking.build_chunked_db(corp.texts, corp.embeddings, assign, 9,
                                    chunk, doc_ids=ids, n_row_shards=shards)
    want = jchunking.build_chunked_db(corp.texts, corp.embeddings, assign, 9,
                                      chunk, doc_ids=ids,
                                      n_row_shards=shards)
    np.testing.assert_array_equal(
        got.matrix, _per_document_matrix(corp.texts, corp.embeddings, assign,
                                         9, chunk, ids))
    np.testing.assert_array_equal(got.matrix, want.matrix)
    np.testing.assert_array_equal(got.used_bytes, want.used_bytes)
    np.testing.assert_array_equal(got.cluster_sizes, want.cluster_sizes)
    assert got.pad_fraction == want.pad_fraction
    if shards == 1:
        assert got.row_shards is None and want.row_shards is None
    else:
        assert len(got.row_shards) == shards
        for a, b in zip(got.row_shards, want.row_shards):
            np.testing.assert_array_equal(a, b)
        got.matrix[0, 0] ^= 1                          # views of one buffer
        assert got.row_shards[0][0, 0] == got.matrix[0, 0]


def test_rebuild_columns_matches_reference(corp):
    embs = corp.embeddings
    docs = {2: [(50 - i, embs[i], corp.texts[i]) for i in range(12)],
            7: [], 5: [(9, embs[40], b"")]}
    got = chunking.rebuild_columns(4000, docs)
    want = jchunking.rebuild_columns(4000, docs)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    with pytest.raises(chunking.ColumnOverflowError) as err:
        chunking.rebuild_columns(100, docs)
    with pytest.raises(jchunking.ColumnOverflowError) as jerr:
        jchunking.rebuild_columns(100, docs)
    assert (err.value.cluster, err.value.need) == (jerr.value.cluster,
                                                   jerr.value.need)


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_kmeans_is_the_unsharded_fit(corp, shards):
    blocks = math.lcm(clustering.BUILD_BLOCKS, shards)
    assert clustering.build_blocks(shards) == blocks
    x = torch.from_numpy(corp.embeddings)
    want = clustering.kmeans_fit(threefry.torch_generator((0, 5), CPU), x,
                                 k=9, iters=5, n_blocks=blocks)
    got = clustering.kmeans_fit_sharded(
        threefry.torch_generator((0, 5), CPU), corp.embeddings, k=9, iters=5,
        mesh=_mesh(shards))
    assert torch.equal(got.centroids, want.centroids)
    assert torch.equal(got.assignment, want.assignment)
    assert torch.equal(got.inertia, want.inertia)
    mesh = _mesh(shards)
    assert torch.equal(
        clustering.blocked_sqdist(corp.embeddings, want.centroids,
                                  n_blocks=blocks, mesh=mesh),
        clustering.blocked_sqdist(x, want.centroids, n_blocks=blocks))


def _ref_queries(ref, clusters, seed):
    """The reference's encrypted one-hots for ``clusters`` (numpy u32)."""
    client = jpir.PIRClient(ref.cfg, ref.hint)
    per = [client.query(jax.random.PRNGKey(seed + i), c)
           for i, c in enumerate(clusters)]
    qs = np.stack([np.asarray(q) for q, _ in per], axis=1)
    secrets = jax.numpy.stack([st.secret for _, st in per], axis=1)
    return client, qs, secrets


@pytest.fixture(scope="module")
def ref_pair(corp):
    ref = jpipeline.PirRagSystem.build(corp.texts, corp.embeddings,
                                       n_clusters=9, impl="xla",
                                       kmeans_iters=6, chunk_size=90)
    return ref


def _from_ref(corp, ref, shards, **kw):
    return convert.system_from_state(
        corp.texts, corp.embeddings, centroids=np.asarray(ref.centroids),
        assignment=ref.assignment, n_clusters=9, a_seed=ref.cfg.a_seed,
        chunk_size=90, mesh=_mesh(shards), **kw)


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_port_equals_reference_build(corp, ref_pair, shards):
    ref = ref_pair
    port = _from_ref(corp, ref, shards)
    np.testing.assert_array_equal(port.db.matrix, ref.db.matrix)
    m = ref.db.m
    full = torch.cat(port.server.db).numpy()
    np.testing.assert_array_equal(full[:m], ref.db.matrix)
    assert not full[m:].any()
    np.testing.assert_array_equal(u32_to_numpy(port.hint),
                                  np.asarray(ref.hint))
    client, qs, secrets = _ref_queries(ref, [0, 4, 8], 11)
    want = np.asarray(ref.server.answer(jax.numpy.asarray(qs)))
    got = port.server.answer(u32_to_torch(qs, CPU))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    cols = np.asarray(client.recover_batch(jax.numpy.asarray(want), secrets))
    port_cols = pir.PIRClient(port.cfg, port.hint).recover_batch(
        got, u32_to_torch(np.asarray(secrets), CPU))
    np.testing.assert_array_equal(port_cols.numpy(), cols)
    queries = corp.embeddings[[3, 90, 199]]
    wtop = ref.query_batch(queries, top_k=4, seed=2)
    gtop = port.query_batch(queries, top_k=4,
                            generator=torch.Generator().manual_seed(2))
    assert [[(d, t) for d, _, t in g] for g in gtop] == \
        [[(d, t) for d, _, t in w] for w in wtop]


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_live_and_batch_equal_reference(corp, shards):
    ref = JLiveIndex.build(corp.texts, corp.embeddings, n_clusters=6,
                           impl="xla", kmeans_iters=5)
    ref.system.enable_batch(kappa=2, seed=13)
    port = convert.live_from_state(
        corp.texts, corp.embeddings,
        centroids=np.asarray(ref.system.centroids),
        assignment=ref.system.assignment, n_clusters=6,
        a_seed=ref.system.cfg.a_seed, mesh=_mesh(shards),
        batch=dict(kappa=2, n_buckets=ref.system.batch.partition.n_buckets,
                   seed=13))
    for live in (ref, port):
        live.replace(7, b"rewritten seven", corp.embeddings[7])
        live.delete(31)
        live.insert(9_000, b"new", corp.embeddings[70])
    want, got = ref.commit(), port.commit()
    np.testing.assert_array_equal(got.cols, want.cols)
    np.testing.assert_array_equal(got.delta, want.delta)
    np.testing.assert_array_equal(u32_to_numpy(port.system.hint),
                                  np.asarray(ref.system.hint))
    full = torch.cat(port.system.server.db).numpy()
    np.testing.assert_array_equal(full[:ref.system.db.m],
                                  np.asarray(ref.system.server.db)
                                  [:ref.system.db.m])
    jbs, tbs = ref.system.batch.server, port.system.batch.server
    for b in range(len(jbs.sub_dbs)):
        np.testing.assert_array_equal(tbs.sub_dbs[b].numpy(),
                                      np.asarray(jbs.sub_dbs[b]))
        np.testing.assert_array_equal(u32_to_numpy(tbs.hints[b]),
                                      np.asarray(jbs.hints[b]))


@pytest.mark.parametrize("shards", (2, 4))
def test_sharded_keyed_rows_equal_reference(shards):
    table = np.random.default_rng(6).standard_normal((80, 5)).astype(
        np.float32)
    kw = dict(kappa=2, chunk_size=90)
    jsys = jpipeline.PirRagSystem.build_keyed(table, impl="xla", **kw)
    tsys = pipeline.PirRagSystem.build_keyed(table, mesh=_mesh(shards), **kw)
    np.testing.assert_array_equal(u32_to_numpy(tsys.hint),
                                  np.asarray(jsys.hint))
    for b in range(len(jsys.batch.server.sub_dbs)):
        np.testing.assert_array_equal(
            u32_to_numpy(tsys.batch.server.hints[b]),
            np.asarray(jsys.batch.server.hints[b]))
    ids = [0, 79, 13, 13]
    rows, _ = tsys.lookup(ids, generator=torch.Generator().manual_seed(4))
    jrows, _ = jsys.lookup(ids, key=jax.random.PRNGKey(4))
    np.testing.assert_array_equal(rows, np.asarray(jrows))
    np.testing.assert_array_equal(rows, table[ids])


@pytest.mark.parametrize("shards", (1, 2, 3, 4, 8))
def test_bucket_layout_matches_reference(shards):
    rng = np.random.default_rng(shards)
    for n_b in (1, 5, 12, 24):
        heights = rng.integers(0, 4000, n_b)
        heights[rng.random(n_b) < 0.3] = 128
        got = collectives.balanced_bucket_order(heights, shards)
        want = jcollectives.balanced_bucket_order(heights, shards)
        np.testing.assert_array_equal(got, want)
        for order in (None, got):
            np.testing.assert_array_equal(
                collectives.shard_row_loads(heights, shards, order),
                jcollectives.shard_row_loads(heights, shards, order))


def test_reference_mesh_build_equals_port_sharded(tmp_path):
    """The reference's own ``mesh=`` build over 4 fake XLA devices (600
    docs): its row shards, hint and sharded answers, reproduced by the
    port's sharded system from the same clustering."""
    out = tmp_path / "ref.npz"
    run_sub(f"""
from repro.core import pipeline, pir
from repro.data import corpus as corpus_lib
corp = corpus_lib.make_corpus(4, 600, emb_dim=16, n_topics=8)
mesh = jax.make_mesh((4,), ("chunks",))
sys4 = pipeline.PirRagSystem.build(corp.texts, corp.embeddings, n_clusters=10,
                                   impl="xla", kmeans_iters=5, chunk_size=90,
                                   mesh=mesh)
client = pir.PIRClient(sys4.cfg, sys4.hint)
qs = jnp.stack([client.query(jax.random.PRNGKey(3 + i), c)[0]
                for i, c in enumerate([0, 5, 9, 5])], axis=1)
ans = sys4.server.answer(qs)
np.savez({str(out)!r}, cents=np.asarray(sys4.centroids),
         assign=sys4.assignment, a_seed=sys4.cfg.a_seed,
         shards=np.stack(sys4.db.row_shards), hint=np.asarray(sys4.hint),
         qs=np.asarray(qs), ans=np.asarray(ans))
print("OK")
""", n_devices=4, timeout=300)
    ref = np.load(out)
    corp = jcorpus.make_corpus(4, 600, emb_dim=16, n_topics=8)
    port = convert.system_from_state(
        corp.texts, corp.embeddings, centroids=ref["cents"],
        assignment=ref["assign"], n_clusters=10, a_seed=int(ref["a_seed"]),
        chunk_size=90, mesh=_mesh(4))
    assert ref["shards"].shape[0] == 4
    for host, dev, want in zip(port.db.row_shards, port.server.db,
                               ref["shards"]):
        np.testing.assert_array_equal(host, want)
        np.testing.assert_array_equal(dev.numpy(), want)
    np.testing.assert_array_equal(u32_to_numpy(port.hint), ref["hint"])
    got = port.server.answer(u32_to_torch(ref["qs"], CPU))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  ref["ans"].astype(np.uint32))
