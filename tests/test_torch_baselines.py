"""The port's baselines and quality metrics against the JAX package's, on
the CPU.

Tiptoe-style scoring, graph-PIR and the per-document content PIR run
through both packages on ``make_corpus(0, 400, emb_dim=48, n_topics=10)``,
the reference with ``impl="xla"`` as ``tests/test_baselines.py`` runs it.
`convert.tiptoe_from_state` and `convert.graph_from_state` carry the
reference's k-means outcome across (the builds' only float draws); from
there every integer and byte path must be equal bit for bit, and every
search must return the same ids and accounting.  The decode is exact, so
the LWE draws do not change what a search returns.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import chunking as jchunking
from repro.core import lwe as jlwe
from repro.core import pipeline as jpipeline
from repro.core.baselines import common as jcommon
from repro.core.baselines import graph_pir as jgraph
from repro.core.baselines import tiptoe as jtiptoe
from repro.data import corpus as jcorpus
from repro.data import metrics as jmetrics
from repro_torch import convert
from repro_torch._common import u32_to_numpy, u32_to_torch
from repro_torch.core import chunking, pir
from repro_torch.core.baselines import common, graph_pir, tiptoe
from repro_torch.data import corpus, metrics

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def corp():
    return jcorpus.make_corpus(0, 400, emb_dim=48, n_topics=10)


def _assignment(tsys, n):
    """The doc → cluster map a reference Tiptoe build used."""
    assign = np.full(n, -1, np.int64)
    for j, ids in enumerate(tsys.cluster_doc_ids):
        assign[ids] = j
    assert (assign >= 0).all()
    return assign


@pytest.fixture(scope="module")
def tiptoe_pair(corp):
    ref = jtiptoe.TiptoeSystem.build(corp.embeddings, n_clusters=10,
                                     impl="xla", seed=1)
    port = convert.tiptoe_from_state(
        corp.embeddings, centroids=ref.centroids,
        assignment=_assignment(ref, len(corp.texts)), n_clusters=10, seed=1,
        device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def graph_pair(corp):
    ref = jgraph.GraphPIRSystem.build(corp.embeddings, degree=12, n_entry=4,
                                      impl="xla")
    port = convert.graph_from_state(corp.embeddings,
                                    entry_points=ref.entry_points, degree=12,
                                    device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def content_pair(corp):
    ref = jcommon.DocContentPIR.build(corp.texts, corp.embeddings,
                                      impl="xla")
    port = common.DocContentPIR.build(corp.texts, corp.embeddings,
                                      device="cpu")
    return ref, port


def _queries(corp, n, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(corp.texts), n)
    return (corp.embeddings[idx]
            + 0.02 * rng.standard_normal((n, corp.d))).astype(np.float32)


# ---------------------------------------------------------------------------
# numpy twins
# ---------------------------------------------------------------------------

def test_metrics_equal_reference_on_random_rankings():
    rng = np.random.default_rng(5)
    for _ in range(20):
        relevant = rng.permutation(200)[:int(rng.integers(0, 40))]
        gains = np.linspace(1.0, 0.1, len(relevant)).astype(np.float32)
        retrieved = rng.permutation(200)[:int(rng.integers(0, 60))]
        for k in (1, 10, 50):
            assert metrics.ndcg_at_k(retrieved, relevant, gains, k) == \
                jmetrics.ndcg_at_k(retrieved, relevant, gains, k)
            assert metrics.precision_at_k(retrieved, relevant, k) == \
                jmetrics.precision_at_k(retrieved, relevant, k)
            assert metrics.recall_at_k(retrieved, relevant, k) == \
                jmetrics.recall_at_k(retrieved, relevant, k)
        assert metrics.dcg(gains) == jmetrics.dcg(gains)


@pytest.mark.parametrize("topical", [False, True])
def test_make_queries_equal_arrays(topical):
    kw = dict(emb_dim=24, n_topics=6, topic_spread=1.0, encoder_noise=0.3)
    ref_c = jcorpus.make_corpus(2, 300, **kw)
    port_c = corpus.make_corpus(2, 300, **kw)
    want = jcorpus.make_queries(3, ref_c, 7, n_relevant=20, noise=0.4,
                                topical=topical)
    got = corpus.make_queries(3, port_c, 7, n_relevant=20, noise=0.4,
                              topical=topical)
    np.testing.assert_array_equal(got.embeddings, want.embeddings)
    for g, w in zip(got.relevant + got.gains, want.relevant + want.gains):
        np.testing.assert_array_equal(g, w)


def test_fit_quant_and_quantize_equal(corp):
    want = jcommon.fit_quant(corp.embeddings, 11)
    got = common.fit_quant(corp.embeddings, 11)
    assert (got.levels, got.scale) == (want.levels, want.scale)
    np.testing.assert_array_equal(got.quantize(corp.embeddings),
                                  want.quantize(corp.embeddings))
    stored = want.quantize(corp.embeddings)
    np.testing.assert_array_equal(got.unshift(stored), want.unshift(stored))


def test_quantize_rows_and_doc_records_byte_equal(corp):
    q, scale, off = chunking.quantize_rows(corp.embeddings)
    rows = chunking.doc_records(corp.texts, corp.embeddings)
    assert rows.shape[1] % 64 == 0
    for i, emb in enumerate(corp.embeddings):
        wq, ws, wo = jchunking.quantize_embedding(emb)
        np.testing.assert_array_equal(q[i], wq)
        assert (scale[i], off[i]) == (np.float32(ws), np.float32(wo))
        rec = jchunking.serialize_doc(i, emb, corp.texts[i])
        assert rows[i, :len(rec)].tobytes() == rec
        assert not rows[i, len(rec):].any()


def test_knn_and_nav_graph_equal(corp):
    np.testing.assert_array_equal(
        graph_pir.build_knn_graph(corp.embeddings, 12, device="cpu"),
        jgraph.build_knn_graph(corp.embeddings, 12))
    np.testing.assert_array_equal(
        graph_pir.build_nav_graph(corp.embeddings, 12, 4, seed=3,
                                  device="cpu"),
        jgraph.build_nav_graph(corp.embeddings, 12, 4, seed=3))


def test_knn_graph_over_several_blocks(corp, monkeypatch):
    """Row blocks of the similarity product, the diagonal of each masked at
    its own offset, give the one-block graph."""
    monkeypatch.setattr(graph_pir, "KNN_BLOCK", 96)
    np.testing.assert_array_equal(
        graph_pir.build_knn_graph(corp.embeddings, 7, device="cpu"),
        jgraph.build_knn_graph(corp.embeddings, 7))


@pytest.mark.parametrize("bits", [64, 128])
def test_sketches_and_node_records_byte_equal(corp, bits):
    proj = graph_pir.sketch_matrix(4, corp.d, bits)
    np.testing.assert_array_equal(proj, jgraph.sketch_matrix(4, corp.d, bits))
    sk = graph_pir.embed_sketches(corp.embeddings, proj)
    np.testing.assert_array_equal(sk, jgraph.embed_sketches(corp.embeddings,
                                                            proj))
    graph = jgraph.build_nav_graph(corp.embeddings, 6, 2, seed=1)
    rows = graph_pir.node_records(corp.embeddings, graph, sk)
    for i in range(len(graph)):
        want = jgraph._serialize_node(corp.embeddings[i], graph[i],
                                      sk[graph[i]])
        assert rows[i].tobytes() == want


# ---------------------------------------------------------------------------
# Tiptoe-style scoring
# ---------------------------------------------------------------------------

def test_tiptoe_state_bitwise(tiptoe_pair):
    ref, port = tiptoe_pair
    assert port.quant == port.quant.__class__(ref.quant.levels,
                                              ref.quant.scale)
    assert port.a_seed == ref.a_seed and port.params.p == ref.params.p
    np.testing.assert_array_equal(port.centroids, ref.centroids)
    for j in range(10):
        np.testing.assert_array_equal(port.cluster_mats[j].numpy(),
                                      ref.cluster_mats[j])
        np.testing.assert_array_equal(port.cluster_doc_ids[j],
                                      ref.cluster_doc_ids[j])
        np.testing.assert_array_equal(port.cluster_rowsums[j],
                                      ref.cluster_rowsums[j])
        np.testing.assert_array_equal(u32_to_numpy(port.hints[j]),
                                      np.asarray(ref.hints[j]))


def test_tiptoe_encrypt_embedding_bitwise(tiptoe_pair, corp):
    """With the reference's secret and errors injected, the ciphertext is
    the reference's."""
    ref, port = tiptoe_pair
    key = jax.random.PRNGKey(9)
    q = ref.quant.quantize(corp.embeddings[5])
    a_ref = jax.numpy.asarray(u32_to_numpy(port.a_mat))
    want_ct, want_s = jcommon.encrypt_embedding(key, q, ref.params, a_ref)
    _, k_err = jax.random.split(key)
    err = jlwe.sample_error(k_err, (corp.d,), ref.params.sigma)
    ct, s = common.encrypt_embedding(
        None, q, port.params, port.a_mat,
        secret=u32_to_torch(np.asarray(want_s), CPU),
        errors=u32_to_torch(np.asarray(err), CPU))
    np.testing.assert_array_equal(u32_to_numpy(ct), np.asarray(want_ct))
    np.testing.assert_array_equal(u32_to_numpy(s), np.asarray(want_s))


def test_tiptoe_search_equal(tiptoe_pair, corp):
    ref, port = tiptoe_pair
    for qi, q in enumerate(_queries(corp, 8, seed=11)):
        want, wst = ref.search(q, top_k=10, key=jax.random.PRNGKey(qi))
        got, gst = port.search(
            q, top_k=10, generator=torch.Generator().manual_seed(qi))
        np.testing.assert_array_equal(got, want)
        for f in ("uplink_bytes", "downlink_bytes", "cluster_index"):
            assert getattr(gst, f) == getattr(wst, f), f
        assert gst.server_ms >= 0


def test_tiptoe_scores_match_plaintext_quantized(tiptoe_pair, corp):
    """The ids are those the plaintext quantized products rank first."""
    _, port = tiptoe_pair
    q = corp.embeddings[123] + 0.01
    ids, st = port.search(q, top_k=5, generator=torch.Generator().manual_seed(2))
    cl = st.cluster_index
    dq = port.quant.unshift(port.cluster_mats[cl].numpy())
    qq = port.quant.unshift(port.quant.quantize(q.astype(np.float32)))
    oracle = port.cluster_doc_ids[cl][np.argsort(-(dq @ qq))[:5]]
    np.testing.assert_array_equal(ids, oracle)


# ---------------------------------------------------------------------------
# Graph-PIR
# ---------------------------------------------------------------------------

def test_graph_state_bitwise(graph_pair):
    ref, port = graph_pair
    assert port.cfg.m == ref.cfg.m and port.cfg.n == ref.cfg.n
    assert port.cfg.params.p == ref.cfg.params.p == 256
    np.testing.assert_array_equal(port.server.db.numpy(),
                                  np.asarray(ref.server.db))
    np.testing.assert_array_equal(u32_to_numpy(port.hint),
                                  np.asarray(ref.hint))
    assert port.graph_degree == ref.graph_degree


def test_graph_search_equal(graph_pair, corp):
    ref, port = graph_pair
    for qi in range(4):
        q = corp.embeddings[qi * 37] + 0.02
        want, wst = ref.search(q, top_k=10, beam=8, max_hops=6, seed=qi)
        got, gst = port.search(q, top_k=10, beam=8, max_hops=6, seed=qi)
        np.testing.assert_array_equal(got, want)
        for f in ("hops", "uplink_bytes", "downlink_bytes", "fetched_nodes"):
            assert getattr(gst, f) == getattr(wst, f), f


def test_graph_build_on_its_own(corp):
    """The port's own build (its k-means picks the entry points) walks to
    the query's neighbourhood, as the reference's recall test asks."""
    sysm = graph_pir.GraphPIRSystem.build(corp.embeddings, degree=12,
                                          n_entry=4, device="cpu")
    assert 1 <= len(sysm.entry_points) <= 4
    assert sysm.index_seconds > 0 and sysm.hint_seconds > 0
    assert sysm.setup_seconds >= sysm.index_seconds + sysm.hint_seconds
    nn = corp.embeddings / np.linalg.norm(corp.embeddings, axis=1,
                                          keepdims=True)
    recalls = []
    for qi in range(3):
        q = corp.embeddings[qi * 37] + 0.02
        ids, _ = sysm.search(q, top_k=10, beam=8, max_hops=6, seed=qi)
        oracle = np.argsort(-(nn @ (q / np.linalg.norm(q))))[:10]
        recalls.append(len(set(ids.tolist()) & set(oracle.tolist())) / 10)
    assert np.mean(recalls) >= 0.7


# ---------------------------------------------------------------------------
# Per-document content PIR
# ---------------------------------------------------------------------------

def test_doc_content_db_and_hint_bitwise(content_pair):
    ref, port = content_pair
    assert (port.cfg.m, port.cfg.n) == (ref.cfg.m, ref.cfg.n)
    np.testing.assert_array_equal(port.server.db.numpy(),
                                  np.asarray(ref.server.db))
    np.testing.assert_array_equal(u32_to_numpy(port.hint),
                                  np.asarray(ref.hint))
    assert port.per_fetch_uplink == ref.per_fetch_uplink
    assert port.per_fetch_downlink == ref.per_fetch_downlink


def test_doc_content_fetch_equal(content_pair, corp):
    ref, port = content_pair
    for did in (0, 57, 399):
        want = ref.fetch(jax.random.PRNGKey(did), did)
        got = port.fetch(torch.Generator().manual_seed(did), did)
        assert got[0] == want[0] == did and got[2] == want[2] == \
            corp.texts[did]
        np.testing.assert_array_equal(got[1], want[1])
    got = port.fetch_many(3, [5, 6, 7])
    want = ref.fetch_many(3, [5, 6, 7])
    assert [(d, t) for d, _, t in got] == [(d, t) for d, _, t in want]


# ---------------------------------------------------------------------------
# the slice: a quality.run-shaped loop through both packages
# ---------------------------------------------------------------------------

def _score(ids, rel, gains, k=10):
    return (metrics.ndcg_at_k(ids, rel, gains, k),
            metrics.precision_at_k(ids, rel, k),
            metrics.recall_at_k(ids, rel, 50))


def test_quality_loop_equal(corp, tiptoe_pair, graph_pair, content_pair):
    """Every system returns the reference's ids for every query, so NDCG@10,
    P@10 and R@50 are equal; the baselines' content tails fetch the same
    documents."""
    t_ref, t_port = tiptoe_pair
    g_ref, g_port = graph_pair
    c_ref, c_port = content_pair
    p_ref = jpipeline.PirRagSystem.build(corp.texts, corp.embeddings,
                                         n_clusters=10, impl="xla", seed=2)
    p_port = convert.system_from_state(
        corp.texts, corp.embeddings, centroids=np.asarray(p_ref.centroids),
        assignment=p_ref.assignment, n_clusters=10, a_seed=p_ref.cfg.a_seed,
        device="cpu")
    qs = jcorpus.make_queries(1, corp, 3, n_relevant=30, noise=0.4)
    for qi in range(3):
        q, rel, gains = qs.embeddings[qi], qs.relevant[qi], qs.gains[qi]
        top, _ = p_ref.query(q, top_k=10, key=jax.random.PRNGKey(qi))
        want = np.array([d for d, _, _ in top])
        top, _ = p_port.query(q, top_k=10,
                              generator=torch.Generator().manual_seed(qi))
        got = np.array([d for d, _, _ in top])
        np.testing.assert_array_equal(got, want)
        assert _score(got, rel, gains) == tuple(
            f(want, rel, *a) for f, a in (
                (jmetrics.ndcg_at_k, (gains, 10)),
                (jmetrics.precision_at_k, (10,)),
                (jmetrics.recall_at_k, (50,))))

        want, _ = t_ref.search(q, top_k=10, key=jax.random.PRNGKey(qi))
        got, _ = t_port.search(q, top_k=10,
                               generator=torch.Generator().manual_seed(qi))
        np.testing.assert_array_equal(got, want)
        assert _score(got, rel, gains) == _score(want, rel, gains)

        want, _ = g_ref.search(q, top_k=10, beam=8, max_hops=6, seed=qi)
        got, _ = g_port.search(q, top_k=10, beam=8, max_hops=6, seed=qi)
        np.testing.assert_array_equal(got, want)
        assert _score(got, rel, gains) == _score(want, rel, gains)

        fetched = c_port.fetch_many(1000 + qi, got[:3])
        assert [d for d, _, _ in fetched] == got[:3].tolist()
        assert [t for _, _, t in fetched] == [
            t for _, _, t in c_ref.fetch_many(1000 + qi, want[:3])]


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def test_entry_points_raise_without_a_card(corp):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    e, t = corp.embeddings[:40], corp.texts[:40]
    calls = (
        lambda: tiptoe.TiptoeSystem.build(e, n_clusters=2),
        lambda: graph_pir.GraphPIRSystem.build(e),
        lambda: graph_pir.build_knn_graph(e, 4),
        lambda: common.DocContentPIR.build(t, e),
        lambda: convert.tiptoe_from_state(
            e, centroids=e[:2], assignment=np.zeros(40, int), n_clusters=2),
        lambda: convert.graph_from_state(e, entry_points=np.zeros(1, int)),
    )
    for fn in calls:
        with pytest.raises(RuntimeError, match="device"):
            fn()


def test_byte_plaintext_guard():
    """Above about 716,000 columns `make_config` picks p = 128; a baseline
    PIR refuses it instead of decoding bytes >= 128 wrong."""
    ok = pir.make_config(64, 700_000)
    assert ok.params.p == 256
    common.require_byte_plaintext(ok)
    low = pir.make_config(64, 800_000)
    assert low.params.p == 128
    with pytest.raises(ValueError, match=r"n=800000.*p=128"):
        common.require_byte_plaintext(low)


# ---------------------------------------------------------------------------
# the chip check's baseline phases, rehearsed
# ---------------------------------------------------------------------------

def test_chip_smoke_baseline_phases_rehearse():
    """`chip_smoke.py`'s phases G and Q at the rehearsal size, through the
    plain versions: every gate passes and each system prints its line."""
    import runpy
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    cs = runpy.run_path(str(path), run_name="chip_smoke")
    card, cfg = cs["Card"](True), cs["TINY"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)         # as the rehearsal runs: tiny shapes
    try:
        _rehearse_g_and_q(cs, card, cfg)
    finally:
        torch.set_num_threads(threads)


def _rehearse_g_and_q(cs, card, cfg):
    lines, kept = cs["phase_g"](card, cfg)
    systems = {ln["system"]: ln for ln in lines if ln["phase"] == "G system"}
    assert set(systems) == {"pir_rag", "tiptoe", "graph_pir"}
    assert systems["pir_rag"]["rag_ready_s"] == systems["pir_rag"]["query_s"]
    assert systems["tiptoe"]["ids_equal_plaintext"] == cfg["g_queries"]
    assert systems["tiptoe"]["clusters_equal_plain"] == cfg["g_queries"]
    assert systems["graph_pir"]["records_checked"] > 0
    timing = cs["g_timing"](card, cfg, kept)
    assert {ln.get("op") for ln in timing} >= {
        "content hint", "content fetch answer", "graph hint",
        "graph hop answer", "tiptoe hint", "tiptoe score"}
    assert all(ln["max_abs_err"] == 0 for ln in timing if "op" in ln)
    knn = next(ln for ln in timing if ln["phase"] == "G knn")
    assert knn["max_similarity_gap"] <= knn["tolerance"]
    q = cs["phase_q"](card, cfg)
    rows = {ln["system"]: ln for ln in q if ln["phase"] == "Q system"}
    checked = next(ln for ln in q if ln["phase"] == "Q")
    assert checked["tiptoe_clusters_and_ids_checked"] == (cfg["q_builds"]
                                                          * cfg["q_queries"])
    assert rows["pir_rag"]["t_rag_ready_s"] == rows["pir_rag"]["t_retrieval_s"]
    for s in ("tiptoe", "graph_pir"):
        assert rows[s]["t_rag_ready_s"] > rows[s]["t_retrieval_s"]
        assert 0.0 <= rows[s]["ndcg10"] <= 1.0
