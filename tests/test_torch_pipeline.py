"""The port's `PirRagSystem` against the JAX package's on the quickstart
corpus (1200 docs, d = 64, 16 clusters, balance factor 1.3).

`convert.system_from_state` carries the reference's clustering across; from
there the DB bytes and the hint must be equal, and every query must return
the same top-k ids (scores within 1e-6) with the same byte accounting.  The
port's own `build` must retrieve the anchor document, as the quickstart
example asserts.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import pipeline as jpipeline
from repro.data import corpus as jcorpus
from repro_torch import convert
from repro_torch._common import u32_to_numpy
from repro_torch.core import pipeline

N_CLUSTERS = 16


@pytest.fixture(scope="module")
def corp():
    return jcorpus.make_corpus(0, n_docs=1200, emb_dim=64, n_topics=16)


@pytest.fixture(scope="module")
def pair(corp):
    ref = jpipeline.PirRagSystem.build(corp.texts, corp.embeddings,
                                       n_clusters=N_CLUSTERS, impl="xla",
                                       balance_factor=1.3)
    port = convert.system_from_state(
        corp.texts, corp.embeddings, centroids=np.asarray(ref.centroids),
        assignment=ref.assignment, n_clusters=N_CLUSTERS,
        a_seed=ref.cfg.a_seed, device="cpu")
    return ref, port


def _queries(corp, anchors, seed=1):
    rng = np.random.default_rng(seed)
    q = corp.embeddings[anchors] + 0.05 * rng.standard_normal(
        (len(anchors), corp.d))
    return q.astype(np.float32)


def _same_top(got, want):
    assert [d for d, _, _ in got] == [d for d, _, _ in want]
    assert [t for _, _, t in got] == [t for _, _, t in want]
    np.testing.assert_allclose([s for _, s, _ in got],
                               [s for _, s, _ in want], rtol=0, atol=1e-6)


def test_converted_state_has_same_db_and_hint(pair):
    ref, port = pair
    np.testing.assert_array_equal(port.db.matrix, ref.db.matrix)
    np.testing.assert_array_equal(port.server.db.numpy(), ref.db.matrix)
    np.testing.assert_array_equal(u32_to_numpy(port.hint), np.asarray(ref.hint))
    assert port.cfg.a_seed == ref.cfg.a_seed
    assert port.cfg.params == port.cfg.params.__class__(
        **{f: getattr(ref.cfg.params, f)
           for f in ("k", "p", "sigma", "z_tail", "q_switch")})
    assert port.device == torch.device("cpu")


@pytest.mark.parametrize("anchor,probes", [(37, 1), (5, 1), (900, 2)])
def test_query_matches_reference(corp, pair, anchor, probes):
    ref, port = pair
    q = _queries(corp, [anchor])[0]
    want, wstats = ref.query(q, top_k=5, multi_probe=probes,
                             key=jax.random.PRNGKey(42))
    got, gstats = port.query(q, top_k=5, multi_probe=probes,
                             generator=torch.Generator().manual_seed(42))
    _same_top(got, want)
    for f in ("uplink_bytes", "downlink_bytes", "hint_bytes", "cluster_index",
              "mode", "probes", "n_buckets"):
        assert getattr(gstats, f) == getattr(wstats, f), f
    assert gstats.server_ms > 0 and gstats.client_ms > 0


def test_query_batch_matches_reference(corp, pair):
    ref, port = pair
    anchors = [3, 37, 111, 640, 1199, 37]
    qs = _queries(corp, anchors, seed=2)
    top_k = [10, 5, 3, 10, 1, 7]
    want = ref.query_batch(qs, top_k=top_k, seed=7)
    gen = torch.Generator().manual_seed(7)
    got = port.query_batch(qs, top_k=top_k, generator=gen)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_top(g, w)
    inflight = port.query_batch_async(qs, top_k=top_k, multi_probe=2)
    assert inflight.pending[0].shape == (port.cfg.m, 2 * len(anchors))
    wide = inflight.complete()
    want2 = ref.query_batch(qs, top_k=top_k, multi_probe=2, seed=8)
    for g, w in zip(wide, want2):
        _same_top(g, w)
    with pytest.raises(RuntimeError, match="twice"):
        inflight.complete()


def test_port_build_retrieves_anchor(corp):
    system = pipeline.PirRagSystem.build(corp.texts, corp.embeddings,
                                         n_clusters=N_CLUSTERS,
                                         balance_factor=1.3, device="cpu")
    assert system.db.n == N_CLUSTERS
    assert system.cfg.a_seed == jpipeline._derive_build_streams(0)[1]
    sizes = np.bincount(system.assignment, minlength=N_CLUSTERS)
    assert sizes.max() <= int(np.ceil(1200 / N_CLUSTERS * 1.3))
    q = _queries(corp, [37])[0]
    top, stats = system.query(q, top_k=5)
    assert any(d == 37 for d, _, _ in top)
    assert stats.hint_bytes == system.db.m * 1024 * 4
    assert system.setup_seconds >= system.hint_seconds > 0
