"""The port's offline build pieces against the JAX package.

Corpus and packing are host numpy copies and must give identical bytes; the
balanced assignment is identical given the same distances; Lloyd from the
reference's own kmeans++ seeds lands on the reference's centroids (atol
1e-4: the two frameworks sum in different orders) and assignment.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import chunking as jchunking
from repro.core import clustering as jclustering
from repro.data import corpus as jcorpus
from repro_torch.core import chunking, clustering, threefry
from repro_torch.data import corpus

CPU = torch.device("cpu")


@pytest.mark.parametrize("kw", [dict(emb_dim=64, n_topics=16),
                                dict(emb_dim=32, n_topics=4, encoder_noise=0.3)])
def test_make_corpus_identical(kw):
    want = jcorpus.make_corpus(3, 300, **kw)
    got = corpus.make_corpus(3, 300, **kw)
    assert got.texts == want.texts
    for f in ("embeddings", "latent", "topics"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.d == want.d


@pytest.mark.parametrize("n_clusters,chunk", [(7, 256), (16, 64)])
def test_build_chunked_db_identical(n_clusters, chunk):
    corp = corpus.make_corpus(1, 400, emb_dim=24, n_topics=8)
    assign = np.random.default_rng(0).integers(0, n_clusters, 400)
    assign[assign == 3] = 4                       # one empty column
    ids = np.arange(400) * 3 + 11
    want = jchunking.build_chunked_db(corp.texts, corp.embeddings, assign,
                                      n_clusters, chunk, doc_ids=ids)
    got = chunking.build_chunked_db(corp.texts, corp.embeddings, assign,
                                    n_clusters, chunk, doc_ids=ids)
    np.testing.assert_array_equal(got.matrix, want.matrix)
    np.testing.assert_array_equal(got.cluster_sizes, want.cluster_sizes)
    np.testing.assert_array_equal(got.used_bytes, want.used_bytes)
    assert (got.m, got.n, got.pad_fraction) == (want.m, want.n,
                                                 want.pad_fraction)
    for j in range(n_clusters):
        a = chunking.deserialize_docs(got.matrix[:, j], 24)
        b = jchunking.deserialize_docs(want.matrix[:, j], 24)
        assert [(i, t) for i, _, t in a] == [(i, t) for i, _, t in b]


@pytest.mark.parametrize("seed,k,slack", [(0, 8, 1.0), (1, 13, 1.2),
                                          (2, 5, 1.05)])
def test_balanced_assign_identical(seed, k, slack):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((300, 12)).astype(np.float32)
    c = rng.standard_normal((k, 12)).astype(np.float32)
    cap = int(np.ceil(300 / k * slack))
    d2 = np.asarray(jclustering.blocked_sqdist(x, c))
    want = jclustering.balanced_assign(x, c, cap, d2=d2)
    np.testing.assert_array_equal(
        clustering.balanced_assign(x, c, cap, d2=d2), want)
    np.testing.assert_array_equal(clustering.balanced_assign(x, c, cap),
                                  jclustering.balanced_assign(x, c, cap))


def test_blocked_sqdist_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((203, 16)).astype(np.float32)
    c = rng.standard_normal((9, 16)).astype(np.float32)
    got = clustering.blocked_sqdist(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jclustering.blocked_sqdist(x, c)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,k,blocks", [(600, 8, 8), (1001, 16, 8)])
def test_lloyd_from_reference_seeds_matches_kmeans_fit(n, k, blocks):
    corp = corpus.make_corpus(2, n, emb_dim=32, n_topics=k)
    key = jax.random.PRNGKey(9)
    want = jclustering.kmeans_fit(key, corp.embeddings, k=k, iters=10,
                                  n_blocks=blocks, impl="xla")
    xp, valid = jclustering._pad_rows(jnp.asarray(corp.embeddings), blocks)
    cents0 = jclustering._kmeanspp(key, xp, valid, k, n, None)
    cents, assign, inertia = clustering._lloyd(
        torch.from_numpy(np.array(xp)), torch.from_numpy(np.array(valid)),
        torch.from_numpy(np.array(cents0)), k=k, iters=10, blocks=blocks,
        n=n, impl="auto")
    np.testing.assert_allclose(cents.numpy(), np.asarray(want.centroids),
                               atol=1e-4)
    np.testing.assert_array_equal(assign[:n].numpy(),
                                  np.asarray(want.assignment))
    np.testing.assert_allclose(float(inertia), float(want.inertia), rtol=1e-4)


def test_kmeans_fit_is_deterministic_and_recovers_topics():
    corp = corpus.make_corpus(0, 800, emb_dim=32, n_topics=8,
                              topic_spread=0.2)
    x = torch.from_numpy(corp.embeddings)
    runs = [clustering.kmeans_fit(threefry.torch_generator((0, 5), CPU), x,
                                  k=8, iters=15, n_blocks=8)
            for _ in range(2)]
    assert torch.equal(runs[0].centroids, runs[1].centroids)
    assert torch.equal(runs[0].assignment, runs[1].assignment)
    # every cluster is (almost) one planted topic
    a = runs[0].assignment.numpy()
    purity = sum(np.bincount(corp.topics[a == j]).max()
                 for j in range(8) if (a == j).any()) / len(a)
    assert purity > 0.9
    np.testing.assert_array_equal(
        clustering.assign_to_centroids(x, runs[0].centroids).numpy(), a)


def test_empty_cluster_keeps_its_centroid():
    x = torch.zeros((16, 2))
    x[8:] = 1.0
    cents0 = torch.tensor([[0.0, 0.0], [1.0, 1.0], [50.0, 50.0]])
    cents, assign, _ = clustering._lloyd(
        x, torch.ones(16, dtype=torch.bool), cents0, k=3, iters=3, blocks=8,
        n=16, impl="auto")
    assert torch.equal(cents[2], cents0[2])
    assert set(assign.tolist()) == {0, 1}
