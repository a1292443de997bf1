"""The client's host decode against the JAX package's.

`chunking.parse_column` reads a column's record headers in one pass and
dequantizes every embedding in one array operation; `deserialize_docs`
built on it and `rerank.rerank_columns` (one stacked matrix per client)
must give the reference's `deserialize_docs` and `rerank` results on the
same bytes: ids, texts, embeddings and scores bitwise in f32, and the top-k
order, ties included.  Columns come from the reference's own packer, with
empty texts, texts that fill the column, constant embeddings, duplicated
embeddings (tied scores) and a column with no documents.
"""
import numpy as np
import pytest

from repro.core import chunking as jchunking
from repro.core import rerank as jrerank
from repro_torch.core import chunking, rerank

EMB_DIM = 24


def _docs(rng, n, *, text_len=(0, 40), dup_every=0):
    out = []
    for i in range(n):
        if dup_every and i % dup_every == 1:
            emb = out[-1][1].copy()                  # a tied score
        elif i % 11 == 5:
            emb = np.full(EMB_DIM, 0.25, np.float32)  # hi == lo: scale 1
        else:
            emb = rng.standard_normal(EMB_DIM).astype(np.float32)
        t = int(rng.integers(*text_len)) if text_len[1] > text_len[0] \
            else text_len[0]
        out.append((int(rng.integers(0, 1 << 31)), emb,
                    bytes(rng.integers(0, 256, t, dtype=np.uint8))))
    return out


def _column(docs, m):
    payload = jchunking.pack_column(docs)
    col = np.zeros(m, np.uint8)
    col[:len(payload)] = np.frombuffer(payload, np.uint8)
    return col


def _columns(seed):
    rng = np.random.default_rng(seed)
    m = 4096
    cols = [_column(_docs(rng, 30), m),
            _column(_docs(rng, 25, text_len=(0, 1)), m),      # empty texts
            _column(_docs(rng, 20, dup_every=3), m),          # tied scores
            _column([], m)]                                   # no documents
    full_len = m - 4 - chunking.record_bytes(EMB_DIM, 0)
    cols.append(_column(_docs(rng, 1, text_len=(full_len, full_len)), m))
    assert len(jchunking.pack_column(
        jchunking.deserialize_docs(cols[-1], EMB_DIM))) == m   # column full
    return cols


def _same_docs(got, want):
    assert len(got) == len(want)
    for (gi, ge, gt), (wi, we, wt) in zip(got, want):
        assert gi == wi and gt == wt and type(gi) is int
        assert ge.dtype == we.dtype == np.float32
        np.testing.assert_array_equal(ge.view(np.uint32), we.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_deserialize_docs_equals_reference(seed):
    for col in _columns(seed):
        _same_docs(chunking.deserialize_docs(col, EMB_DIM),
                   jchunking.deserialize_docs(col, EMB_DIM))
    # a column read as a strided view of a chunk-transposed matrix
    mat = np.stack(_columns(seed), axis=1)
    for j in range(mat.shape[1]):
        _same_docs(chunking.deserialize_docs(mat[:, j], EMB_DIM),
                   jchunking.deserialize_docs(mat[:, j], EMB_DIM))


def test_parse_column_fields():
    col = _columns(3)[0]
    parsed = chunking.parse_column(col, EMB_DIM)
    want = jchunking.deserialize_docs(col, EMB_DIM)
    assert len(parsed) == len(want) == 30
    assert parsed.ids.tolist() == [d[0] for d in want]
    assert parsed.texts == [d[2] for d in want]
    assert parsed.embs.shape == (30, EMB_DIM)
    assert parsed.embs.dtype == np.float32 and parsed.embs.flags.c_contiguous
    empty = chunking.parse_column(_columns(3)[3], EMB_DIM)
    assert len(empty) == 0 and empty.embs.shape == (0, EMB_DIM)


@pytest.mark.parametrize("seed,top_k", [(0, 1), (1, 5), (2, 10), (4, 200)])
def test_rerank_columns_equals_reference(seed, top_k):
    cols = _columns(seed)
    rng = np.random.default_rng(100 + seed)
    for picks in ([0], [2], [0, 1, 2], [3], [3, 4, 2], [1, 3, 0, 4, 2]):
        q = rng.standard_normal(EMB_DIM).astype(np.float32)
        ref_docs = [d for j in picks
                    for d in jchunking.deserialize_docs(cols[j], EMB_DIM)]
        want = jrerank.rerank(q, ref_docs, top_k)
        got = rerank.rerank_columns(
            q, [chunking.parse_column(cols[j], EMB_DIM) for j in picks],
            top_k)
        assert got == want
        assert [type(s) for _, s, _ in got] == [float] * len(got)


def test_tied_scores_fall_as_in_the_reference():
    """Duplicated embeddings tie; the default sort over the same candidate
    order breaks the ties the same way."""
    rng = np.random.default_rng(9)
    emb = rng.standard_normal(EMB_DIM).astype(np.float32)
    docs = [(i, emb, f"t{i}".encode()) for i in range(12)]
    col = _column(docs, 1024)
    q = rng.standard_normal(EMB_DIM).astype(np.float32)
    want = jrerank.rerank(q, jchunking.deserialize_docs(col, EMB_DIM), 7)
    got = rerank.rerank_columns(q, [chunking.parse_column(col, EMB_DIM)], 7)
    assert got == want
    assert len({s for _, s, _ in got}) == 1
