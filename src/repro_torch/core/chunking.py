"""Chunk-transposed database construction (twin of ``repro/core/chunking.py``).

Host-side numpy, kept byte-identical to the JAX package: each cluster's
documents serialize into one byte column of an (m × n) uint8 matrix, and
retrieving a cluster is privately reading one column.

Per-document record (little-endian):

    [doc_id : u32][text_len : u32][emb_scale : f32][emb_off : f32]
    [emb_q  : u8 × emb_dim]  [text : u8 × text_len]

Column layout: [n_docs : u32][record ...][zero padding to m rows], with
m = max serialized cluster size rounded up to ``chunk_size``.

Packing serializes every document at once (`column_payloads`: one
`quantize_rows` over the corpus, every header in one array), byte for byte
as `pack_column` does one document at a time.  For a row-sharded server
(`build_chunked_db(n_row_shards=S)`) the rows pad to a multiple of S and
``ChunkedDB.row_shards`` holds S equal row slices of one allocation, which
the server places each on its own device.

The live index re-packs only the clusters a mutation batch touches
(`rebuild_columns`, through the same helper); `ColumnOverflowError` is its
signal that a column no longer fits in m rows and the index must be
rebuilt.

`quantize_rows` and `doc_records` serialize every document at once, byte
for byte as `quantize_embedding` and `serialize_doc` do one at a time: one
record per row of an (n_docs, m) matrix, for a PIR with one column per
document.

The client parses a decrypted column with `parse_column`: one pass over
the records' text lengths, then every header and quantized embedding
gathered and dequantized in array operations.  `deserialize_docs` gives
the same (doc_id, embedding, text) triples as the JAX package's, bitwise.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Mapping, Sequence

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

_HDR = 16  # doc_id + text_len + scale + offset
_U32 = struct.Struct("<I")

#: (doc_id, embedding f32 (d,), text bytes) — the canonical document triple.
DocTriple = tuple[int, np.ndarray, bytes]


class ColumnOverflowError(ValueError):
    """A re-packed column no longer fits in the m-row budget (rebuild needed)."""

    def __init__(self, cluster: int, need: int, have: int):
        super().__init__(f"cluster {cluster} needs {need} bytes > m={have}")
        self.cluster = cluster
        self.need = need
        self.have = have


@dataclasses.dataclass(frozen=True)
class ChunkedDB:
    """The chunk-transposed corpus: one uint8 byte column per cluster.

    ``matrix`` is the (m, n) host view.  Packed for S row shards,
    ``row_shards`` holds S equal-height row slices ((m_pad/S, n) each, the
    pad rows zero) that are views of the same allocation, so an in-place
    column patch of ``matrix`` shows through them.
    """
    matrix: np.ndarray            # (m, n) uint8, chunk-transposed
    emb_dim: int
    chunk_size: int
    n_docs: int
    cluster_sizes: np.ndarray     # (n,) docs per cluster
    pad_fraction: float           # wasted bytes / total bytes (reported)
    used_bytes: np.ndarray        # (n,) serialized bytes per column
    row_shards: tuple[np.ndarray, ...] | None = None  # S × (m_pad/S, n)

    @property
    def m(self) -> int:
        """Rows: bytes per column (max serialized cluster, chunk-rounded)."""
        return self.matrix.shape[0]

    @property
    def n(self) -> int:
        """Columns: number of clusters."""
        return self.matrix.shape[1]


def quantize_embedding(emb: np.ndarray) -> tuple[np.ndarray, float, float]:
    """Per-doc affine u8 quantization (client re-ranking tolerates ≤0.4% err)."""
    lo, hi = float(emb.min()), float(emb.max())
    scale = (hi - lo) / 255.0 if hi > lo else 1.0
    q = np.clip(np.round((emb - lo) / scale), 0, 255).astype(np.uint8)
    return q, scale, lo


def dequantize_embedding(q: np.ndarray, scale: float, off: float) -> np.ndarray:
    """Inverse of `quantize_embedding`: u8 (d,) → f32 (d,)."""
    return q.astype(np.float32) * scale + off


def serialize_doc(doc_id: int, emb: np.ndarray, text: bytes) -> bytes:
    """One document's wire record (see module docstring for the layout)."""
    q, scale, off = quantize_embedding(emb)
    hdr = (np.uint32(doc_id).tobytes() + np.uint32(len(text)).tobytes()
           + np.float32(scale).tobytes() + np.float32(off).tobytes())
    return hdr + q.tobytes() + text


def quantize_rows(embs: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """`quantize_embedding` of every row at once, bitwise:
    (q (n, d) u8, scale (n,) f32, offset (n,) f32).

    The per-row scale is formed in float64 as the reference's Python float
    and then applied in float32, as numpy applies a Python float to a
    float32 array.
    """
    embs = np.asarray(embs, np.float32)
    lo, hi = embs.min(axis=1), embs.max(axis=1)
    scale = np.where(hi > lo, (hi.astype(np.float64) - lo) / 255.0, 1.0)
    q = np.clip(np.round((embs - lo[:, None])
                         / scale.astype(np.float32)[:, None]), 0, 255)
    return q.astype(np.uint8), scale.astype(np.float32), lo


def doc_records(texts, embeddings: np.ndarray, *, chunk_size: int = 64
                ) -> np.ndarray:
    """Every document's `serialize_doc` record (doc id = its row),
    zero-padded to m bytes, m = the longest record rounded up to
    ``chunk_size``: (n_docs, m) u8, row-major."""
    n, d = embeddings.shape
    lens = np.fromiter(map(len, texts), np.int64, n)
    raw = _HDR + d + int(lens.max())
    m = -(-raw // chunk_size) * chunk_size
    q, scale, off = quantize_rows(embeddings)
    hdr = np.empty((n, 4), "<u4")
    hdr[:, 0] = np.arange(n)
    hdr[:, 1] = lens
    hdr[:, 2] = scale.view("<u4")
    hdr[:, 3] = off.view("<u4")
    rows = np.zeros((n, m), np.uint8)
    rows[:, :_HDR] = hdr.view(np.uint8)
    rows[:, _HDR:_HDR + d] = q
    at = _HDR + d
    for i, t in enumerate(texts):
        rows[i, at:at + len(t)] = np.frombuffer(t, np.uint8)
    return rows


@dataclasses.dataclass(frozen=True)
class ParsedColumn:
    """One decrypted column's documents, in record order.  Texts stay in
    the column's bytes until asked for (`text`, `texts`)."""
    ids: np.ndarray               # (D,) int64 doc ids
    embs: np.ndarray              # (D, emb_dim) f32 dequantized embeddings
    buf: bytes                    # the column
    text_at: np.ndarray           # (D,) int64 offset of each text in buf
    text_len: np.ndarray          # (D,) int64

    def __len__(self) -> int:
        return len(self.ids)

    def text(self, i: int) -> bytes:
        at = int(self.text_at[i])
        return self.buf[at:at + int(self.text_len[i])]

    @property
    def texts(self) -> list[bytes]:
        return [self.buf[a:a + n] for a, n in
                zip(self.text_at.tolist(), self.text_len.tolist())]


def parse_column(col: np.ndarray, emb_dim: int) -> ParsedColumn:
    """Parse one decrypted column: one pass over the text lengths finds the
    records, then the headers and embeddings are gathered and dequantized
    in array operations (the same f32 operations per element as
    `dequantize_embedding`, so the values are bitwise its)."""
    buf = np.ascontiguousarray(col, np.uint8).tobytes()
    (n_docs,) = _U32.unpack_from(buf, 0)
    starts = [0] * n_docs
    step = _HDR + emb_dim
    unpack = _U32.unpack_from
    ofs = 4
    for i in range(n_docs):
        starts[i] = ofs
        ofs += step + unpack(buf, ofs + 4)[0]
    st = np.asarray(starts, np.int64)
    if n_docs:
        # each record's header and embedding: one row gather of a window
        rec = sliding_window_view(np.frombuffer(buf, np.uint8), step)[st]
    else:
        rec = np.zeros((0, step), np.uint8)
    hdr = np.ascontiguousarray(rec[:, :_HDR])
    words, floats = hdr.view("<u4"), hdr.view("<f4")
    embs = (rec[:, _HDR:].astype(np.float32) * floats[:, 2:3]
            + floats[:, 3:4])
    return ParsedColumn(ids=words[:, 0].astype(np.int64), embs=embs,
                        buf=buf, text_at=st + step,
                        text_len=words[:, 1].astype(np.int64))


def deserialize_docs(col: np.ndarray, emb_dim: int
                     ) -> list[tuple[int, np.ndarray, bytes]]:
    """Parse one decrypted column back into (doc_id, embedding, text)."""
    p = parse_column(col, emb_dim)
    return [(int(i), e, t) for i, e, t in zip(p.ids, p.embs, p.texts)]


def record_bytes(emb_dim: int, text_len: int) -> int:
    """Serialized size of one record: 16-byte header + emb + text."""
    return _HDR + emb_dim + text_len


def column_payload_bytes(emb_dim: int, text_lens: Sequence[int]) -> int:
    """Serialized size of a column holding docs with the given text lengths."""
    return 4 + sum(record_bytes(emb_dim, t) for t in text_lens)


def pack_column(docs: Sequence[DocTriple]) -> bytes:
    """Serialize one cluster's documents (ascending doc_id) into its payload."""
    docs = sorted(docs, key=lambda d: d[0])
    parts = [np.uint32(len(docs)).tobytes()]
    parts += [serialize_doc(int(i), emb, text) for i, emb, text in docs]
    return b"".join(parts)


def column_payloads(texts: Sequence[bytes], embeddings: np.ndarray,
                    doc_ids: np.ndarray, columns: np.ndarray, n_columns: int
                    ) -> list[bytes]:
    """Every column's `pack_column` payload, with the records serialized
    at once.

    Document i (text, embedding row i, id ``doc_ids[i]``) goes to column
    ``columns[i]``; within a column the records are in ascending doc id,
    ties in input order, as `pack_column`'s stable sort leaves them.  The
    embeddings are quantized as float32 (`quantize_rows`), so the bytes are
    `pack_column`'s for float32 embeddings.
    """
    ids = np.asarray(doc_ids)
    columns = np.asarray(columns)
    n = len(ids)
    embs = np.asarray(embeddings, np.float32)
    d = embs.shape[1]
    order = np.lexsort((ids, columns))      # by column, then doc id (stable)
    q, scale, off = quantize_rows(embs)
    fixed = np.empty((n, _HDR + d), np.uint8)
    hdr = np.empty((n, 4), "<u4")
    hdr[:, 0] = ids.astype(np.uint32)
    hdr[:, 1] = np.fromiter(map(len, texts), np.int64, n)
    hdr[:, 2] = scale.view("<u4")
    hdr[:, 3] = off.view("<u4")
    fixed[:, :_HDR] = hdr.view(np.uint8)
    fixed[:, _HDR:] = q
    rows = fixed[order].tobytes()           # records' fixed parts, in order
    w = _HDR + d
    bounds = np.concatenate(
        [[0], np.cumsum(np.bincount(columns, minlength=n_columns))])
    payloads = []
    for j in range(n_columns):
        lo, hi = int(bounds[j]), int(bounds[j + 1])
        parts: list[bytes] = [None] * (2 * (hi - lo) + 1)
        parts[0] = _U32.pack(hi - lo)
        parts[1::2] = [rows[r * w:(r + 1) * w] for r in range(lo, hi)]
        parts[2::2] = [texts[i] for i in order[lo:hi]]
        payloads.append(b"".join(parts))
    return payloads


def rebuild_columns(m: int, docs_by_col: Mapping[int, Sequence[DocTriple]]
                    ) -> tuple[np.ndarray, np.ndarray, dict[int, int]]:
    """Re-serialize the given clusters into fresh m-row columns.

    Returns (sorted cluster ids (J,) int64, new columns (m, J) u8, used
    bytes per cluster).  Raises `ColumnOverflowError` when a payload
    exceeds m.  Each column is byte-identical to a from-scratch pack of the
    same documents (`pack_column` orders them by doc id).
    """
    cols = np.asarray(sorted(docs_by_col), np.int64)
    docs = [(idx, doc) for idx, j in enumerate(cols)
            for doc in docs_by_col[int(j)]]
    embs = (np.stack([e for _, (_, e, _) in docs]) if docs
            else np.zeros((0, 1), np.float32))
    payloads = column_payloads(
        [t for _, (_, _, t) in docs], embs,
        np.asarray([i for _, (i, _, _) in docs], np.int64),
        np.asarray([idx for idx, _ in docs], np.int64), len(cols))
    out = np.zeros((m, len(cols)), np.uint8)
    used: dict[int, int] = {}
    for idx, (j, payload) in enumerate(zip(cols, payloads)):
        if len(payload) > m:
            raise ColumnOverflowError(int(j), len(payload), m)
        out[:len(payload), idx] = np.frombuffer(payload, np.uint8)
        used[int(j)] = len(payload)
    return cols, out, used


def build_chunked_db(texts: Sequence[bytes], embeddings: np.ndarray,
                     assignment: np.ndarray, n_clusters: int,
                     chunk_size: int = 256,
                     doc_ids: Sequence[int] | None = None, *,
                     n_row_shards: int = 1) -> ChunkedDB:
    """Pack the corpus into the chunk-transposed uint8 matrix.

    ``doc_ids`` (default: positional 0..N−1) keeps external document ids.
    ``n_row_shards=S`` packs for a row-sharded server: rows pad up to a
    multiple of S with zeros and ``row_shards`` holds the S row slices.
    The packed bytes are the same for every S, and ``matrix`` is always
    the unpadded (m, n) view.
    """
    n_docs, emb_dim = embeddings.shape
    ids = np.arange(n_docs) if doc_ids is None else np.asarray(doc_ids)
    if len(texts) != n_docs or len(ids) != n_docs:
        raise ValueError(f"{len(texts)} texts and {len(ids)} ids for "
                         f"{n_docs} embeddings")
    if n_row_shards < 1:
        raise ValueError(f"n_row_shards must be >= 1, got {n_row_shards}")
    assignment = np.asarray(assignment)
    columns = column_payloads(texts, embeddings, ids, assignment, n_clusters)
    sizes = np.bincount(assignment, minlength=n_clusters).astype(np.int64)

    raw = max(len(c) for c in columns)
    m = ((raw + chunk_size - 1) // chunk_size) * chunk_size
    m_pad = m + (-m) % n_row_shards
    # fill column-major (each payload one contiguous write), then transpose
    cols = np.zeros((n_clusters, m_pad), np.uint8)
    used = np.asarray([len(c) for c in columns], np.int64)
    for j, c in enumerate(columns):
        cols[j, :len(c)] = np.frombuffer(c, np.uint8)
    full = np.ascontiguousarray(cols.T)
    del cols
    rows_per = m_pad // n_row_shards
    shards = (tuple(full[s * rows_per:(s + 1) * rows_per]
                    for s in range(n_row_shards))
              if n_row_shards > 1 else None)

    pad_frac = 1.0 - int(used.sum()) / float(m * n_clusters)
    return ChunkedDB(matrix=full if m_pad == m else full[:m],
                     emb_dim=emb_dim, chunk_size=chunk_size,
                     n_docs=n_docs, cluster_sizes=sizes,
                     pad_fraction=pad_frac, used_bytes=used,
                     row_shards=shards)
