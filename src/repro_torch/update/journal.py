"""Append-only mutation journal for the live index.

A copy of ``repro/update/journal.py`` (numpy only); `Mutation.to_bytes` is
byte-identical to the JAX package's.

Wire format (little-endian), one record per mutation:

    [kind : u8][doc_id : u32][emb_dim : u32][text_len : u32]
    [emb : f32 × emb_dim][text : u8 × text_len]

kind ∈ {1=insert, 2=delete, 3=replace}; delete records carry emb_dim =
text_len = 0.  The journal is the recovery story: replaying it over the
last full-rebuild snapshot reconstructs the current epoch's document set,
so delta epochs never need their own durable snapshots.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np

INSERT = "insert"
DELETE = "delete"
REPLACE = "replace"

_KIND_CODE = {INSERT: 1, DELETE: 2, REPLACE: 3}
_CODE_KIND = {v: k for k, v in _KIND_CODE.items()}


@dataclasses.dataclass(frozen=True)
class Mutation:
    """One streaming corpus mutation, keyed by external doc_id."""
    kind: str                      # insert | delete | replace
    doc_id: int
    text: bytes | None = None      # None for delete
    emb: np.ndarray | None = None  # (d,) f32; None for delete

    def __post_init__(self):
        if self.kind not in _KIND_CODE:
            raise ValueError(f"unknown mutation kind {self.kind!r}")
        if self.kind == DELETE:
            assert self.text is None and self.emb is None
        else:
            assert self.text is not None and self.emb is not None

    def to_bytes(self) -> bytes:
        emb = (np.asarray(self.emb, np.float32) if self.emb is not None
               else np.zeros(0, np.float32))
        text = self.text if self.text is not None else b""
        hdr = (np.uint8(_KIND_CODE[self.kind]).tobytes()
               + np.uint32(self.doc_id).tobytes()
               + np.uint32(emb.size).tobytes()
               + np.uint32(len(text)).tobytes())
        return hdr + emb.tobytes() + text


def insert(doc_id: int, text: bytes, emb: np.ndarray) -> Mutation:
    return Mutation(INSERT, doc_id, text, np.asarray(emb, np.float32))


def delete(doc_id: int) -> Mutation:
    return Mutation(DELETE, doc_id)


def replace(doc_id: int, text: bytes, emb: np.ndarray) -> Mutation:
    return Mutation(REPLACE, doc_id, text, np.asarray(emb, np.float32))


def _parse_one(buf: bytes, ofs: int) -> tuple[Mutation, int]:
    kind = _CODE_KIND[int(np.frombuffer(buf[ofs:ofs + 1], np.uint8)[0])]
    doc_id = int(np.frombuffer(buf[ofs + 1:ofs + 5], np.uint32)[0])
    d = int(np.frombuffer(buf[ofs + 5:ofs + 9], np.uint32)[0])
    tlen = int(np.frombuffer(buf[ofs + 9:ofs + 13], np.uint32)[0])
    ofs += 13
    emb = np.frombuffer(buf[ofs:ofs + 4 * d], np.float32).copy() if d else None
    ofs += 4 * d
    text = buf[ofs:ofs + tlen] if kind != DELETE else None
    ofs += tlen
    return Mutation(kind, doc_id, text, emb), ofs


class MutationJournal:
    """Append-only log with a committed/pending watermark.

    `append` adds pending mutations; `mark_committed(epoch)` moves the
    watermark once LiveIndex publishes the epoch that folded them in.
    """

    def __init__(self):
        self._log: list[Mutation] = []
        self._committed = 0            # prefix length already in an epoch
        self._epoch_of: list[int] = [] # per committed record: epoch it joined

    def append(self, mut: Mutation):
        self._log.append(mut)

    def pending(self) -> list[Mutation]:
        return self._log[self._committed:]

    def mark_committed(self, epoch: int):
        n_new = len(self._log) - self._committed
        self._epoch_of.extend([epoch] * n_new)
        self._committed = len(self._log)

    def committed_records(self) -> Iterator[tuple[int, Mutation]]:
        """(epoch, mutation) pairs for the committed prefix, in log order."""
        return zip(self._epoch_of, self._log[:self._committed])

    def __len__(self) -> int:
        return len(self._log)

    def to_bytes(self) -> bytes:
        """Serialize the full log in the documented wire format."""
        return b"".join(m.to_bytes() for m in self._log)

    @classmethod
    def from_bytes(cls, buf: bytes) -> "MutationJournal":
        j = cls()
        ofs = 0
        while ofs < len(buf):
            mut, ofs = _parse_one(buf, ofs)
            j.append(mut)
        return j


def replay(base: dict[int, tuple[bytes, np.ndarray]],
           mutations: Sequence[Mutation]
           ) -> dict[int, tuple[bytes, np.ndarray]]:
    """Apply a mutation sequence to a doc_id → (text, emb) snapshot."""
    docs = dict(base)
    for m in mutations:
        if m.kind == DELETE:
            docs.pop(m.doc_id, None)
        else:
            docs[m.doc_id] = (m.text, np.asarray(m.emb, np.float32))
    return docs
