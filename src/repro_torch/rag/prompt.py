"""Deterministic prompt construction for the RAG generation stage.

The port's own copy of the JAX package's ``rag/prompt.py``, which is plain
numpy: the same ranked texts and the same `PromptSpec` give the same tokens
byte for byte.  Retrieval hands back ranked plaintext documents
(`rerank.rerank` triples); this module turns them into the (B, S) int32
token grid the transformer prefill consumes.

Wire format of one packed prompt:

    [BOS] doc₀ [SEP] doc₁ [SEP] … docₖ [SEP] [GEN]

Tokens 0–255 are raw byte values of the document text; ids ≥ 256 are the
specials below.  Documents are packed greedily in RANK order, whole-doc
include-or-drop (a document is never split mid-record); a document that
does not fit is dropped and packing CONTINUES with later (shorter) ranks.
`PackedPrompt` carries exact truncation accounting: ``packed_bytes +
dropped_bytes`` always equals the total payload bytes offered.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

#: Byte-level vocabulary: ids 0..255 are raw bytes, then the specials.
PAD = 256      #: right-padding of the (B, S) batch grid
BOS = 257      #: start of prompt
SEP = 258      #: end of one packed document
GEN = 259      #: generation trigger — always the last prompt token
#: Minimum `LMConfig.vocab` a generator model needs (256 bytes + specials).
VOCAB = 260


@dataclasses.dataclass(frozen=True)
class PromptSpec:
    """Packing policy: `context_budget` is the HARD prompt-length cap.

    The packed token sequence (BOS + docs/SEPs + GEN) never exceeds
    `context_budget` tokens; the (B, S) batch grid is padded to exactly
    S = context_budget so prefill shapes are fixed per batch size.
    """
    context_budget: int = 160

    def __post_init__(self):
        assert self.context_budget >= 2, "need room for [BOS][GEN]"


@dataclasses.dataclass(frozen=True)
class PackedPrompt:
    """One request's packed prompt + exact truncation accounting.

    `tokens` is a (L,) int32 array, L ≤ spec.context_budget;
    `packed_bytes + dropped_bytes` == total payload bytes offered.
    """
    tokens: np.ndarray
    n_docs: int            #: documents packed into the prompt
    n_docs_dropped: int    #: documents dropped (over budget)
    packed_bytes: int      #: payload bytes that made it in
    dropped_bytes: int     #: payload bytes truncated away

    @property
    def length(self) -> int:
        """Prompt length in tokens (before batch padding)."""
        return int(self.tokens.shape[0])


def encode_bytes(text: bytes) -> np.ndarray:
    """Byte string → (len,) int32 token ids (identity byte tokenizer)."""
    return np.frombuffer(bytes(text), dtype=np.uint8).astype(np.int32)


def decode_tokens(tokens) -> bytes:
    """Token ids → byte string, dropping specials (debug/test helper)."""
    t = np.asarray(tokens).ravel()
    return bytes(int(v) for v in t if 0 <= v < 256)


def pack_docs(texts: Sequence[bytes], spec: PromptSpec) -> PackedPrompt:
    """Greedy rank-order packing of whole documents into one prompt.

    Each document costs ``len(text) + 1`` tokens (its trailing SEP); BOS
    and the terminal GEN cost one each.  A document that would blow the
    budget is dropped whole — packing continues, so a long rank-2 doc
    does not shadow a short rank-3 doc that still fits.  Deterministic:
    no RNG, no clock, order == input order.
    """
    budget = spec.context_budget
    parts = [np.array([BOS], np.int32)]
    used = 1                          # BOS; 1 more reserved for GEN below
    n_in = n_drop = b_in = b_drop = 0
    for text in texts:
        text = bytes(text)
        cost = len(text) + 1          # doc bytes + its SEP
        if used + cost + 1 <= budget:  # +1: the terminal GEN must still fit
            parts.append(encode_bytes(text))
            parts.append(np.array([SEP], np.int32))
            used += cost
            n_in += 1
            b_in += len(text)
        else:
            n_drop += 1
            b_drop += len(text)
    parts.append(np.array([GEN], np.int32))
    tokens = np.concatenate(parts)
    assert tokens.shape[0] <= budget, (tokens.shape[0], budget)
    return PackedPrompt(tokens=tokens, n_docs=n_in, n_docs_dropped=n_drop,
                        packed_bytes=b_in, dropped_bytes=b_drop)


def pack_batch(prompts: Sequence[PackedPrompt], spec: PromptSpec
               ) -> tuple[np.ndarray, np.ndarray]:
    """Right-pad packed prompts into the (B, S) grid prefill consumes.

    S is always exactly `spec.context_budget` (one prefill shape per
    batch size); returns (tokens (B, S) int32,
    lengths (B,) int32) where lengths are the true prompt lengths and
    everything beyond is PAD.
    """
    assert prompts, "empty batch"
    S = spec.context_budget
    B = len(prompts)
    grid = np.full((B, S), PAD, np.int32)
    lengths = np.zeros((B,), np.int32)
    for i, p in enumerate(prompts):
        L = p.length
        assert L <= S
        grid[i, :L] = p.tokens
        lengths[i] = L
    return grid, lengths
