"""Shared machinery for the baseline private-search architectures (twin of
``repro/core/baselines/common.py``).

* ``DocContentPIR`` — a per-document PIR database (one column per doc).
  This is the "retrieve-THEN-fetch" tail the paper charges to Graph-PIR
  and Tiptoe: after they produce ids, each document's content still costs
  one PIR query here.  PIR-RAG avoids it by construction.
* Signed low-bit embedding quantization with offset correction, so
  encrypted inner products run through the same u8×u32 modular product.

Records are serialized for every document at once
(`chunking.doc_records`, byte-identical to the reference's per-document
`serialize_doc`) and uploaded row-major, then transposed once on the
device into the (m, n_docs) column matrix.

A divergence by design: a baseline PIR whose column count drives the
plaintext modulus below 256 (`lwe.choose_params` above about 716,000
columns) raises (`require_byte_plaintext`) instead of decoding every
record byte ≥ p wrong.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._common import resolve_device, to_device
from repro_torch.core import chunking, lwe, pir


# ---------------------------------------------------------------------------
# Low-bit signed quantization for homomorphic scoring
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QuantScheme:
    """Symmetric signed quantizer stored as shifted-unsigned for the u8 kernel.

    value v → round(v / scale) ∈ [−levels, levels], stored as +levels.
    The inner product of two shifted vectors expands to
        Σ(d+L)(q+L) = Σ d·q + L·Σd + L·Σq + d_dim·L²
    so the client (which knows Σq) removes the offsets given the public
    per-doc row sums Σd.
    """
    levels: int            # e.g. 15 → 5-bit signed
    scale: float

    def quantize(self, v: np.ndarray) -> np.ndarray:
        q = np.clip(np.round(v / self.scale), -self.levels, self.levels)
        return (q + self.levels).astype(np.uint8)

    def unshift(self, stored: np.ndarray) -> np.ndarray:
        return stored.astype(np.int64) - self.levels


def fit_quant(embs: np.ndarray, levels: int) -> QuantScheme:
    amax = float(np.abs(embs).max()) or 1.0
    return QuantScheme(levels=levels, scale=amax / levels)


# ---------------------------------------------------------------------------
# Encrypted-embedding query (the Tiptoe-style uplink)
# ---------------------------------------------------------------------------

def encrypt_embedding(gen: torch.Generator | None, q_shifted: np.ndarray,
                      params: lwe.LWEParams, a_mat: torch.Tensor, *,
                      secret: torch.Tensor | None = None,
                      errors: torch.Tensor | None = None,
                      impl: str = "auto"
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """LWE-encrypt a shifted-unsigned quantized embedding, coordinate-wise.

    a_mat: (d, k) int32-held u32.  Returns (ct (d,), secret (k,)).  The
    secret, then the errors, come from ``gen`` unless given (tests inject
    the JAX package's).
    """
    s = secret if secret is not None else lwe.keygen(gen, params)
    e = (errors if errors is not None else
         lwe.sample_error(gen, (a_mat.shape[0],), params.sigma))
    msg = to_device(np.asarray(q_shifted, np.int64), a_mat.device)
    ct = lwe.encrypt_vector(s, a_mat, msg, params.delta, e, impl=impl)
    return ct, s


# ---------------------------------------------------------------------------
# Records of every document at once
# ---------------------------------------------------------------------------

def require_byte_plaintext(cfg: pir.PIRConfig) -> None:
    """Raise unless every record byte (0–255) is a plaintext of ``cfg``.

    `pir.make_config` halves p when the column count outgrows the noise
    budget (p = 128 above about 716,000 columns); a byte ≥ p would then
    decode to byte mod p without any error.
    """
    if cfg.params.p < 256:
        raise ValueError(
            f"a PIR over n={cfg.n} columns has plaintext modulus "
            f"p={cfg.params.p} < 256: record bytes >= {cfg.params.p} "
            f"would decode wrong")


def upload_columns(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    """(n, m) row-major records → the (m, n) u8 column matrix on
    ``device``, transposed there in one pass."""
    return torch.from_numpy(rows).to(device).t().contiguous()


# ---------------------------------------------------------------------------
# Per-document content PIR (the expensive tail of retrieve-then-fetch)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DocContentPIR:
    """One PIR column per document; fetching doc i = PIR query for column i."""
    cfg: pir.PIRConfig
    server: pir.PIRServer
    hint: torch.Tensor
    emb_dim: int

    @classmethod
    def build(cls, texts, embeddings: np.ndarray, *, impl: str = "auto",
              chunk_size: int = 64,
              device: str | torch.device | None = None) -> "DocContentPIR":
        """Serialize, upload and hint the corpus on ``device`` (default
        ``cuda``; raises without a card)."""
        dev = resolve_device(device)
        n_docs, emb_dim = embeddings.shape
        rows = chunking.doc_records(texts, embeddings,
                                    chunk_size=chunk_size)
        cfg = pir.make_config(rows.shape[1], n_docs, impl=impl)
        require_byte_plaintext(cfg)
        server = pir.PIRServer(cfg, upload_columns(rows, dev))
        return cls(cfg=cfg, server=server, hint=server.setup(),
                   emb_dim=emb_dim)

    def fetch(self, gen: torch.Generator, doc_id: int
              ) -> tuple[int, np.ndarray, bytes]:
        """One private fetch: (doc id, dequantized embedding, text)."""
        client = pir.PIRClient(self.cfg, self.hint,
                               a_mat=self.server.a_matrix)
        qs, secrets = client.query_batch(gen, [doc_id])
        ans = self.server.answer(qs)
        buf = client.recover_batch(ans, secrets)[:, 0].cpu().numpy().tobytes()
        did, tlen = np.frombuffer(buf[:8], np.uint32)
        scale, off = np.frombuffer(buf[8:16], np.float32)
        qv = np.frombuffer(buf[16:16 + self.emb_dim], np.uint8)
        at = 16 + self.emb_dim
        return (int(did), chunking.dequantize_embedding(qv, float(scale),
                                                        float(off)),
                buf[at:at + int(tlen)])

    def fetch_many(self, seed: int, doc_ids
                   ) -> list[tuple[int, np.ndarray, bytes]]:
        """K sequential private fetches — the retrieve-then-fetch tail cost.
        Fetch t draws from a generator seeded ``seed * 9973 + t``."""
        dev = self.server.device
        return [self.fetch(torch.Generator(device=dev).manual_seed(
                    seed * 9973 + t), int(d))
                for t, d in enumerate(doc_ids)]

    @property
    def per_fetch_uplink(self) -> int:
        return self.cfg.uplink_bytes

    @property
    def per_fetch_downlink(self) -> int:
        return self.cfg.downlink_bytes
