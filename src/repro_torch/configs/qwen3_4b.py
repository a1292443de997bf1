"""qwen3-4b [dense] — 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936
— qk_norm, GQA, tied embeddings.  head_dim=128 (decoupled from
d_model/n_heads, per Qwen3).

Copies of the JAX package's ``configs/qwen3_4b.py`` ``FULL`` and ``SMOKE``
as the port's `LMConfig` (its ``remat`` and ``ce_chunk`` are training knobs
the port has no use for yet).  They compute in float32, the port's
default, where the reference's compute in bfloat16.  The ``base.ArchSpec`` registry waits for
ROADMAP queue 1 item 8.
"""
from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    name="qwen3-4b",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=9728, vocab=151936, rope_theta=1_000_000.0, qk_norm=True,
    tie_embeddings=True,
)

SMOKE = LMConfig(
    name="qwen3-smoke",
    n_layers=3, d_model=48, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab=512, rope_theta=1_000_000.0, qk_norm=True,
    attn_chunk_q=16, attn_chunk_kv=16,
)
