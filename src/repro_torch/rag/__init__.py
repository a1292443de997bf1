"""RAG generation stage: retrieved payloads → packed prompts → tokens.

`prompt` owns the deterministic byte-level tokenizer and context-budgeted
document packing; `generate` owns the batched prefill + KV-cache decode
loop.  Twin of the JAX package's ``rag``.
"""
from repro_torch.rag.generate import Generator, GenState
from repro_torch.rag.prompt import (BOS, GEN, PAD, SEP, VOCAB, PackedPrompt,
                                    PromptSpec, decode_tokens, encode_bytes,
                                    pack_batch, pack_docs)

__all__ = [
    "Generator", "GenState", "PromptSpec", "PackedPrompt",
    "pack_docs", "pack_batch", "encode_bytes", "decode_tokens",
    "PAD", "BOS", "SEP", "GEN", "VOCAB",
]
