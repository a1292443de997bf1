"""Batched prefill + KV-cache decode: retrieved documents → generated tokens.

Twin of the JAX package's ``rag/generate.py``.  `Generator` owns a decoder
LM (`repro_torch.models.transformer`) plus the packing policy
(`rag.prompt.PromptSpec`) and exposes three stages:

    pack     ranked docs  → (B, S) token grid + lengths      host
    prefill  token grid   → KV cache + first-token logits    device
    decode   step loop    → (B, max_new_tokens) int32 ids    device

Decoding is FIXED LENGTH (``max_new_tokens``, no early EOS stop), so the
output is a dense (B, N) grid.  Greedy decoding (temperature 0.0, the
default) takes the argmax.  Sampling draws each token as the reference's
``jax.random.categorical`` does (Gumbel noise from ``uniform`` bits, then an
argmax) under the key ``fold_in(fold_in(PRNGKey(seed), rid), step)``, with
the port's own threefry (`core.threefry`): a sampled token depends only on
the generator seed, the request id and the step, not on the batch it was
served in.

Caches and compute run in float32 (the reference's contract: bf16
accumulation order is the classic source of spurious differences between
engines), and on a card TF32 products must be off.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._common import MASK, resolve_device, to_device
from repro_torch.core import threefry
from repro_torch.models import transformer as tf
from repro_torch.rag import prompt as prompt_lib
from repro_torch.rag.prompt import PackedPrompt, PromptSpec

_TINY_F32 = torch.finfo(torch.float32).tiny


@dataclasses.dataclass
class GenState:
    """Device state between prefill and the decode loop.

    `logits` are the next-token logits at each row's last prompt token;
    `lengths` are true prompt lengths (cache write cursor starts there).
    """
    cache: list
    logits: torch.Tensor       # (B, V) f32
    lengths: torch.Tensor      # (B,) int64


def tiny_config(*, d_model: int = 64, n_layers: int = 2,
                d_ff: int = 128) -> tf.LMConfig:
    """`Generator.tiny`'s model: four heads of d_model/4 over two KV heads,
    the byte vocabulary, float32 compute (the reference's ``tiny`` config)."""
    if d_model % 4:
        raise ValueError(f"d_model {d_model} is not divisible by 4")
    return tf.LMConfig(
        name="rag-tiny", n_layers=n_layers, d_model=d_model, n_heads=4,
        n_kv_heads=2, head_dim=d_model // 4, d_ff=d_ff,
        vocab=prompt_lib.VOCAB, attn_chunk_q=64, attn_chunk_kv=64)


def gumbel_noise(key: threefry.Key, rids, step: int, vocab: int,
                 device) -> torch.Tensor:
    """(B, vocab) float32 Gumbel noise, row b drawn under
    ``fold_in(fold_in(key, rids[b]), step)`` exactly as
    ``jax.random.gumbel`` (mode "low") draws it: 32 threefry bits per entry,
    the top 23 as a mantissa in [1, 2), minus 1, floored at the smallest
    normal float, then ``-log(-log(u))``."""
    keys = [threefry.fold_in(threefry.fold_in(key, int(r)), step)
            for r in rids]
    k0 = torch.tensor([k[0] for k in keys], dtype=torch.int64,
                      device=device)[:, None]
    k1 = torch.tensor([k[1] for k in keys], dtype=torch.int64,
                      device=device)[:, None]
    idx = torch.arange(vocab, dtype=torch.int64, device=device)
    b0, b1 = threefry.threefry2x32((k0, k1), idx >> 32, idx & MASK)
    mant = (((b0 ^ b1) >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    u = torch.clamp_min(floats * (1.0 - _TINY_F32) + _TINY_F32, _TINY_F32)
    return -torch.log(-torch.log(u))


class Generator:
    """Prompt-conditioned fixed-length generation over a KV cache.

    Construct with model params + config (``cfg.vocab`` must cover the
    byte vocabulary, ``rag.prompt.VOCAB``; ``cfg.compute_dtype`` must be
    float32); `tiny()` builds the small seeded model the tests and the
    rehearsal use.  Runs on ``device`` (default ``cuda``; raises without a
    card) and moves ``params`` there.
    """

    def __init__(self, params, cfg: tf.LMConfig, *,
                 spec: PromptSpec | None = None, max_new_tokens: int = 16,
                 temperature: float = 0.0, seed: int = 0,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        if cfg.vocab < prompt_lib.VOCAB:
            raise ValueError(f"vocab {cfg.vocab} < byte vocabulary "
                             f"{prompt_lib.VOCAB}")
        if cfg.compute_dtype != torch.float32:
            raise ValueError(f"generation computes in float32, not "
                             f"{cfg.compute_dtype}")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens {max_new_tokens} < 1")
        self.params = _tree_to(params, self.device)
        self.cfg = cfg
        self.spec = spec if spec is not None else PromptSpec()
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.seed = int(seed)
        self._root_key = threefry.PRNGKey(seed)

    @classmethod
    def tiny(cls, *, seed: int = 0, context_budget: int = 96,
             max_new_tokens: int = 8, temperature: float = 0.0,
             d_model: int = 64, n_layers: int = 2, d_ff: int = 128,
             device: str | torch.device | None = None) -> "Generator":
        """A small seeded generator (`tiny_config`), drawn with the port's
        own init: the reference's widths and distributions, not its bits
        (`convert.generator_from_state` carries the reference's across)."""
        dev = resolve_device(device)
        cfg = tiny_config(d_model=d_model, n_layers=n_layers, d_ff=d_ff)
        params = tf.init(torch.Generator(device=dev).manual_seed(seed), cfg,
                         device=dev)
        return cls(params, cfg, spec=PromptSpec(context_budget),
                   max_new_tokens=max_new_tokens, temperature=temperature,
                   seed=seed, device=dev)

    # -- stage 1: host-side tokenize + pack ----------------------------------

    def pack(self, doc_lists) -> tuple[np.ndarray, np.ndarray,
                                       list[PackedPrompt]]:
        """Ranked rerank triples per request → (B, S) grid + lengths.

        `doc_lists[i]` is request i's ranked `(doc_id, score, text)`
        list; only the text bytes enter the prompt.
        """
        prompts = [prompt_lib.pack_docs([t for _, _, t in docs], self.spec)
                   for docs in doc_lists]
        grid, lengths = prompt_lib.pack_batch(prompts, self.spec)
        return grid, lengths, prompts

    # -- stage 2: prefill -----------------------------------------------------

    def prefill(self, tokens: np.ndarray, lengths: np.ndarray) -> GenState:
        """Run the packed prompts through the model, filling the cache."""
        dev = self.device
        if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is "
                               "on: generation's products must be float32")
        B = tokens.shape[0]
        toks = to_device(np.asarray(tokens, np.int64), dev)
        lens = to_device(np.asarray(lengths, np.int64), dev)
        cache = tf.init_cache(self.cfg, B,
                              self.spec.context_budget + self.max_new_tokens,
                              device=dev)
        logits, cache = tf.prefill(self.params, toks, cache, self.cfg,
                                   last_pos=lens - 1)
        return GenState(cache=cache, logits=logits, lengths=lens)

    # -- stage 3: the decode loop --------------------------------------------

    def _pick(self, logits: torch.Tensor, rids, step: int) -> torch.Tensor:
        """logits (B, V) → next ids (B,) (greedy or seeded sample)."""
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        g = gumbel_noise(self._root_key, rids, step, logits.shape[-1],
                         logits.device)
        return torch.argmax(g + logits / self.temperature, dim=-1)

    def decode_async(self, state: GenState, rids) -> torch.Tensor:
        """Queue the whole step loop; return the (B, N) int32 ids on the
        device without waiting for them.  Values are identical to
        `decode`'s."""
        rids = [int(r) for r in rids]
        cache, lengths = state.cache, state.lengths
        cur = self._pick(state.logits, rids, 0)
        out = [cur]
        for step in range(1, self.max_new_tokens):
            logits, cache = tf.decode_step(self.params, cache, cur,
                                           lengths + (step - 1), self.cfg)
            cur = self._pick(logits, rids, step)
            out.append(cur)
        return torch.stack(out, dim=1).to(torch.int32)

    def decode(self, state: GenState, rids) -> np.ndarray:
        """Greedy/sampled step loop → (B, max_new_tokens) int32 ids."""
        return self.decode_async(state, rids).cpu().numpy()

    # -- convenience ----------------------------------------------------------

    def generate(self, doc_lists, rids) -> np.ndarray:
        """pack → prefill → decode in one call."""
        grid, lengths, _ = self.pack(doc_lists)
        return self.decode(self.prefill(grid, lengths), rids)

    def generate_nocache(self, doc_lists, rids) -> np.ndarray:
        """Cache-free check: re-run the full `forward` every step.

        O(N·S²): exists so the KV-cache loop can be held against an
        independently computed token sequence.  Greedy only.
        """
        if self.temperature > 0.0:
            raise ValueError("the cache-free path is greedy only")
        del rids
        grid, lengths, _ = self.pack(doc_lists)
        toks = np.array(grid)
        lens = np.array(lengths).copy()
        B = toks.shape[0]
        out = np.zeros((B, self.max_new_tokens), np.int32)
        for step in range(self.max_new_tokens):
            x, _ = tf.forward(self.params,
                              to_device(toks.astype(np.int64), self.device),
                              self.cfg)
            full = tf.logits_from_hidden(self.params, x, self.cfg)
            rows = torch.arange(B, device=self.device)
            last = torch.as_tensor(lens - 1, dtype=torch.int64,
                                   device=self.device)
            nxt = torch.argmax(full[rows, last], dim=-1).cpu().numpy()
            for b in range(B):
                out[b, step] = nxt[b]
                if lens[b] >= toks.shape[1]:
                    toks = np.pad(toks, ((0, 0), (0, 1)),
                                  constant_values=prompt_lib.PAD)
                toks[b, lens[b]] = nxt[b]
                lens[b] += 1
        return out


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)
