"""The dense decoder-only transformer LM: forward, prefill and KV-cache decode.

Twin of the dense path of the JAX package's ``models/transformer.py``: GQA
attention with optional QK-norm (before RoPE) and QKV bias, RoPE, a SwiGLU
FFN, tied or separate output embeddings.  The attention of a prompt is the
same chunked online softmax (`blockwise_attention`) and one decode step the
same one-shot masked softmax over the cache (`decode_attention`), so the
arithmetic follows the reference's step for step; matrix products are plain
``torch.matmul`` / ``einsum``, as the reference leaves them to XLA (it has
no Pallas kernel here).  ``scaled_dot_product_attention`` is not used: its
kernel choice changes with the shape, so a row's result would depend on
the rows that share its batch.

Params are plain dicts of tensors.  Where the reference stacks the blocks
for ``lax.scan`` (``params["blocks"]``, leading axis n_layers), the port
keeps one dict per layer in ``params["layers"]``; the reference's sharding
hints (``logical``) are dropped.  The KV cache is a list of per-layer
``{"k", "v"}`` tensors (B, T, KV, hd) that `prefill` and `decode_step`
write in place and return (the reference returns an updated copy): a
position past a row's length is never read, so decoding twice from one
prefilled cache gives the same result.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models import nn

_NEG = -1e30


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    qk_norm: bool = False
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 500_000.0
    moe: object | None = None
    param_dtype: torch.dtype = torch.float32
    #: float32, where the reference defaults to bfloat16: generation's
    #: contract, and the only type `rag.generate.Generator` accepts
    compute_dtype: torch.dtype = torch.float32
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024

    def __post_init__(self):
        if self.moe is not None:
            raise NotImplementedError(
                f"{self.name}: LMConfig.moe needs the mixture-of-experts "
                "layers (models/moe.py), not ported yet (ROADMAP queue 1 "
                "item 7)")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.n_heads} heads over {self.n_kv_heads} "
                             "KV heads")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _layer_init(gen, cfg: LMConfig, device):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pd, b = cfg.param_dtype, cfg.qkv_bias
    attn = {
        "wq": nn.dense_init(gen, d, H * hd, bias=b, dtype=pd, device=device),
        "wk": nn.dense_init(gen, d, KV * hd, bias=b, dtype=pd, device=device),
        "wv": nn.dense_init(gen, d, KV * hd, bias=b, dtype=pd, device=device),
        "wo": nn.dense_init(gen, H * hd, d, dtype=pd, device=device),
    }
    if cfg.qk_norm:
        attn["q_norm"] = nn.rmsnorm_init(hd, pd, device)
        attn["k_norm"] = nn.rmsnorm_init(hd, pd, device)
    ffn = {name: nn.dense_init(gen, i, o, dtype=pd, device=device)
           for name, i, o in (("w_gate", d, cfg.d_ff), ("w_up", d, cfg.d_ff),
                              ("w_down", cfg.d_ff, d))}
    return {"ln1": nn.rmsnorm_init(d, pd, device), "attn": attn,
            "ln2": nn.rmsnorm_init(d, pd, device), "ffn": ffn}


def init(gen: torch.Generator, cfg: LMConfig, *, device):
    """Seeded weights on ``device`` (``gen`` must live there): the
    reference's distributions, drawn in the order embed, layers, head."""
    params = {
        "embed": nn.embed_init(gen, cfg.vocab, cfg.d_model, cfg.param_dtype,
                               device),
        "layers": [_layer_init(gen, cfg, device)
                   for _ in range(cfg.n_layers)],
        "final_norm": nn.rmsnorm_init(cfg.d_model, cfg.param_dtype, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = nn.dense_init(gen, cfg.d_model, cfg.vocab,
                                       dtype=cfg.param_dtype, device=device)
    return params


# ---------------------------------------------------------------------------
# RoPE + attention
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) of shape (B, S, 1, hd/2) for positions (B, S): computed
    once per forward and shared by every layer's q and k."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def _rope(x: torch.Tensor, tables) -> torch.Tensor:
    """x: (B, S, H, hd) rotated by ``tables`` = `rope_tables` (cos, sin)."""
    half = x.shape[-1] // 2
    cos, sin = tables
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _qkv(p, x, cfg: LMConfig, tables):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cd = cfg.compute_dtype
    q = nn.dense(p["wq"], x, compute_dtype=cd).reshape(B, S, H, hd)
    k = nn.dense(p["wk"], x, compute_dtype=cd).reshape(B, S, KV, hd)
    v = nn.dense(p["wv"], x, compute_dtype=cd).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = nn.rmsnorm(p["q_norm"], q)
        k = nn.rmsnorm(p["k_norm"], k)
    q = _rope(q, tables)
    k = _rope(k, tables)
    return q, k, v


def blockwise_attention(q, k, v, cfg: LMConfig, *, causal: bool = True):
    """Online-softmax (flash-style) attention, chunk by chunk.

    q: (B, Sq, H, hd), k/v: (B, Skv, KV, hd); query head h reads KV head
    h // G (G = H / KV).  An outer loop over q chunks, an inner loop over
    the kv chunks a causal chunk can see; K/V are padded to the chunk grid
    and the padded keys masked.  Products accumulate in float32, as the
    reference's ``preferred_element_type``.
    """
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    cq, ckv = min(cfg.attn_chunk_q, Sq), min(cfg.attn_chunk_kv, Skv)
    nq = (Sq + cq - 1) // cq
    scale = 1.0 / math.sqrt(hd)
    pad_kv = (-Skv) % ckv
    if pad_kv:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_kv))
    dev, f32 = q.device, torch.float32

    outs = []
    for qi in range(nq):
        q_lo = qi * cq
        q_hi = min(Sq, q_lo + cq)
        cq_i = q_hi - q_lo
        qc = q[:, q_lo:q_hi].to(f32)
        kv_hi = min(Skv, q_hi) if causal else Skv
        nkv = max(1, (kv_hi + ckv - 1) // ckv)
        qpos = q_lo + torch.arange(cq_i, device=dev)
        m = torch.full((B, cq_i, H), _NEG, dtype=f32, device=dev)
        l = torch.zeros((B, cq_i, H), dtype=f32, device=dev)
        acc = torch.zeros((B, cq_i, H, hd), dtype=f32, device=dev)
        for ki in range(nkv):
            kc = k[:, ki * ckv:(ki + 1) * ckv].repeat_interleave(G, dim=2)
            vc = v[:, ki * ckv:(ki + 1) * ckv].repeat_interleave(G, dim=2)
            s = torch.einsum("bqhd,bthd->bqht", qc, kc.to(f32)) * scale
            kpos = ki * ckv + torch.arange(ckv, device=dev)
            valid = kpos < Skv                              # padded keys
            if causal:
                mask = (qpos[:, None] >= kpos[None, :]) & valid[None, :]
                s = torch.where(mask[None, :, None, :], s, _NEG)
            else:
                s = torch.where(valid[None, None, None, :], s, _NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            prob = torch.exp(s - m_new[..., None])
            l = l * alpha + prob.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqht,bthd->bqhd", prob.to(vc.dtype).to(f32), vc.to(f32))
            m = m_new
        outs.append(acc / torch.clamp_min(l[..., None], 1e-30))
    return torch.cat(outs, dim=1).to(q.dtype)


def decode_attention(q, k_cache, v_cache, lengths, cfg: LMConfig):
    """One token's attention over the cache: a masked one-shot softmax.

    q: (B, 1, H, hd); caches: (B, T, KV, hd); lengths: (B,) valid length.
    """
    B, _, H, hd = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    f32 = torch.float32
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, KV, G, hd).to(f32)
    s = torch.einsum("bkgh,btkh->bkgt", qg, k_cache.to(f32)) * scale
    mask = (torch.arange(T, device=q.device)[None, :]
            < lengths[:, None])                             # (B, T)
    s = torch.where(mask[:, None, None, :], s, _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkh->bkgh", p.to(v_cache.dtype).to(f32),
                       v_cache.to(f32))
    return out.reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Layers / forward
# ---------------------------------------------------------------------------

def _ffn(lp, x, cfg: LMConfig):
    h = nn.rmsnorm(lp["ln2"], x)
    f, cd = lp["ffn"], cfg.compute_dtype
    g = nn.dense(f["w_gate"], h, compute_dtype=cd)
    u = nn.dense(f["w_up"], h, compute_dtype=cd)
    y = nn.dense(f["w_down"], F.silu(g) * u, compute_dtype=cd)
    return x + y.to(x.dtype)


def _attn_out(lp, x, o, cfg: LMConfig):
    o = nn.dense(lp["attn"]["wo"], o.reshape(*o.shape[:2], -1),
                 compute_dtype=cfg.compute_dtype)
    return x + o.to(x.dtype)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32,
                        device=device).expand(B, S)


def forward(params, tokens: torch.Tensor, cfg: LMConfig):
    """tokens (B, S) → final hidden states (B, S, d) + aux loss (0: no
    MoE layer)."""
    B, S = tokens.shape
    positions = _positions(B, S, tokens.device)
    tables = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x = nn.embed(params["embed"], tokens.long(),
                 compute_dtype=cfg.compute_dtype)
    for lp in params["layers"]:
        h = nn.rmsnorm(lp["ln1"], x)
        q, k, v = _qkv(lp["attn"], h, cfg, tables)
        x = _attn_out(lp, x, blockwise_attention(q, k, v, cfg), cfg)
        x = _ffn(lp, x, cfg)
    x = nn.rmsnorm(params["final_norm"], x)
    return x, torch.zeros((), dtype=torch.float32, device=tokens.device)


def logits_from_hidden(params, x, cfg: LMConfig):
    cd = cfg.compute_dtype
    if cfg.tie_embeddings:
        w = params["embed"]["table"].to(cd)
        return (x.to(cd) @ w.T).to(torch.float32)
    return nn.dense(params["head"], x, compute_dtype=cd).to(torch.float32)


# ---------------------------------------------------------------------------
# KV cache: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, max_seq: int,
               dtype=torch.float32, *, device):
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.n_layers)]


def prefill(params, tokens, cache, cfg: LMConfig, *, last_pos=None):
    """Run the prompt through the model, writing the cache's first S
    positions; return the logits (B, V) of the last position and the cache.

    ``last_pos`` ((B,) ints) takes each row's logits at its own last real
    token instead of column S-1 (right-padded batches from
    `rag.prompt.pack_batch` pass lengths-1).  Padding columns still write
    the cache; decode masks them out by attending only to ``lengths``
    positions.
    """
    B, S = tokens.shape
    positions = _positions(B, S, tokens.device)
    tables = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x = nn.embed(params["embed"], tokens.long(),
                 compute_dtype=cfg.compute_dtype)
    for lp, cb in zip(params["layers"], cache):
        h = nn.rmsnorm(lp["ln1"], x)
        q, k, v = _qkv(lp["attn"], h, cfg, tables)
        cb["k"][:, :S] = k.to(cb["k"].dtype)
        cb["v"][:, :S] = v.to(cb["v"].dtype)
        x = _attn_out(lp, x, blockwise_attention(q, k, v, cfg), cfg)
        x = _ffn(lp, x, cfg)
    x = nn.rmsnorm(params["final_norm"], x)
    if last_pos is None:
        xl = x[:, -1:]
    else:
        idx = torch.as_tensor(last_pos, device=x.device).long()
        xl = x[torch.arange(B, device=x.device), idx][:, None]
    return logits_from_hidden(params, xl, cfg)[:, 0], cache


def decode_step(params, cache, tokens, lengths, cfg: LMConfig):
    """One decode step.  tokens: (B,) new ids; lengths: (B,) current context
    length (the new token is written at index ``lengths``)."""
    B = tokens.shape[0]
    lengths = lengths.long()
    positions = lengths[:, None].to(torch.int32)              # (B, 1)
    tables = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x = nn.embed(params["embed"], tokens.long()[:, None],
                 compute_dtype=cfg.compute_dtype)
    rows = torch.arange(B, device=x.device)
    for lp, cb in zip(params["layers"], cache):
        h = nn.rmsnorm(lp["ln1"], x)
        q, k, v = _qkv(lp["attn"], h, cfg, tables)
        cb["k"][rows, lengths] = k[:, 0].to(cb["k"].dtype)
        cb["v"][rows, lengths] = v[:, 0].to(cb["v"].dtype)
        o = decode_attention(q, cb["k"], cb["v"], lengths + 1, cfg)
        x = _attn_out(lp, x, o, cfg)
        x = _ffn(lp, x, cfg)
    x = nn.rmsnorm(params["final_norm"], x)
    return logits_from_hidden(params, x, cfg)[:, 0], cache    # (B, V)
