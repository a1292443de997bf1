"""The layers the decoder needs, as plain functions on parameter dicts.

Twin of the JAX package's ``models/nn.py`` (`dense`, `rmsnorm`, `embed` and
their inits); the MLP helpers come with the models that use them.  Params
are nested dicts of tensors, as there.  Inits draw from an explicit
``torch.Generator`` on the tensor's device: the same distributions as the
reference's, not its bits (`convert.lm_params_from_state` carries the
reference's own weights across).
"""
from __future__ import annotations

import math

import torch


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, dtype=torch.float32, device=None):
    """``w`` of N(0, 1/d_in); ``b`` zeros."""
    w = torch.randn(d_in, d_out, generator=gen, device=device)
    p = {"w": w.mul_(1.0 / math.sqrt(d_in)).to(dtype)}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=dtype, device=device)
    return p


def dense(p, x, *, compute_dtype=torch.float32):
    y = x.to(compute_dtype) @ p["w"].to(compute_dtype)
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"g": torch.ones(d, dtype=dtype, device=device)}


def rmsnorm(p, x, *, eps: float = 1e-6):
    """RMS norm over the last axis, computed in float32 and cast back."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["g"].to(torch.float32)).to(x.dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32, device=None):
    """``table`` of 0.02·N(0, 1)."""
    t = torch.randn(vocab, d, generator=gen, device=device)
    return {"table": t.mul_(0.02).to(dtype)}


def embed(p, ids, *, compute_dtype=torch.float32):
    """Rows of the table for ``ids`` in ``compute_dtype`` (gathered, then
    cast: the same values as the reference's cast-then-gather, without a
    cast copy of the whole table)."""
    return p["table"][ids].to(compute_dtype)
