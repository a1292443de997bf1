"""JAX's threefry2x32 PRNG in torch integer ops (no twin in ``repro``).

The public LWE matrix A (``lwe.gen_public_matrix``) and the build's
``a_seed`` (``pipeline._derive_build_streams``) must equal the JAX
package's bit for bit, or no hint can match.  This module reproduces
``jax.random`` for legacy uint32 keys in the *partitionable* derivation
(``jax_threefry_partitionable=True``, JAX's default since 0.5):

  PRNGKey(seed)     → (0, seed mod 2^32)           (32-bit seeds, x64 off)
  fold_in(key, d)   → threefry2x32(key, (0, d))
  split(key, num)   → key i = threefry2x32(key, (i >> 32, i mod 2^32))
  bits(key, shape)  → word i = XOR of threefry2x32(key, (i >> 32, i mod 2^32))
  randint           → JAX's two-word modulus draw (``random._randint``)

A key is a pair of Python ints.  Arithmetic runs on int64 tensors (or
Python ints) holding values in [0, 2^32) and masks after every add, so
nothing depends on int32 wraparound.
"""
from __future__ import annotations

import math

import torch

from repro_torch._common import MASK, wrap_i32

Key = tuple[int, int]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry2x32(key: Key, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) on counter words (x0, x1).

    x0, x1: Python ints or int64 tensors with values in [0, 2^32).
    """
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def PRNGKey(seed: int) -> Key:  # noqa: N802 - mirrors jax.random.PRNGKey
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off: (0, seed mod 2^32)."""
    return (0, int(seed) & MASK)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in``: hash a 32-bit datum into the key."""
    return threefry2x32(key, 0, int(data) & MASK)


def split(key: Key, num: int = 2) -> list[Key]:
    """``jax.random.split`` (partitionable): ``num`` new keys."""
    return [threefry2x32(key, i >> 32, i & MASK) for i in range(num)]


def _bits_i64(key: Key, shape: tuple[int, ...], device) -> torch.Tensor:
    size = math.prod(shape)
    idx = torch.arange(size, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key, idx >> 32, idx & MASK)
    return (b0 ^ b1).reshape(shape)


def bits(key: Key, shape: tuple[int, ...], *, device) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as an int32-held u32 tensor."""
    return wrap_i32(_bits_i64(key, tuple(shape), device))


def randint(key: Key, shape: tuple[int, ...], minval: int, maxval: int, *,
            device="cpu"):
    """``jax.random.randint(key, shape, minval, maxval)`` for int32.

    Returns a Python int for ``shape == ()``, else an int32 tensor.
    """
    shape = tuple(shape)
    out_of_range = maxval > _I32_MAX
    lo_v = min(max(int(minval), _I32_MIN), _I32_MAX)
    hi_v = min(max(int(maxval), _I32_MIN), _I32_MAX)
    span = (hi_v - lo_v) & MASK
    if hi_v <= lo_v:
        span = 1
    elif out_of_range:
        span = (span + 1) & MASK
    if span == 0:
        raise ValueError("randint over the full 2^32 range is not supported")
    k_hi, k_lo = split(key)
    higher = _bits_i64(k_hi, shape, device)
    lower = _bits_i64(k_lo, shape, device)
    mult = (1 << 16) % span
    mult = ((mult * mult) & MASK) % span     # u32 product wraps, as in JAX
    offset = ((((higher % span) * mult) & MASK) + lower % span) & MASK
    val = wrap_i32(lo_v + offset % span)
    return int(val) if shape == () else val


def torch_generator(key: Key, device) -> torch.Generator:
    """A torch generator on ``device`` seeded by both words of ``key``."""
    gen = torch.Generator(device=device)
    gen.manual_seed((key[0] << 32) | key[1])
    return gen
