"""Regev-style LWE over Z_{2^32} (twin of ``repro/core/lwe.py``).

Ciphertexts are u32 held as int32 bit patterns.  Elementwise arithmetic
widens to int64 with values in [0, 2^32), reduces with ``& MASK`` (q = 2^32)
or ``& (2^b − 1)`` for the other powers of two, and narrows back.  The two
matrix products (A·s and H·s) go through the exact mod-2^32 kernel
(`kernels.ops.mod_u32_matmul`).

Scheme (secret dim k, plaintext modulus p, Δ = q // p, error σ):

    A  ~ U(Z_q^{n×k})            public, from a shared seed (threefry, bitwise
                                 equal to the JAX package)
    s  ~ U(Z_q^k)                secret, from a torch.Generator
    e  ~ round(N(0, σ²))^n       fresh per query, from a torch.Generator
    ct = A·s + e + Δ·msg
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch._common import MASK, as_i64, wrap_i32
from repro_torch.core import threefry
from repro_torch.kernels import ops

Q_BITS = 32
Q = 1 << Q_BITS


@dataclasses.dataclass(frozen=True)
class LWEParams:
    """Parameters of the LWE scheme (see the JAX twin for each field)."""

    k: int = 1024
    p: int = 256
    sigma: float = 6.4
    z_tail: float = 6.0
    q_switch: int | None = 1 << 16

    @property
    def delta(self) -> int:
        return Q // self.p

    @property
    def plaintext_bits(self) -> int:
        return int(math.log2(self.p))

    def __post_init__(self):
        if self.p & (self.p - 1):
            raise ValueError("p must be a power of two")
        if self.p > (1 << 16):
            raise ValueError("p > 2^16 unsupported (limb decomposition)")
        if self.q_switch is not None and self.q_switch & (self.q_switch - 1):
            raise ValueError("q_switch must be a power of two")


def noise_bound(params: LWEParams, n_inner: int) -> float:
    """High-probability bound on |<db_row, e>| for db entries in [0, p)."""
    return params.z_tail * params.sigma * (params.p - 1) * math.sqrt(n_inner)


def noise_budget_ok(params: LWEParams, n_inner: int) -> bool:
    """True iff decoding succeeds whp for a DB with n_inner columns."""
    budget = params.delta / 2.0
    slack = 0.0
    if params.q_switch is not None:
        slack = 3.0 * Q / (2.0 * params.q_switch)
    return noise_bound(params, n_inner) + slack < budget


def choose_params(n_inner: int, *, want_p: int = 256,
                  q_switch: int | None = 1 << 16) -> LWEParams:
    """Largest safe plaintext modulus ≤ want_p for an n_inner-column DB."""
    p = want_p
    while p >= 2:
        params = LWEParams(p=p, q_switch=q_switch)
        if noise_budget_ok(params, n_inner):
            return params
        p >>= 1
    raise ValueError(f"no safe plaintext modulus for n_inner={n_inner}")


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def gen_public_matrix(seed: int, n: int, k: int, *, device) -> torch.Tensor:
    """Public LWE matrix A (n, k), bitwise equal to the JAX package's."""
    key = threefry.fold_in(threefry.PRNGKey(seed), 0x5157)
    return threefry.bits(key, (n, k), device=device)


def keygen(gen: torch.Generator, params: LWEParams, batch: int | None = None
           ) -> torch.Tensor:
    """Uniform secret(s): (k,) or (k, batch) int32-held u32."""
    shape = (params.k,) if batch is None else (params.k, batch)
    return wrap_i32(uniform_bits(gen, shape))


def sample_error(gen: torch.Generator, shape, sigma: float) -> torch.Tensor:
    """Rounded-gaussian error mod q (negatives wrap), int32-held u32."""
    return round_error(standard_normal(gen, shape), sigma)


# The two draws and their finishing steps apart: the finishing steps are
# elementwise, so draws taken one by one can be finished together, in one
# launch, to the same bits as `keygen` and `sample_error` give.

def uniform_bits(gen: torch.Generator, shape) -> torch.Tensor:
    """`keygen`'s draw: int64 uniform in [0, 2^32); `wrap_i32` finishes it."""
    return torch.randint(0, Q, shape, dtype=torch.int64, generator=gen,
                         device=gen.device)


def standard_normal(gen: torch.Generator, shape) -> torch.Tensor:
    """`sample_error`'s draw: f32 standard normal; `round_error` finishes
    it."""
    return torch.randn(shape, dtype=torch.float32, generator=gen,
                       device=gen.device)


def round_error(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """round(sigma · x) as int32-held u32 (negatives wrap)."""
    return torch.round(sigma * x).to(torch.int32)


# ---------------------------------------------------------------------------
# Encrypt / decrypt
# ---------------------------------------------------------------------------

def encrypt_vector(s: torch.Tensor, a_mat: torch.Tensor, msg: torch.Tensor,
                   delta: int, e: torch.Tensor, *, impl: str = "auto"
                   ) -> torch.Tensor:
    """ct = A·s + e + Δ·msg (mod 2^32).

    s: (k,) or (k, B); msg and e: (n,) or (n, B).  Each column of a batch
    equals its own GEMV, so B queries share one A·S launch.
    """
    mask = as_i64(ops.mod_u32_matmul(a_mat, s, impl=impl))
    return wrap_i32(mask + as_i64(e) + delta * msg.to(torch.int64))


def _hs(hint: torch.Tensor, s: torch.Tensor, impl: str) -> torch.Tensor:
    return as_i64(ops.mod_u32_matmul(hint, s, impl=impl))


def hint_strip(ans: torch.Tensor, hint: torch.Tensor, s: torch.Tensor, *,
               impl: str = "auto") -> torch.Tensor:
    """ans − H·s (mod q): leaves Δ·(D·msg) + D·e."""
    return wrap_i32(as_i64(ans) - _hs(hint, s, impl))


def decode(rec: torch.Tensor, params: LWEParams) -> torch.Tensor:
    """Round Δ·x + noise → x ∈ Z_p, as int64."""
    half = params.delta // 2
    shifted = ((as_i64(rec) + half) & MASK) >> (Q_BITS - params.plaintext_bits)
    return shifted & (params.p - 1)


# ---------------------------------------------------------------------------
# Modulus switching
# ---------------------------------------------------------------------------

def switch_modulus(x: torch.Tensor, q_switch: int) -> torch.Tensor:
    """Round x from Z_{2^32} to Z_{q_switch} (power of two), int32 values."""
    return _switch_i64(as_i64(x), q_switch).to(torch.int32)


def _switch_i64(x64: torch.Tensor, q_switch: int) -> torch.Tensor:
    shift = Q_BITS - int(math.log2(q_switch))
    return ((x64 + (1 << (shift - 1))) & MASK) >> shift


def decode_switched(ans_sw: torch.Tensor, hint: torch.Tensor, s: torch.Tensor,
                    params: LWEParams, *, impl: str = "auto") -> torch.Tensor:
    """Decode a modulus-switched answer, as int64 values in [0, p).

    The client computes H·s exactly in Z_q, switches it to q_switch, and
    subtracts there; Δ maps to Δ·q_switch/q.
    """
    qs = params.q_switch
    if qs is None:
        raise ValueError("decode_switched needs params.q_switch")
    log_qs = int(math.log2(qs))
    hs_sw = _switch_i64(_hs(hint, s, impl), qs)
    rec = (ans_sw.to(torch.int64) - hs_sw) & (qs - 1)
    half = (qs // params.p) // 2
    return (((rec + half) & (qs - 1)) >> (log_qs - params.plaintext_bits)
            ) & (params.p - 1)
