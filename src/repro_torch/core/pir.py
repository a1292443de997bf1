"""SimplePIR-style single-server PIR on one device (twin of ``repro/core/pir.py``).

Protocol roles (honest-but-curious server):

  offline   server:  hint H = D·A  (one-time; A from a public seed)
            client:  downloads H (m×k u32) once
  online    client:  qu = A·s + e + Δ·onehot(i)
            server:  ans = D·qu (mod 2^32), switched to q_switch
            client:  decode(ans − H·s) → column i of D

All three products go through the exact mod-2^32 CUDA kernel on a card
(`kernels.ops`), the plain PyTorch version on the CPU.  A column swap (the
live index) patches the hint with ΔH = (D_new − D_old)[:, J]·A[J, :]
through the delta-hint kernel instead of a new setup.  u32 values are
int32 tensors holding the same bits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._common import to_device
from repro_torch.core import lwe
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class PIRConfig:
    m: int                       # DB rows (cluster content bytes / entry)
    n: int                       # DB cols (number of clusters)
    params: lwe.LWEParams
    a_seed: int = 7              # public seed for the LWE matrix A
    impl: str = "auto"           # kernel dispatch for every product

    def __post_init__(self):
        if not lwe.noise_budget_ok(self.params, self.n):
            raise ValueError(
                f"LWE noise budget violated for n={self.n}, p={self.params.p}")

    @property
    def uplink_bytes(self) -> int:
        """Query size: one u32 ciphertext entry per DB column (n·4)."""
        return self.n * 4

    @property
    def downlink_bytes(self) -> int:
        """Response size: m words — 2 B each when modulus-switched ≤ 2^16."""
        qs = self.params.q_switch
        per = 2 if (qs is not None and qs <= 1 << 16) else 4
        return self.m * per

    @property
    def hint_bytes(self) -> int:
        """One-time client download: the (m, k) u32 hint H = D·A."""
        return self.m * self.params.k * 4


class PIRServer:
    """Holds the plaintext DB ((m, n) uint8 tensor, entries < p) on its device
    and answers encrypted queries there."""

    def __init__(self, cfg: PIRConfig, db: torch.Tensor):
        if tuple(db.shape) != (cfg.m, cfg.n) or db.dtype != torch.uint8:
            raise ValueError(f"db must be ({cfg.m}, {cfg.n}) uint8, got "
                             f"{tuple(db.shape)} {db.dtype}")
        self.cfg = cfg
        self.db = db.contiguous()
        self._a_mat: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.db.device

    @property
    def a_matrix(self) -> torch.Tensor:
        """The public LWE matrix A (seed-derived, cached)."""
        if self._a_mat is None:
            self._a_mat = lwe.gen_public_matrix(
                self.cfg.a_seed, self.cfg.n, self.cfg.params.k,
                device=self.device)
        return self._a_mat

    def setup(self) -> torch.Tensor:
        """Offline hint H = D·A ∈ Z_q^{m×k} (the heavy one-time GEMM)."""
        return ops.hint_gemm(self.db, self.a_matrix, impl=self.cfg.impl)

    def answer(self, qu: torch.Tensor) -> torch.Tensor:
        """Online answer: D·qu mod 2^32, modulus-switched when configured.

        qu: (n,) or (n, batch) int32-held u32.
        """
        ans = ops.modmatmul(self.db, qu, impl=self.cfg.impl)
        if self.cfg.params.q_switch is not None:
            ans = lwe.switch_modulus(ans, self.cfg.params.q_switch)
        return ans

    def _check_swap(self, cols: torch.Tensor, new_cols: torch.Tensor
                    ) -> torch.Tensor:
        cols = torch.as_tensor(cols, dtype=torch.int64, device=self.device)
        if (tuple(new_cols.shape) != (self.cfg.m, cols.numel())
                or new_cols.dtype != torch.uint8
                or new_cols.device != self.device):
            raise ValueError(f"new_cols must be ({self.cfg.m}, {cols.numel()})"
                             f" uint8 on {self.device}, got "
                             f"{tuple(new_cols.shape)} {new_cols.dtype} on "
                             f"{new_cols.device}")
        return cols

    def stage_delta(self, cols: torch.Tensor, new_cols: torch.Tensor
                    ) -> torch.Tensor:
        """The hint delta ΔH = (D_new − D_old)[:, J]·A[J, :] of a column swap,
        without touching ``self.db``.

        Reads the old columns from the live DB, so it must be queued before
        any donating scatter of the same swap.  cols: (J,) column ids;
        new_cols: (m, J) uint8 on the server's device.  Returns (m, k)
        int32-held u32.  The JAX twin pads J to a power of two to reuse
        compiled shapes; its pad slots add exactly 0, so ΔH is the same.
        """
        cols = self._check_swap(cols, new_cols)
        old_cols = self.db[:, cols]
        a_j = self.a_matrix[cols]
        return ops.delta_gemm(new_cols, old_cols, a_j, impl=self.cfg.impl)

    def stage_scatter(self, cols: torch.Tensor, new_cols: torch.Tensor, *,
                      donate: bool = False) -> torch.Tensor:
        """The patched DB for a column swap; ``self.db`` is not reassigned.

        ``donate=True`` writes the columns into the live DB tensor itself:
        only a caller that publishes the result at once may pass it (the
        live index does so in its publish step).
        """
        cols = self._check_swap(cols, new_cols)
        return ops.scatter_columns(self.db, cols, new_cols, donate=donate)

    def stage_update(self, cols: torch.Tensor, new_cols: torch.Tensor, *,
                     donate: bool = False
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """(new DB, ΔH) for a column swap without publishing it:
        `stage_delta` (which reads the old columns first), then
        `stage_scatter`."""
        delta_h = self.stage_delta(cols, new_cols)
        return self.stage_scatter(cols, new_cols, donate=donate), delta_h

    def update_columns(self, cols: torch.Tensor, new_cols: torch.Tensor, *,
                       donate: bool = False) -> torch.Tensor:
        """Replace DB columns J and return the exact hint delta ΔH.

        The hint is linear in the DB, so ``hint + ΔH`` equals `setup()` on
        the updated DB bit for bit (all arithmetic exact mod 2^32).
        """
        new_db, delta_h = self.stage_update(cols, new_cols, donate=donate)
        self.db = new_db
        return delta_h


@dataclasses.dataclass
class ClientQueryState:
    secret: torch.Tensor         # s ∈ Z_q^k, int32-held
    index: int                   # queried column (kept client-side!)


class PIRClient:
    """Client side: query formulation and response decoding."""

    def __init__(self, cfg: PIRConfig, hint: torch.Tensor, *,
                 a_mat: torch.Tensor | None = None):
        if tuple(hint.shape) != (cfg.m, cfg.params.k):
            raise ValueError(f"hint shape {tuple(hint.shape)} != "
                             f"{(cfg.m, cfg.params.k)}")
        self.cfg = cfg
        self.hint = hint
        self._a_mat = (a_mat if a_mat is not None else lwe.gen_public_matrix(
            cfg.a_seed, cfg.n, cfg.params.k, device=hint.device))

    def query_batch(self, gen: torch.Generator, indices, *,
                    secrets: torch.Tensor | None = None,
                    errors: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Encrypt one-hot selectors for B columns in one A·S launch.

        Returns (qs (n, B), secrets (k, B)), both int32-held u32.  Secrets
        and errors come from ``gen`` unless given (tests inject the JAX
        package's).
        """
        idx = np.asarray([int(i) for i in indices], np.int64)
        b = len(idx)
        p = self.cfg.params
        if secrets is None:
            secrets = lwe.keygen(gen, p, b)
        if errors is None:
            errors = lwe.sample_error(gen, (self.cfg.n, b), p.sigma)
        # built on the host and copied without waiting on the stream
        onehot_np = np.zeros((self.cfg.n, b), np.int32)
        onehot_np[idx, np.arange(b)] = 1
        onehot = to_device(onehot_np, self.hint.device)
        qs = lwe.encrypt_vector(secrets, self._a_mat, onehot, p.delta, errors,
                                impl=self.cfg.impl)
        return qs, secrets

    def query(self, gen: torch.Generator, index: int
              ) -> tuple[torch.Tensor, ClientQueryState]:
        """Encrypt a one-hot selector for column `index`."""
        qs, secrets = self.query_batch(gen, [index])
        return qs[:, 0], ClientQueryState(secret=secrets[:, 0], index=index)

    def recover(self, ans: torch.Tensor, state: ClientQueryState
                ) -> torch.Tensor:
        """Decode the server answer into the plaintext column (m,) u8."""
        return self.recover_batch(ans[:, None], state.secret[:, None])[:, 0]

    def recover_batch(self, ans: torch.Tensor, secrets: torch.Tensor
                      ) -> torch.Tensor:
        """Decode C answers at once: ans (m, C), secrets (k, C) → (m, C) u8.

        The hint strip is one (m,k)·(k,C) product; column j is identical to
        ``recover(ans[:, j], state_j)``.
        """
        p = self.cfg.params
        if p.q_switch is not None:
            vals = lwe.decode_switched(ans, self.hint, secrets, p,
                                       impl=self.cfg.impl)
        else:
            rec = lwe.hint_strip(ans, self.hint, secrets, impl=self.cfg.impl)
            vals = lwe.decode(rec, p)
        return vals.to(torch.uint8)


def make_config(m: int, n: int, *, impl: str = "auto",
                q_switch: int | None = 1 << 16,
                a_seed: int = 7) -> PIRConfig:
    """PIRConfig for an (m, n) database with auto-chosen LWE parameters."""
    params = lwe.choose_params(n, want_p=256, q_switch=q_switch)
    return PIRConfig(m=m, n=n, params=params, impl=impl, a_seed=a_seed)
