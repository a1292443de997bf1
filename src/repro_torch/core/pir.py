"""SimplePIR-style single-server PIR on one device (twin of ``repro/core/pir.py``).

Protocol roles (honest-but-curious server):

  offline   server:  hint H = D·A  (one-time; A from a public seed)
            client:  downloads H (m×k u32) once
  online    client:  qu = A·s + e + Δ·onehot(i)
            server:  ans = D·qu (mod 2^32), switched to q_switch
            client:  decode(ans − H·s) → column i of D

All three products go through the exact mod-2^32 CUDA kernel on a card
(`kernels.ops`), the plain PyTorch version on the CPU.  ``mesh=`` row-shards
the DB over a `launch.mesh.DeviceMesh` (the JAX twin's ``mesh=`` branches):
each shard answers, hints and patches its own rows.  A column swap (the
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
from repro_torch.distributed import collectives
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


def _as_tensor(a) -> torch.Tensor:
    """A host array as a tensor sharing its memory; a tensor as is."""
    return torch.from_numpy(np.ascontiguousarray(a)) if isinstance(
        a, np.ndarray) else a


class PIRServer:
    """Holds the plaintext DB ((m, n) uint8, entries < p) on its device and
    answers encrypted queries there.

    The DB is held as row shards, one per device of ``mesh=`` (a
    `launch.mesh.DeviceMesh`), or one shard without a mesh, and every
    method has the one body: each shard answers, hints and patches its own
    rows (zero collectives: the contraction, cluster, axis is never split),
    and the hint, answers and ΔH gather on the first shard's device, the
    client's.  Rows pad with zeros to a multiple of the shard count, and the
    pad rows stay zero across column swaps.  ``db`` is the (m, n) tensor
    without a mesh and the tuple of S equal row slices with one.  ``db``
    given to the constructor may be a full (m, n) host array or tensor,
    split and placed slice by slice, or S per-shard slices
    (``ChunkedDB.row_shards``), each placed straight on its device.
    """

    def __init__(self, cfg: PIRConfig, db, *, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self._a_mat: torch.Tensor | None = None
        shards = 1 if mesh is None else len(mesh.devices)
        self._row_pad = (-cfg.m) % shards
        rows = (cfg.m + self._row_pad) // shards
        if isinstance(db, (list, tuple)):
            parts = [_as_tensor(p) for p in db]
        else:
            full = _as_tensor(db)
            if tuple(full.shape) != (cfg.m, cfg.n):
                raise ValueError(f"db must be ({cfg.m}, {cfg.n}) uint8, got "
                                 f"{tuple(full.shape)} {full.dtype}")
            if self._row_pad:
                full = torch.cat([full, full.new_zeros((self._row_pad,
                                                        cfg.n))])
            parts = collectives.place_rows(full, [full.device] * shards)
        devices = [parts[0].device] if mesh is None else mesh.devices
        if len(parts) != len(devices):
            raise ValueError(f"{len(parts)} row shards for {len(devices)} "
                             f"devices")
        for part in parts:
            if tuple(part.shape) != (rows, cfg.n) or part.dtype != torch.uint8:
                raise ValueError(f"row shards must be ({rows}, {cfg.n}) "
                                 f"uint8, got {tuple(part.shape)} "
                                 f"{part.dtype}")
        self._shards = [p.to(d).contiguous() for p, d in zip(parts, devices)]

    @property
    def db(self):
        """The live DB: the (m, n) tensor, or on a mesh the tuple of row
        shards."""
        return self._shards[0] if self.mesh is None else tuple(self._shards)

    @db.setter
    def db(self, value) -> None:
        self._shards = [value] if self.mesh is None else list(value)

    def _as_db(self, parts: list[torch.Tensor]):
        """Per-shard tensors in the form `db` takes."""
        return parts[0] if self.mesh is None else tuple(parts)

    @property
    def device(self) -> torch.device:
        """Where the server's results land: the first shard's device (the
        mesh's home device)."""
        return self._shards[0].device

    @property
    def a_matrix(self) -> torch.Tensor:
        """The public LWE matrix A (seed-derived, cached)."""
        if self._a_mat is None:
            self._a_mat = lwe.gen_public_matrix(
                self.cfg.a_seed, self.cfg.n, self.cfg.params.k,
                device=self.device)
        return self._a_mat

    def _gather(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """Per-shard rows as the global (m, ...) result on the home device:
        the pad rows are cut."""
        return collectives.gather(parts, self.device)[:self.cfg.m]

    def _old_columns(self, cols: torch.Tensor) -> list[torch.Tensor]:
        """Each shard's rows of the live DB's columns ``cols``."""
        return [d[:, c] for d, c in zip(self._shards, collectives.replicate(
            cols, [d.device for d in self._shards]))]

    def setup(self) -> torch.Tensor:
        """Offline hint H = D·A ∈ Z_q^{m×k} (the heavy one-time GEMM): each
        shard's hint rows on its device, gathered on the home device."""
        return self._gather(collectives.row_shard_gemm(
            self._shards, self.a_matrix, impl=self.cfg.impl))

    def answer(self, qu: torch.Tensor) -> torch.Tensor:
        """Online answer: D·qu mod 2^32, modulus-switched when configured.

        qu: (n,) or (n, batch) int32-held u32.
        """
        return self._gather(collectives.row_shard_gemm(
            self._shards, qu, impl=self.cfg.impl,
            q_switch=self.cfg.params.q_switch))

    def columns(self, cols: torch.Tensor, rows: int) -> np.ndarray:
        """The first ``rows`` rows of the live DB's columns ``cols``, on the
        host ((rows, J) uint8)."""
        return self._gather(self._old_columns(cols))[:rows].cpu().numpy()

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

    def _shard_rows(self, new_cols: torch.Tensor) -> list[torch.Tensor]:
        """Each shard's rows of ``new_cols`` on its device, the pad rows
        zero."""
        if self._row_pad:
            new_cols = torch.cat([new_cols, new_cols.new_zeros(
                (self._row_pad, new_cols.shape[1]))])
        return collectives.place_rows(new_cols,
                                      [d.device for d in self._shards])

    def stage_delta(self, cols: torch.Tensor, new_cols: torch.Tensor
                    ) -> torch.Tensor:
        """The hint delta ΔH = (D_new − D_old)[:, J]·A[J, :] of a column swap,
        without touching ``self.db``.

        Reads the old columns from the live DB, so it must be queued before
        any donating scatter of the same swap.  cols: (J,) column ids;
        new_cols: (m, J) uint8 on the server's device.  Returns (m, k)
        int32-held u32: each shard's rows of ΔH from its own rows, gathered
        on the home device.  The JAX twin pads J to a power of two to reuse
        compiled shapes; its pad slots add exactly 0, so ΔH is the same.
        """
        cols = self._check_swap(cols, new_cols)
        return self._gather(collectives.row_shard_delta_gemm(
            self._shard_rows(new_cols), self._old_columns(cols),
            self.a_matrix[cols], impl=self.cfg.impl))

    def stage_scatter(self, cols: torch.Tensor, new_cols: torch.Tensor, *,
                      donate: bool = False):
        """The patched DB for a column swap, in the form of `db`;
        ``self.db`` is not reassigned.

        ``donate=True`` writes the columns into the live DB tensor (each
        live shard) itself: only a caller that publishes the result at once
        may pass it (the live index does so in its publish step).
        """
        cols = self._check_swap(cols, new_cols)
        return self._as_db(collectives.row_shard_scatter(
            self._shards, cols, self._shard_rows(new_cols), donate=donate))

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
