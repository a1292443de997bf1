"""K-means for the offline corpus partition (twin of ``repro/core/clustering.py``).

kmeans++ seeding, then Lloyd iterations, in the JAX package's
*block-canonical* form: the corpus splits into ``n_blocks`` equal row
blocks, every reduction (centroid sums, counts, inertia) is computed per
block and combined over blocks in a fixed order.  Assignment goes through
`kernels.ops.kmeans_assign` (the fused CUDA kernel on a card).

The per-block segment sums are a one-hot fp32 product, not ``index_add_``
or ``scatter_add_``: on CUDA those use float atomics and differ from run to
run, and the build must be deterministic as the JAX one is.  (The product
runs in full fp32: torch leaves TF32 off for matmul unless a caller turns
``torch.backends.cuda.matmul.allow_tf32`` on.)

kmeans++ draws come from a torch generator, so they are not JAX's draws;
`_lloyd` takes the initial centroids as an argument, which lets a test start
it from the JAX package's own kmeans++ output.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import ops

#: Canonical number of corpus row blocks used by the offline build.
BUILD_BLOCKS = 8


class KMeansResult(NamedTuple):
    centroids: torch.Tensor   # (k, d) f32
    assignment: torch.Tensor  # (N,) i32
    inertia: torch.Tensor     # () f32, final-iteration mean squared distance


def pairwise_sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """||x_i - c_j||² as a GEMM.  x: (N, d) f32, c: (k, d) f32 → (N, k) f32."""
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    c2 = torch.sum(c * c, dim=1)[None, :]
    return x2 - 2.0 * (x @ c.T) + c2


def _pad_rows(x: torch.Tensor, mult: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero-pad rows to a multiple of ``mult``; (padded, valid mask)."""
    n = x.shape[0]
    pad = (-n) % mult
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x, torch.arange(n + pad, device=x.device) < n


def _kmeanspp(gen: torch.Generator, x: torch.Tensor, valid: torch.Tensor,
              k: int, n: int) -> torch.Tensor:
    """D²-weighted seeding (Arthur & Vassilvitskii) with torch draws.

    x: (rows, d) f32, padded; valid masks padding rows out of the draw.
    Every draw stays on the device: no host round-trip per step.
    """
    first = torch.randint(0, n, (1,), generator=gen, device=x.device)
    c = x.index_select(0, first)
    mind2 = torch.sum((x - c) ** 2, dim=1)
    cents = x.new_zeros((k, x.shape[1]))
    cents[0] = c[0]
    for i in range(1, k):
        w = torch.where(valid, mind2 + 1e-12, torch.zeros_like(mind2))
        idx = torch.multinomial(w, 1, generator=gen)
        c = x.index_select(0, idx)
        cents[i] = c[0]
        mind2 = torch.minimum(mind2, torch.sum((x - c) ** 2, dim=1))
    return cents


def _block_stats(xb: torch.Tensor, vb: torch.Tensor, cents: torch.Tensor,
                 k: int, impl: str):
    """One block's Lloyd partials: (sums (k, d), counts (k,), Σ min-d²)."""
    assign, mind2 = ops.kmeans_assign(xb, cents, impl=impl)
    seg = torch.where(vb, assign.to(torch.int64), k)      # padding → row k
    onehot = (seg[None, :] == torch.arange(
        k, device=xb.device)[:, None]).to(xb.dtype)        # (k, rows)
    sums = onehot @ xb
    cnts = onehot.sum(dim=1)
    w = torch.sum(torch.where(vb, mind2, torch.zeros_like(mind2)))
    return sums, cnts, w


def _lloyd(x: torch.Tensor, valid: torch.Tensor, cents0: torch.Tensor, *,
           k: int, iters: int, blocks: int, n: int, impl: str):
    """``iters`` block-canonical Lloyd steps from ``cents0``.

    x: (rows, d) f32 with rows divisible by ``blocks``; valid: (rows,) bool.
    Empty clusters keep their centroid.  Returns (centroids, assignment
    (rows,) i32 against the final centroids, final-step inertia).
    """
    rows, d = x.shape
    xb = x.reshape(blocks, rows // blocks, d)
    vb = valid.reshape(blocks, rows // blocks)
    cents = cents0
    inertia = torch.zeros((), dtype=x.dtype, device=x.device)
    for _ in range(iters):
        parts = [_block_stats(xb[b], vb[b], cents, k, impl)
                 for b in range(blocks)]
        tot = torch.stack([p[0] for p in parts]).sum(dim=0)
        cnt = torch.stack([p[1] for p in parts]).sum(dim=0)
        w = torch.stack([p[2] for p in parts])
        cents = torch.where(cnt[:, None] > 0,
                            tot / torch.clamp(cnt, min=1)[:, None], cents)
        inertia = torch.sum(w) / n
    assign = torch.cat([ops.kmeans_assign(xb[b], cents, impl=impl)[0]
                        for b in range(blocks)])
    return cents, assign, inertia


def kmeans_fit(gen: torch.Generator, x: torch.Tensor, *, k: int,
               iters: int = 25, n_blocks: int = 1, impl: str = "auto"
               ) -> KMeansResult:
    """kmeans++ init then ``iters`` Lloyd steps; x (N, d) f32 on its device."""
    n = x.shape[0]
    xp, valid = _pad_rows(x.to(torch.float32), n_blocks)
    cents0 = _kmeanspp(gen, xp, valid, k, n)
    cents, assign, inertia = _lloyd(xp, valid, cents0, k=k, iters=iters,
                                    blocks=n_blocks, n=n, impl=impl)
    return KMeansResult(cents, assign[:n], inertia)


def assign_to_centroids(x: torch.Tensor, cents: torch.Tensor, *,
                        impl: str = "auto") -> torch.Tensor:
    """Nearest-centroid assignment, (N,) i32, through the fused kernel."""
    return ops.kmeans_assign(x, cents, impl=impl)[0]


def blocked_sqdist(x: torch.Tensor, cents: torch.Tensor, *,
                   n_blocks: int = BUILD_BLOCKS) -> torch.Tensor:
    """(N, k) f32 squared distances, one row block at a time."""
    n = x.shape[0]
    xp, _ = _pad_rows(x.to(torch.float32), n_blocks)
    rows = xp.shape[0] // n_blocks
    return torch.cat([pairwise_sqdist(xp[b * rows:(b + 1) * rows], cents)
                      for b in range(n_blocks)])[:n]


def balanced_assign(x: np.ndarray, cents: np.ndarray, cap: int,
                    batch: int = 65536, *,
                    d2: np.ndarray | None = None) -> np.ndarray:
    """Greedy capacity-capped assignment (host-side numpy).  (N,) i32.

    Deferred acceptance with the confidence order (margin to the best
    centroid) as every cluster's common priority — the JAX package's
    algorithm, copied so that equal ``d2`` gives an equal assignment.
    """
    n, k = x.shape[0], cents.shape[0]
    if cap * k < n:
        raise ValueError(f"cap {cap} × k {k} < N {n}")
    if d2 is None:
        d2 = np.empty((n, k), np.float32)
        for s in range(0, n, batch):
            xb = x[s:s + batch]
            d2[s:s + batch] = (
                (xb * xb).sum(1, keepdims=True) - 2 * xb @ cents.T
                + (cents * cents).sum(1)[None, :])
    else:
        d2 = np.asarray(d2, np.float32)
        if d2.shape != (n, k):
            raise ValueError(f"d2 has shape {d2.shape}, expected {(n, k)}")
    best = d2.min(axis=1)
    order = np.argsort(best)
    d2r = d2[order]
    free = np.arange(n)
    held: list[np.ndarray] = [np.empty(0, np.int64) for _ in range(k)]
    thr = np.full(k, n, np.int64)
    while free.size:
        sub = d2r if free.size == n else d2r[free]
        if (thr == n).all():
            props = sub.argmin(1)
        else:
            masked = np.where(thr[None, :] >= free[:, None], sub, np.inf)
            props = masked.argmin(1)
            assert np.isfinite(
                masked[np.arange(free.size), props]).all()
        srt = np.lexsort((free, props))
        f, p = free[srt], props[srt]
        bounds = np.flatnonzero(np.diff(p)) + 1
        rejected: list[np.ndarray] = []
        for c, g in zip(p[np.concatenate(([0], bounds))],
                        np.split(f, bounds)):
            merged = np.sort(np.concatenate((held[c], g)))
            held[c] = merged[:cap]
            if merged.size >= cap:
                thr[c] = held[c][-1]
            if merged.size > cap:
                rejected.append(merged[cap:])
        free = (np.concatenate(rejected) if rejected
                else np.empty(0, np.int64))
    out = np.full(n, -1, np.int32)
    for c in range(k):
        out[order[held[c]]] = c
    assert (out >= 0).all()
    return out
