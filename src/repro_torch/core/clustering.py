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

One core (`_kmeans_core`) serves one device and a row-sharded corpus
(`kmeans_fit_sharded`, over a `launch.mesh.DeviceMesh`): each shard owns a
contiguous run of the canonical blocks, kmeans++ samples the gathered
global D² on the generator's device, and each Lloyd step gathers the
per-block partials in shard order and reduces them there as one device
does, so a sharded fit is bitwise the unsharded fit at the same block
count.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch._common import on_device
from repro_torch.distributed import collectives
from repro_torch.kernels import ops

#: Canonical number of corpus row blocks used by the offline build.
BUILD_BLOCKS = 8


def build_blocks(shards: int) -> int:
    """The offline build's block count over ``shards`` row shards: the
    fewest blocks that both `BUILD_BLOCKS` and ``shards`` divide, so each
    shard owns whole blocks (`BUILD_BLOCKS` itself unsharded)."""
    return math.lcm(BUILD_BLOCKS, shards)


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


def _fetch_row(xs: list[torch.Tensor], idx: torch.Tensor,
               home: torch.device) -> torch.Tensor:
    """Row ``idx`` ((1,) on ``home``) of the row-sharded corpus, as (1, d)
    on ``home``.  Every shard offers its candidate row and the owner's is
    selected by `torch.where`, which is exact; nothing waits on the host."""
    if len(xs) == 1:
        return xs[0].index_select(0, idx.to(xs[0].device)).to(home)
    row, lo = None, 0
    for x in xs:
        rows = x.shape[0]
        local = (idx - lo).clamp(0, rows - 1).to(x.device)
        cand = x.index_select(0, local).to(home)
        own = ((idx >= lo) & (idx < lo + rows))[:, None]
        row = cand if row is None else torch.where(own, cand, row)
        lo += rows
    return row


def _kmeanspp_core(gen: torch.Generator, xs: list[torch.Tensor],
                   valids: list[torch.Tensor], k: int, n: int
                   ) -> torch.Tensor:
    """D²-weighted seeding (Arthur & Vassilvitskii) over row shards.

    xs: the padded corpus's row shards (one on the unsharded path); valids
    mask padding rows out of the draw.  Each draw samples the gathered
    global D² on ``gen``'s device, so every layout draws from the same
    tensor.  Every draw stays on the device: no host round-trip per step.
    """
    home = gen.device
    first = torch.randint(0, n, (1,), generator=gen, device=home)
    c = _fetch_row(xs, first, home)
    mind2 = [torch.sum((x - c.to(x.device)) ** 2, dim=1) for x in xs]
    cents = c.new_zeros((k, c.shape[1]))
    cents[0] = c[0]
    for i in range(1, k):
        w = collectives.gather(
            [torch.where(v, m + 1e-12, torch.zeros_like(m))
             for v, m in zip(valids, mind2)], home)
        idx = torch.multinomial(w, 1, generator=gen)
        c = _fetch_row(xs, idx, home)
        cents[i] = c[0]
        mind2 = [torch.minimum(m, torch.sum((x - c.to(x.device)) ** 2, dim=1))
                 for x, m in zip(xs, mind2)]
    return cents


def _kmeanspp(gen: torch.Generator, x: torch.Tensor, valid: torch.Tensor,
              k: int, n: int) -> torch.Tensor:
    """`_kmeanspp_core` on one device: x (rows, d) f32, padded."""
    return _kmeanspp_core(gen, [x], [valid], k, n)


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


def _lloyd_core(xs: list[torch.Tensor], valids: list[torch.Tensor],
                cents0: torch.Tensor, *, k: int, iters: int, blocks: int,
                n: int, impl: str):
    """``iters`` block-canonical Lloyd steps from ``cents0`` over row
    shards, each of ``blocks`` blocks (the local block count).

    Each shard computes its blocks' partials on its device; they gather in
    shard order, which is canonical block order, and reduce on
    ``cents0``'s device exactly as one device reduces them.  Empty clusters
    keep their centroid.  Returns (centroids, assignment (rows,) i32
    against the final centroids, gathered, final-step inertia).
    """
    home = cents0.device
    devices = [x.device for x in xs]
    xbs = [x.reshape(blocks, x.shape[0] // blocks, x.shape[1]) for x in xs]
    vbs = [v.reshape(blocks, v.shape[0] // blocks) for v in valids]
    cents = cents0
    inertia = torch.zeros((), dtype=cents0.dtype, device=home)
    for _ in range(iters):
        parts = []
        for xb, vb, c in zip(xbs, vbs, collectives.replicate(cents, devices)):
            with on_device(c.device):
                parts += [_block_stats(xb[b], vb[b], c, k, impl)
                          for b in range(blocks)]
        tot = torch.stack([p[0].to(home) for p in parts]).sum(dim=0)
        cnt = torch.stack([p[1].to(home) for p in parts]).sum(dim=0)
        w = torch.stack([p[2].to(home) for p in parts])
        cents = torch.where(cnt[:, None] > 0,
                            tot / torch.clamp(cnt, min=1)[:, None], cents)
        inertia = torch.sum(w) / n
    assign = []
    for xb, c in zip(xbs, collectives.replicate(cents, devices)):
        with on_device(c.device):
            assign.append(torch.cat([ops.kmeans_assign(xb[b], c,
                                                       impl=impl)[0]
                                     for b in range(blocks)]))
    return cents, collectives.gather(assign, home), inertia


def _lloyd(x: torch.Tensor, valid: torch.Tensor, cents0: torch.Tensor, *,
           k: int, iters: int, blocks: int, n: int, impl: str):
    """`_lloyd_core` on one device: x (rows, d) f32 with rows divisible by
    ``blocks``; valid (rows,) bool."""
    return _lloyd_core([x], [valid], cents0, k=k, iters=iters, blocks=blocks,
                       n=n, impl=impl)


def _kmeans_core(gen: torch.Generator, xs: list[torch.Tensor],
                 valids: list[torch.Tensor], *, k: int, iters: int,
                 blocks: int, n: int, impl: str):
    """kmeans++ then Lloyd over row shards of ``blocks`` blocks each: the
    one core of the unsharded and the sharded fit."""
    cents0 = _kmeanspp_core(gen, xs, valids, k, n)
    return _lloyd_core(xs, valids, cents0, k=k, iters=iters, blocks=blocks,
                       n=n, impl=impl)


def kmeans_fit(gen: torch.Generator, x: torch.Tensor, *, k: int,
               iters: int = 25, n_blocks: int = 1, impl: str = "auto"
               ) -> KMeansResult:
    """kmeans++ init then ``iters`` Lloyd steps; x (N, d) f32 on its device."""
    n = x.shape[0]
    xp, valid = _pad_rows(x.to(torch.float32), n_blocks)
    cents, assign, inertia = _kmeans_core(gen, [xp], [valid], k=k,
                                          iters=iters, blocks=n_blocks, n=n,
                                          impl=impl)
    return KMeansResult(cents, assign[:n], inertia)


def _place_padded(x, mult: int, devices: list[torch.device]):
    """x ((N, d) numpy or tensor) zero-padded to a multiple of ``mult`` rows
    on the host and split into row shards on ``devices``: (shards, valid
    shards)."""
    x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x, np.float32)
    n = x.shape[0]
    pad = (-n) % mult
    xp = np.zeros((n + pad, x.shape[1]), np.float32)
    xp[:n] = x
    return (collectives.place_rows(xp, devices),
            collectives.place_rows(np.arange(n + pad) < n, devices))


def kmeans_fit_sharded(gen: torch.Generator, x, *, k: int, iters: int = 25,
                       mesh, impl: str = "auto") -> KMeansResult:
    """`kmeans_fit` with the corpus row-sharded over ``mesh``.

    x: (N, d) f32, numpy or a tensor; rows pad to a multiple of
    ``build_blocks(shards)`` and each shard's slice goes straight to its
    device.  kmeans++ draws from the gathered global D² with ``gen``; each
    Lloyd step reduces the gathered per-block partials in canonical block
    order.  Results land on ``gen``'s device, bitwise equal to
    ``kmeans_fit(..., n_blocks=build_blocks(shards))`` on one device.
    """
    shards = len(mesh.devices)
    blocks = build_blocks(shards)
    xs, vs = _place_padded(x, blocks, mesh.devices)
    cents, assign, inertia = _kmeans_core(gen, xs, vs, k=k, iters=iters,
                                          blocks=blocks // shards,
                                          n=x.shape[0], impl=impl)
    return KMeansResult(cents, assign[:x.shape[0]], inertia)


def assign_to_centroids(x: torch.Tensor, cents: torch.Tensor, *,
                        impl: str = "auto") -> torch.Tensor:
    """Nearest-centroid assignment, (N,) i32, through the fused kernel."""
    return ops.kmeans_assign(x, cents, impl=impl)[0]


def blocked_sqdist(x, cents: torch.Tensor, *, n_blocks: int = BUILD_BLOCKS,
                   mesh=None) -> torch.Tensor:
    """(N, k) f32 squared distances, one row block at a time.

    x: a tensor; with ``mesh=`` also a numpy array, whose rows shard over
    the mesh (``n_blocks`` a multiple of the shard count): each shard runs
    its own blocks' products on its device and the rows gather on the
    mesh's home device, so the distances are the same on every layout.
    """
    n = x.shape[0]
    if mesh is None:
        xs = [_pad_rows(x.to(torch.float32), n_blocks)[0]]
        home = x.device
    else:
        if n_blocks % len(mesh.devices):
            raise ValueError(f"n_blocks {n_blocks} not divisible by "
                             f"{len(mesh.devices)} shards")
        xs, _ = _place_padded(x, n_blocks, mesh.devices)
        home = mesh.home
    per = n_blocks // len(xs)
    parts = []
    for xp, c in zip(xs, collectives.replicate(cents,
                                               [p.device for p in xs])):
        rows = xp.shape[0] // per
        parts += [pairwise_sqdist(xp[b * rows:(b + 1) * rows], c)
                  for b in range(per)]
    return collectives.gather(parts, home)[:n]


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
