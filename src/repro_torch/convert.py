"""Carry a clustered corpus's state into the port.

`system_from_state` takes the numpy arrays that fix a build — centroids,
the doc→cluster assignment, the public seed ``a_seed`` and the external doc
ids — and packs and hints on the port's side.  Given the JAX package's
arrays (for example ``np.asarray(sys.centroids)``, ``sys.assignment``,
``sys.cfg.a_seed`` of a ``repro`` build), the port's DB bytes, hint and
answers equal the reference's bit for bit.  `live_from_state` wraps such a
system as a `LiveIndex`, so the same mutations through the JAX package's
live index and the port's give the same patches, DB bytes and hints.
``batch=`` carries a batch-PIR subsystem across: its knobs (``kappa``,
``n_buckets`` and the partition ``seed``, e.g. ``sys.batch.kappa``,
``sys.batch.partition.n_buckets``, ``sys.batch.seed``) fix the cuckoo
placement, so the sub-DBs, bucket hints and answers equal the reference's
too.  ``mesh=`` (a `launch.mesh.DeviceMesh`) packs and serves the same
state row-sharded, so the reference's clustering carries onto a sharded
port system; a keyed system has no float draws to carry and is built with
`PirRagSystem.build_keyed` directly.  `tiptoe_from_state` and
`graph_from_state` carry the baselines' k-means outcome across the same
way (their only float draws), so the port's cluster matrices, hints and
search results equal the reference's.
`lm_params_from_state` and `generator_from_state` carry a decoder LM's
weights across: the reference's ``transformer.init`` tree as numpy (blocks
stacked over layers for its scan) becomes the port's per-layer tree,
bitwise.  Nothing here imports JAX.
"""
from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from repro_torch._common import resolve_device
from repro_torch.core.baselines.graph_pir import GraphPIRSystem
from repro_torch.core.baselines.tiptoe import TiptoeSystem
from repro_torch.core.pipeline import PirRagSystem, mesh_device
from repro_torch.models.transformer import LMConfig
from repro_torch.rag.generate import Generator
from repro_torch.rag.prompt import PromptSpec
from repro_torch.update.live import LiveIndex


def system_from_state(texts: Sequence[bytes], embeddings: np.ndarray, *,
                      centroids: np.ndarray, assignment: np.ndarray,
                      n_clusters: int, a_seed: int, chunk_size: int = 256,
                      q_switch: int | None = 1 << 16, impl: str = "auto",
                      doc_ids: Sequence[int] | None = None,
                      batch: dict | None = None,
                      device: str | torch.device | None = None,
                      mesh=None) -> PirRagSystem:
    """A `PirRagSystem` on ``device`` (row-sharded over ``mesh``) from a
    finished clustering; with ``batch`` (`PirRagSystem.enable_batch`
    keywords) batch-PIR enabled."""
    dev = mesh_device(mesh, device)
    system = PirRagSystem._from_parts(
        texts, np.asarray(embeddings, np.float32),
        np.asarray(centroids, np.float32), np.asarray(assignment),
        n_clusters, a_seed=int(a_seed), chunk_size=chunk_size,
        q_switch=q_switch, impl=impl, device=dev, t0=time.perf_counter(),
        doc_ids=doc_ids, mesh=mesh)
    if batch is not None:
        system.enable_batch(**batch)
    return system


def live_from_state(texts: Sequence[bytes], embeddings: np.ndarray, *,
                    centroids: np.ndarray, assignment: np.ndarray,
                    n_clusters: int, a_seed: int,
                    doc_ids: Sequence[int] | None = None,
                    compact_every: int | None = None,
                    max_pad_fraction: float = 0.95, chunk_size: int = 256,
                    q_switch: int | None = 1 << 16, impl: str = "auto",
                    batch: dict | None = None,
                    device: str | torch.device | None = None,
                    mesh=None) -> LiveIndex:
    """A port `LiveIndex` over `system_from_state`'s system.

    Full rebuilds of the returned index run the port's own `build` on
    ``device`` (on ``mesh``, sharded) with the same chunk size, modulus
    switch and ``impl``.
    """
    system = system_from_state(
        texts, embeddings, centroids=centroids, assignment=assignment,
        n_clusters=n_clusters, a_seed=a_seed, chunk_size=chunk_size,
        q_switch=q_switch, impl=impl, doc_ids=doc_ids, batch=batch,
        device=device, mesh=mesh)
    return LiveIndex(system, texts, embeddings, doc_ids=doc_ids,
                     max_pad_fraction=max_pad_fraction,
                     compact_every=compact_every)


def tiptoe_from_state(embeddings: np.ndarray, *, centroids: np.ndarray,
                      assignment: np.ndarray, n_clusters: int,
                      levels: int = 15, seed: int = 0, impl: str = "auto",
                      device: str | torch.device | None = None
                      ) -> TiptoeSystem:
    """A `TiptoeSystem` on ``device`` from a finished clustering (e.g. the
    reference's ``sys.centroids`` and the assignment of its k-means);
    ``seed`` fixes the public matrix seed ``seed + 101`` as in `build`."""
    dev = resolve_device(device)
    return TiptoeSystem._from_parts(
        np.asarray(embeddings, np.float32), np.asarray(centroids, np.float32),
        np.asarray(assignment), n_clusters, levels=levels, seed=seed,
        impl=impl, device=dev, t0=time.perf_counter())


def graph_from_state(embeddings: np.ndarray, *, entry_points: np.ndarray,
                     degree: int = 12, n_random: int = 4, seed: int = 0,
                     sketch_bits: int = 64, impl: str = "auto",
                     device: str | torch.device | None = None
                     ) -> GraphPIRSystem:
    """A `GraphPIRSystem` on ``device`` with the given entry points (e.g.
    the reference's ``sys.entry_points``): graph, records and hint are
    built as in `build`, without its entry-point k-means."""
    dev = resolve_device(device)
    return GraphPIRSystem._from_parts(
        np.asarray(embeddings, np.float32), entry_points, degree=degree,
        n_random=n_random, seed=seed, sketch_bits=sketch_bits, impl=impl,
        device=dev, t0=time.perf_counter())


def lm_params_from_state(params_np, cfg: LMConfig,
                         device: str | torch.device | None = None):
    """The port's parameter tree on ``device`` from the reference's
    ``transformer.init`` tree as numpy arrays (``{"embed", "blocks",
    "final_norm"[, "head"]}``, every block leaf stacked over layers, e.g.
    ``blocks/sub0/attn/wq/w`` of shape (n_layers, d, H·hd)); equal bitwise.
    """
    dev = resolve_device(device)

    def leaf(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            dev, cfg.param_dtype)

    def tree(t, i=None):
        if isinstance(t, dict):
            return {k: tree(v, i) for k, v in t.items()}
        return leaf(t if i is None else np.asarray(t)[i])

    stacked = params_np["blocks"]["sub0"]
    out = {"embed": tree(params_np["embed"]),
           "layers": [tree(stacked, i) for i in range(cfg.n_layers)],
           "final_norm": tree(params_np["final_norm"])}
    if not cfg.tie_embeddings:
        out["head"] = tree(params_np["head"])
    return out


def generator_from_state(params_np, cfg: LMConfig, *,
                         spec: PromptSpec | None = None,
                         max_new_tokens: int = 16, temperature: float = 0.0,
                         seed: int = 0,
                         device: str | torch.device | None = None
                         ) -> Generator:
    """A `Generator` on ``device`` over the reference's weights
    (`lm_params_from_state`), e.g. a JAX ``Generator``'s ``params``."""
    dev = resolve_device(device)
    return Generator(lm_params_from_state(params_np, cfg, dev), cfg,
                     spec=spec, max_new_tokens=max_new_tokens,
                     temperature=temperature, seed=seed, device=dev)
