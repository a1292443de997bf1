"""Carry a clustered corpus's state into the port.

`system_from_state` takes the numpy arrays that fix a build — centroids,
the doc→cluster assignment and the public seed ``a_seed`` — and packs and
hints on the port's side.  Given the JAX package's arrays (for example
``np.asarray(sys.centroids)``, ``sys.assignment``, ``sys.cfg.a_seed`` of a
``repro`` build), the port's DB bytes, hint and answers equal the
reference's bit for bit.  Nothing here imports JAX.
"""
from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from repro_torch._common import resolve_device
from repro_torch.core.pipeline import PirRagSystem


def system_from_state(texts: Sequence[bytes], embeddings: np.ndarray, *,
                      centroids: np.ndarray, assignment: np.ndarray,
                      n_clusters: int, a_seed: int, chunk_size: int = 256,
                      q_switch: int | None = 1 << 16, impl: str = "auto",
                      device: str | torch.device | None = None
                      ) -> PirRagSystem:
    """A `PirRagSystem` on ``device`` from a finished clustering."""
    dev = resolve_device(device)
    return PirRagSystem._from_parts(
        texts, np.asarray(embeddings, np.float32),
        np.asarray(centroids, np.float32), np.asarray(assignment),
        n_clusters, a_seed=int(a_seed), chunk_size=chunk_size,
        q_switch=q_switch, impl=impl, device=dev, t0=time.perf_counter())
