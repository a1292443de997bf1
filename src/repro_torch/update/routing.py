"""Cluster → bucket routing of live-index deltas (twin of
``repro/update/routing.py``, without batch-PIR).

With batch-PIR enabled the JAX package routes every committed column swap
into the cuckoo buckets that hold a replica of it.  The port has no
batch-PIR yet, so only the path where it is off exists here: there is
nothing to route.
"""
from __future__ import annotations

import numpy as np


def stage_batch_hints(system, cols: np.ndarray, new_cols: np.ndarray,
                      new_used: dict[int, int], *, donate: bool = False):
    """The staged bucket patches of one commit: None while batch-PIR is off.

    Raises for a system that carries batch-PIR state, which the port
    cannot route yet.
    """
    del cols, new_cols, new_used, donate
    if getattr(system, "batch", None) is None:
        return None
    raise NotImplementedError("batch-PIR bucket routing is not ported yet")
