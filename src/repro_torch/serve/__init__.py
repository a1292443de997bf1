"""Serving for the port: the synchronous deadline-batched serve loop.

`engine` holds `PIRServeLoop` (a static system or a live index, mutations
committed between batches, stale-epoch requests rejected and retried) and
its batcher.  The pipelined engine and shadow commits come later.
"""
from repro_torch.serve.engine import (BatchTiming, DeadlineBatcher,
                                      PIRServeLoop, Request, Response)

__all__ = ["BatchTiming", "DeadlineBatcher", "PIRServeLoop", "Request",
           "Response"]
