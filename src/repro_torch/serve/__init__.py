"""Serving for the port: the synchronous and pipelined serve engines.

`engine` holds `PIRServeLoop` (a static system or a live index, mutations
committed between batches, stale-epoch requests rejected and retried) and
`PipelinedServeLoop` (plan, dispatch and complete overlapped across
batches); `epochs` holds `ShadowCommitter`, the stage/publish commits of
the pipelined engine.
"""
from repro_torch.serve.engine import (BatchTiming, DeadlineBatcher,
                                      PIRServeLoop, PipelinedServeLoop,
                                      Request, Response)
from repro_torch.serve.epochs import ShadowCommitter

__all__ = ["BatchTiming", "DeadlineBatcher", "PIRServeLoop",
           "PipelinedServeLoop", "Request", "Response", "ShadowCommitter"]
