"""The injected commit failure (from ``repro/fleet/faults.py``).

`LiveIndex.stage` raises `InjectedCommitFault` when a fault injector armed
on it fires at the ``update.commit.stage`` site; the serve loop catches it,
leaves the pending mutation batch in the journal and retries the commit on
a later tick.  The injector itself is not ported yet.
"""
from __future__ import annotations

#: The guarded site in `LiveIndex.stage`.
SITE_COMMIT_FAIL = "update.commit.stage"
#: The guarded site in `EpochLog.download_chain`.
SITE_CHAIN_CORRUPT = "update.hint.chain"


class InjectedCommitFault(RuntimeError):
    """A staged commit failed by injection; the mutation batch is retryable."""
