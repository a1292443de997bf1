"""Live-index subsystem: streaming corpus mutations over a PirRagSystem
(twin of ``repro/update``).

The hint ``H = D·A`` is linear in the database, so a mutation batch touching
clusters J yields an exact sparse patch ``ΔH = ΔD[:,J]·A[J,:]`` — the
delta-hint kernel instead of a full offline rebuild, and a small versioned
download (`HintPatch`) instead of a fresh m×k hint.

    journal.py — append-only mutation log (insert/delete/replace)
    planner.py — mutations → touched clusters + full-rebuild triggers
    epochs.py  — versioned HintPatch wire format, composition, compaction
                 (EpochLog segments), client HintCache
    routing.py — bucket routing of deltas into the batch-PIR sub-DBs and
                 bucket hints (a no-op while batch PIR is off)
    live.py    — LiveIndex: plan → column rebuild → ΔH → epoch publish
"""
from repro_torch.update.epochs import (CorruptPatchError, EpochLog, HintCache,
                                       HintPatch, StaleEpochError,
                                       compact_chain, compose_patches)
from repro_torch.update.journal import Mutation, MutationJournal, replay
from repro_torch.update.live import LiveIndex
from repro_torch.update.planner import UpdatePlan, nearest_centroid, plan_updates

__all__ = [
    "CorruptPatchError", "EpochLog", "HintCache", "HintPatch",
    "StaleEpochError", "compact_chain", "compose_patches",
    "Mutation", "MutationJournal", "replay", "LiveIndex", "UpdatePlan",
    "nearest_centroid", "plan_updates",
]
