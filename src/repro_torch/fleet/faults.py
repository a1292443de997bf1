"""Deterministic fault injection for serving (a copy of
``repro/fleet/faults.py``, numpy only).

A `FaultPlan` is a SEEDED, fully enumerated schedule of fault events, each
bound to a named SITE — a guarded point in the serving stack — and an
invocation index at that site.  The `FaultInjector` compiled from a plan
counts site invocations and fires the matching events; with an empty plan
every guard is a counter increment, so the no-fault path makes exactly the
same clock reads and dispatches as an uninjected run.

Sites:

``collectives.row_shard.loss``
    A device leaves the replica placement for a window.  Named here so a
    plan drawn by `FaultPlan.random` matches the JAX package's event for
    event; nothing in the port guards it until the mesh is ported.
``serve.answer.drop``  (`serve.engine` tick, after admission)
    The cut batch's answer is lost before dispatch: every request in it is
    charged one retry and re-queued with backoff (or terminally failed).
``serve.answer.delay``  (`serve.engine` tick, after admission)
    The cut batch is held for ``delay_s`` of loop-clock time before it can
    be dispatched again (no retry charged: late, not lost).
``update.commit.stage``  (`update.live.LiveIndex.stage`)
    The staged commit raises `InjectedCommitFault`; the engines leave the
    journal's pending batch intact and retry the commit on a later tick.
``update.hint.chain``  (`update.epochs.EpochLog.download_chain`)
    One patch of a downloaded chain is bit-flipped in transit; the client
    detects the checksum mismatch and performs one full re-sync.

Every event is identified by (site, nth invocation), so a plan is exact
under a fake clock and under the real one alike.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: Canonical site names (mirrored as literals at each guarded call site).
SITE_SHARD_LOSS = "collectives.row_shard.loss"
SITE_ANSWER_DROP = "serve.answer.drop"
SITE_ANSWER_DELAY = "serve.answer.delay"
SITE_COMMIT_FAIL = "update.commit.stage"
SITE_CHAIN_CORRUPT = "update.hint.chain"

ALL_SITES = (SITE_SHARD_LOSS, SITE_ANSWER_DROP, SITE_ANSWER_DELAY,
             SITE_COMMIT_FAIL, SITE_CHAIN_CORRUPT)


class InjectedCommitFault(RuntimeError):
    """A staged commit failed by injection; the mutation batch is retryable."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: fire at the `at`-th invocation of `site` (0-based).

    Payload fields are site-specific: ``device``/``down_ticks`` for shard
    loss, ``delay_s`` for answer delays; the rest ignore them.
    """
    site: str
    at: int
    device: int = 0
    down_ticks: int = 0
    delay_s: float = 0.0

    def __post_init__(self):
        if self.site not in ALL_SITES:
            raise ValueError(f"unknown fault site {self.site!r}")
        if self.at < 0 or self.down_ticks < 0 or self.delay_s < 0.0:
            raise ValueError(f"negative field in {self!r}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, enumerable fault schedule (empty = no faults)."""
    events: tuple[FaultEvent, ...] = ()

    @classmethod
    def none(cls) -> "FaultPlan":
        """The empty plan: every guard is a counter increment."""
        return cls(())

    @classmethod
    def single_shard_loss(cls, *, at_tick: int, device: int,
                          down_ticks: int) -> "FaultPlan":
        """One device lost for a window."""
        return cls((FaultEvent(SITE_SHARD_LOSS, at=at_tick, device=device,
                               down_ticks=down_ticks),))

    @classmethod
    def random(cls, seed: int, *, n_events: int, horizon: int,
               n_devices: int, max_down_ticks: int = 12,
               max_delay_s: float = 0.02,
               sites: tuple[str, ...] = ALL_SITES) -> "FaultPlan":
        """A seeded random plan: `n_events` faults over `horizon` invocations.

        Draws from ``np.random.default_rng([seed, 0xFA])`` in the JAX
        package's order, so a seed gives the same events there and here.
        """
        rng = np.random.default_rng([seed, 0xFA])
        events = []
        for _ in range(n_events):
            site = sites[int(rng.integers(len(sites)))]
            events.append(FaultEvent(
                site, at=int(rng.integers(horizon)),
                device=int(rng.integers(n_devices)),
                down_ticks=int(rng.integers(1, max_down_ticks + 1)),
                delay_s=float(rng.uniform(0.0, max_delay_s))))
        return cls(tuple(events))

    def compile(self) -> "FaultInjector":
        """An injector with fresh invocation counters for this plan."""
        return FaultInjector(self)


class FaultInjector:
    """Counts site invocations and fires the plan's matching events.

    One injector per run: counters are mutable state, so two runs that
    should see identical faults must each `compile()` the plan afresh.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._count: dict[str, int] = {}
        self._by_site: dict[str, dict[int, list[FaultEvent]]] = {}
        for ev in plan.events:
            self._by_site.setdefault(ev.site, {}).setdefault(
                ev.at, []).append(ev)
        self.fired: list[FaultEvent] = []

    def fire(self, site: str) -> list[FaultEvent]:
        """Advance `site`'s invocation counter; return the events due now."""
        n = self._count.get(site, 0)
        self._count[site] = n + 1
        due = self._by_site.get(site, {}).get(n, [])
        if due:
            self.fired.extend(due)
        return due

    def invocations(self, site: str) -> int:
        """How many times `site` has been guarded so far this run."""
        return self._count.get(site, 0)
