"""Bounded retry / timeout / backoff policy shared across the serving fleet.

A copy of ``repro/fleet/retry.py`` (numpy only).

Every retrying path in the system — the serve engines' stale-reject requeue,
fault-injected answer drops, failed staged commits, and the traffic generator's
reactive hint syncs — used to retry UNBOUNDEDLY: under heavy epoch churn a
request could ping-pong between the queue head and the stale-reject path
forever, and a lost answer was simply re-queued with no terminal outcome.
`RetryPolicy` is the one shared budget that closes those loops:

budget      ``max_retries`` bounds how many times a single request may be
            re-admitted.  Exhausting the budget produces a TERMINAL
            ``failed`` response (never silence), which `traffic.slo` folds
            into the run summary so served + shed + failed == offered.

deadline    ``deadline_ms`` (optional) fails a request at retry time once
            its age exceeds the deadline — retrying work that can no longer
            meet its SLO only steals capacity from requests that still can.

backoff     ``backoff_ms(rid, attempt)`` is deterministic exponential
            backoff with seeded jitter: base · factor^(attempt−1), capped,
            plus a jitter drawn from ``default_rng([seed, rid, attempt])``
            — a pure function of (policy, request, attempt), so retry
            schedules are bit-reproducible across runs and across the
            sync/pipelined engines.  The default base of 0 keeps the
            historical immediate-requeue behaviour (and its bit-identical
            response stream); fault-tolerant deployments raise it so a
            struggling shard is not hammered by synchronized retries.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Per-request retry budget + deadline + deterministic backoff.

    ``max_retries`` is the number of RE-admissions allowed (a request served
    on first admission has retries=0); ``backoff_base_ms=0`` (default)
    means immediate requeue — bit-identical to the pre-fleet engines.
    ``deadline_ms=None`` disables age-based failing.  ``seed`` keys the
    jitter stream; two policies with equal fields produce identical
    schedules.
    """
    max_retries: int = 32
    backoff_base_ms: float = 0.0
    backoff_factor: float = 2.0
    backoff_cap_ms: float = 1000.0
    jitter_frac: float = 0.1
    deadline_ms: float | None = None
    seed: int = 0

    def __post_init__(self):
        assert self.max_retries >= 0, self.max_retries
        assert self.backoff_base_ms >= 0 and self.backoff_cap_ms >= 0
        assert self.backoff_factor >= 1.0, self.backoff_factor
        assert 0.0 <= self.jitter_frac <= 1.0, self.jitter_frac

    def exhausted(self, retries: int) -> bool:
        """True once `retries` re-admissions have used up the budget."""
        return retries > self.max_retries

    def past_deadline(self, t_arrival: float, now: float) -> bool:
        """True when the request's age exceeds ``deadline_ms`` (if set)."""
        if self.deadline_ms is None:
            return False
        return (now - t_arrival) * 1e3 > self.deadline_ms

    def backoff_ms(self, rid: int, attempt: int) -> float:
        """Deterministic backoff before re-admission number `attempt` (≥1).

        base · factor^(attempt−1), capped at ``backoff_cap_ms``, plus a
        seeded jitter in [0, jitter_frac·delay) drawn from
        ``default_rng([seed, rid, attempt])`` — reproducible per
        (policy, request, attempt) with no shared RNG state, so concurrent
        retries desynchronize without breaking determinism.
        """
        if self.backoff_base_ms <= 0:
            return 0.0
        delay = min(self.backoff_base_ms * self.backoff_factor ** (attempt - 1),
                    self.backoff_cap_ms)
        if self.jitter_frac > 0:
            u = float(np.random.default_rng(
                [self.seed, int(rid) & 0x7FFFFFFF, attempt]).random())
            delay += delay * self.jitter_frac * u
        return delay

    def backoff_s(self, rid: int, attempt: int) -> float:
        """`backoff_ms` in seconds (the serve-loop clock unit)."""
        return self.backoff_ms(rid, attempt) * 1e-3


#: The engines' default: generous budget, zero backoff — behaviourally
#: identical to the historical unbounded requeue for every workload whose
#: requests see fewer than 32 epoch bumps while queued, but with a hard
#: floor under pathological churn.
DEFAULT_POLICY = RetryPolicy()
