"""PIR serve engines: deadline batching, epoch admission, pipelining
(twin of ``repro/serve/engine.py``).

Two engines share one policy core (batching, epoch admission, bounded
retries, answer-fault injection, the per-batch LWE stream):

`PIRServeLoop` — the synchronous loop.  Each tick commits pending
mutations, cuts a batch, queues its encryption, answer and decode on the
device, waits for them and re-ranks on the host before returning.

`PipelinedServeLoop` — plan, dispatch and complete overlap across batches:

    tick T:   shadow commit (stage, then publish: `serve.epochs`)
              plan batch N      (cut, admit, encode)          host
              dispatch batch N  (answer + decode enqueued)    device
              complete batch N-depth (copy back, re-rank)     host

While batch N's products run on the device, the host parses and re-ranks
batch N−depth.  Each in-flight batch is waited for on its own CUDA event,
recorded where its dispatch ends, never on the whole stream.

Responses, epochs and retry counts are the same in both engines: pipelining
moves work in time, never across an epoch boundary.  Requests formed
against a superseded epoch are rejected and re-queued under a bounded retry
budget.  Spans time every stage and `BatchTiming` is built from their
boundaries, so the Chrome-trace export under a fake clock is byte-identical
to the JAX package's engines.

The per-batch LWE randomness comes from one `torch.Generator` seeded from
``seed`` (the JAX engines split a threefry key per batch); decryption is
exact, so responses do not depend on it.  A tick serves one answer product
per request kind: single-probe queries share the column-stacked GEMM, each
multi_probe value shares one bucketed batch-PIR pass, and keyed lookups
share the keyed bucketed pass.  The generation stage is not ported yet.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from collections import deque
from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch.fleet.faults import (SITE_ANSWER_DELAY, SITE_ANSWER_DROP,
                                      InjectedCommitFault)
from repro_torch.fleet.retry import DEFAULT_POLICY, RetryPolicy
from repro_torch.obs import Obs
from repro_torch.serve.epochs import ShadowCommitter


@dataclasses.dataclass
class Request:
    rid: int
    query_emb: np.ndarray | None   # None for keyed embedding lookups
    t_arrival: float
    epoch: int = 0                 # hint epoch the query was formed against
    retries: int = 0
    top_k: int = 5                 # per-request result size
    multi_probe: int = 1           # clusters to fetch (>1: batch-PIR able)
    lookup_ids: tuple | None = None  # keyed row ids (embedding lookup)


@dataclasses.dataclass(frozen=True)
class BatchTiming:
    """Per-batch latency components, shared by every response in the batch.

    ``t_plan`` is when the batch's encode began — a request's queue time is
    ``t_plan − t_arrival``.  ``encode_s`` is host-side query formulation +
    device enqueue; ``gemm_s`` the wait for the device results; ``decode_s``
    host-side parse + re-rank.
    """
    t_plan: float
    encode_s: float
    gemm_s: float
    decode_s: float


@dataclasses.dataclass
class Response:
    rid: int
    top: list
    t_done: float
    batch_size: int
    epoch: int = 0
    retries: int = 0
    t_arrival: float = 0.0               # copied from the request
    timing: BatchTiming | None = None    # its batch's latency components
    failed: bool = False                 # terminal: retry budget/deadline hit


class DeadlineBatcher:
    """Cut a batch at max_batch or when the head request ages past deadline."""

    def __init__(self, *, max_batch: int = 64, deadline_ms: float = 20.0):
        self.max_batch = max_batch
        self.deadline_ms = deadline_ms
        self.queue: deque[Request] = deque()

    @property
    def depth(self) -> int:
        """Requests currently queued."""
        return len(self.queue)

    def submit(self, req: Request):
        """Append an arriving request (FIFO tail)."""
        self.queue.append(req)

    def requeue(self, req: Request):
        """Put ONE rejected request back at the head (it keeps its arrival)."""
        self.queue.appendleft(req)

    def requeue_front(self, reqs: Iterable[Request]):
        """Put rejected requests back at the head, preserving THEIR order."""
        self.queue.extendleft(reversed(list(reqs)))

    def ready(self, now: float) -> bool:
        """True when a batch should be cut: size or head-age trigger."""
        if not self.queue:
            return False
        if len(self.queue) >= self.max_batch:
            return True
        age_ms = (now - self.queue[0].t_arrival) * 1e3
        return age_ms >= self.deadline_ms

    def cut(self) -> list[Request]:
        """Dequeue up to max_batch requests in arrival order."""
        batch = []
        while self.queue and len(batch) < self.max_batch:
            batch.append(self.queue.popleft())
        return batch


def _wait(pending) -> None:
    """Block until the device work that produced ``pending`` is done: a
    wait on each tensor's current stream (nothing to wait for on the CPU)."""
    for t in pending:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()


class PIRServeLoop:
    """Synchronous deadline-batched serving; optionally wraps a LiveIndex.

    `system` may be a PirRagSystem (static corpus) or, with `live=...` (or
    a LiveIndex passed as `system`), the live index whose `.system` is
    queried at its current epoch.
    """

    #: span attribute naming this engine (registered enum in obs.scrub)
    ENGINE = "sync"

    def __init__(self, system, *, max_batch: int = 64,
                 deadline_ms: float = 20.0,
                 clock: Callable[[], float] = time.perf_counter,
                 live=None, seed: int = 0, obs: Obs | None = None,
                 retry: RetryPolicy | None = DEFAULT_POLICY,
                 faults=None):
        self.live = live if live is not None else (
            system if hasattr(system, "epochs") else None)
        self.system = system if self.live is None else self.live.system
        self.batcher = DeadlineBatcher(max_batch=max_batch,
                                       deadline_ms=deadline_ms)
        self.clock = clock
        # Spans time every tick stage (BatchTiming is built from their
        # boundaries); Obs(trace=False) keeps the timeline without
        # retaining spans.  Pass Obs(trace=True, clock=<same clock>) to
        # export traces.
        self.obs = obs if obs is not None else Obs(clock=clock, trace=False)
        if self.live is not None:
            self.live.set_obs(self.obs)
        self.responses: list[Response] = []
        self.mutations: deque = deque()
        self.stale_retries = 0
        # Bounded retry: every re-admission charges the request's budget;
        # exhaustion or a blown deadline yields a TERMINAL failed response.
        # retry=None restores unbounded requeueing.
        self.retry = retry
        self.failed_requests = 0
        # Fault injection (`fleet.faults.FaultInjector`): guards the answer
        # drop and delay sites after admission, and arms the wrapped live
        # index's commit-stage and hint-chain sites with the SAME injector
        # (one invocation-counter space per run).  None keeps the tick
        # fault-free with no extra clock reads.
        self.faults = faults
        if faults is not None and self.live is not None:
            self.live.faults = faults
            self.live.epochs.faults = faults
        self._backoff: list = []      # (ready_t, seq, Request) min-heap
        self._delayed: list = []      # (ready_t, seq, Request) min-heap
        self._seq = 0                 # heap tiebreak = admission order
        self._tick_no = 0
        # Commit-failure retry state: an injected stage failure leaves the
        # journal batch pending; the commit is retried under tick backoff.
        self._commit_retry = False
        self._commit_attempts = 0
        self._commit_not_before = 0
        self.seed = seed
        self._gen: torch.Generator | None = None   # per-batch LWE stream

    @property
    def epoch(self) -> int:
        """Published epoch requests are admitted at (0 for static corpora)."""
        return self.live.epoch if self.live is not None else 0

    def submit(self, rid: int, query_emb: np.ndarray, *, top_k: int = 5,
               multi_probe: int = 1, epoch: int | None = None):
        """A client submits a query formed against its cached hint's epoch.

        ``epoch=None`` (the default) models a freshly synced client and
        stamps the published head.
        """
        self.batcher.submit(Request(rid, query_emb, self.clock(),
                                    epoch=self.epoch if epoch is None
                                    else epoch, top_k=top_k,
                                    multi_probe=multi_probe))

    def submit_lookup(self, rid: int, ids, *, epoch: int | None = None):
        """A client submits a keyed embedding lookup (row id multiset).

        Lookups batch through the same deadline and admission policy as
        queries; each tick serves all its lookups in ONE bucketed pass of
        the keyed batch-PIR subsystem.  Needs a `build_keyed` system.
        """
        self.batcher.submit(Request(rid, None, self.clock(),
                                    epoch=self.epoch if epoch is None
                                    else epoch,
                                    lookup_ids=tuple(int(i) for i in ids)))

    def submit_mutation(self, mut):
        """Queue a journal record; folded into an epoch at the next tick."""
        if self.live is None:
            raise ValueError("mutations need a LiveIndex")
        self.mutations.append(mut)

    def _commit_mutations(self):
        """Fold queued mutations into one epoch between query batches."""
        if self.live is None or not (self.mutations or self._commit_retry):
            return None
        if self._tick_no < self._commit_not_before:
            return None                  # backing off after a failed commit
        while self.mutations:
            self.live.journal.append(self.mutations.popleft())
        try:
            patch = self.live.commit()
        except InjectedCommitFault:
            self._commit_failed()
            return None
        self._commit_retry = False
        self._commit_attempts = 0
        return patch

    def _commit_failed(self):
        """Record one failed commit attempt and arm the tick backoff."""
        self._commit_attempts += 1
        self._commit_retry = True
        self._commit_not_before = (self._tick_no
                                   + min(2 ** (self._commit_attempts - 1), 16))
        self.obs.counter("fleet.commit_failures").inc()

    # -- admission -------------------------------------------------------------

    def _admit(self, batch: list[Request], cur: int,
               now: float) -> list[Request]:
        """Epoch admission control: reject-and-requeue stale requests.

        A query encrypted against a superseded hint would decode garbage,
        so it is rejected; the client syncs its cached hint and re-encrypts
        against the head.  Retried requests go back to the queue head in
        their original order — after their backoff, if the policy sets one
        — unless the retry charge exhausts their budget or deadline, which
        ends them with a terminal failed response.
        """
        fresh = [r for r in batch if r.epoch == cur]
        stale = [r for r in batch if r.epoch != cur]
        if stale:
            self.stale_retries += len(stale)
            self.obs.counter("serve.stale_retries").inc(len(stale))
            for r in stale:
                r.retries += 1
            kept, give_up = self._split_budget(stale, now)
            for r in kept:
                r.epoch = cur
            self._requeue_retries(kept, now)
            self._fail(give_up, cur, now)
        return fresh

    def _split_budget(self, reqs: list[Request],
                      now: float) -> tuple[list[Request], list[Request]]:
        """(still in budget, out of budget) under the retry policy."""
        if self.retry is None:
            return reqs, []
        kept, give_up = [], []
        for r in reqs:
            if (self.retry.exhausted(r.retries)
                    or self.retry.past_deadline(r.t_arrival, now)):
                give_up.append(r)
            else:
                kept.append(r)
        return kept, give_up

    def _requeue_retries(self, reqs: list[Request], now: float):
        """Requeue retried requests, honouring the policy's backoff."""
        if not reqs:
            return
        if self.retry is None or self.retry.backoff_base_ms <= 0:
            self.batcher.requeue_front(reqs)
            return
        immediate = []
        for r in reqs:
            d = self.retry.backoff_s(r.rid, r.retries)
            if d <= 0:
                immediate.append(r)
            else:
                self._seq += 1
                heapq.heappush(self._backoff, (now + d, self._seq, r))
        if immediate:
            self.batcher.requeue_front(immediate)

    def _fail(self, reqs: list[Request], epoch: int, now: float):
        """Terminal failure: emit failed responses (never silence)."""
        if not reqs:
            return
        self.failed_requests += len(reqs)
        self.obs.counter("serve.failed").inc(len(reqs))
        hist = self.obs.histogram("serve.retries",
                                  bounds=(1, 2, 4, 8, 16, 32, 64))
        for r in reqs:
            hist.record(r.retries)
            self.responses.append(Response(
                r.rid, [], now, 0, epoch=epoch, retries=r.retries,
                t_arrival=r.t_arrival, failed=True))

    def _release_held(self, now: float):
        """Move matured backoff and delayed requests back to the queue head.

        Heap pops against the tick's existing ``now`` read: with empty heaps
        this is two truthiness checks, so the response stream stays the
        same.  Maturity is respected during drain too (the clock advances
        there, so held requests always mature).
        """
        due = []
        for heap in (self._delayed, self._backoff):
            while heap and heap[0][0] <= now:
                due.append(heapq.heappop(heap))
        if due:
            due.sort(key=lambda e: e[1])   # original admission order
            self.batcher.requeue_front([r for _, _, r in due])

    def _inject_answer_faults(self, fresh: list[Request], cur: int,
                              now: float) -> list[Request]:
        """Guard the answer drop and delay sites on the just-cut batch.

        A DROP loses the whole batch before dispatch: each request is
        charged one retry and re-queued (or terminally failed).  A DELAY
        holds the batch in the delayed heap for the event's ``delay_s`` of
        loop-clock time: late, not lost, so no retry is charged.
        """
        if self.faults is None or not fresh:
            return fresh
        if self.faults.fire(SITE_ANSWER_DROP):
            self.obs.counter("fleet.answer_drops").inc(len(fresh))
            for r in fresh:
                r.retries += 1
            kept, give_up = self._split_budget(fresh, now)
            self._requeue_retries(kept, now)
            self._fail(give_up, cur, now)
            return []
        delay = self.faults.fire(SITE_ANSWER_DELAY)
        if delay:
            self.obs.counter("fleet.answer_delays").inc(len(fresh))
            ready = now + max(ev.delay_s for ev in delay)
            for r in fresh:
                self._seq += 1
                heapq.heappush(self._delayed, (ready, self._seq, r))
            return []
        return fresh

    def _probe_groups(self, fresh: list[Request]
                      ) -> list[tuple[tuple[str, int], list[Request]]]:
        """One answer product per request kind and shape: single-probe
        queries share the column-stacked GEMM, each distinct multi_probe
        value one bucketed batch-PIR pass, keyed lookups the keyed bucketed
        pass.  Keys are ("lookup", 0) or ("query", multi_probe), sorted, so
        the group order is deterministic."""
        groups: dict[tuple[str, int], list[Request]] = {}
        for r in fresh:
            k = (("lookup", 0) if r.lookup_ids is not None
                 else ("query", r.multi_probe))
            groups.setdefault(k, []).append(r)
        return [(k, groups[k]) for k in sorted(groups)]

    def _plan_group(self, system, kind: tuple[str, int],
                    reqs: list[Request], gen: torch.Generator):
        """Encode + dispatch one request group → its `InflightBatch`:
        lookups through `lookup_batch_async` (results are (κ, d) row
        arrays), queries through `query_batch_async` (top-k doc lists)."""
        if kind[0] == "lookup":
            return system.lookup_batch_async([r.lookup_ids for r in reqs],
                                             generator=gen)
        embs = np.stack([r.query_emb for r in reqs])
        return system.query_batch_async(embs, top_k=[r.top_k for r in reqs],
                                        multi_probe=kind[1], generator=gen)

    def _serving_system(self):
        return self.live.system if self.live is not None else self.system

    def _generator(self, device: torch.device) -> torch.Generator:
        if self._gen is None or self._gen.device != device:
            self._gen = torch.Generator(device=device)
            self._gen.manual_seed(self.seed)
        return self._gen

    # -- the synchronous tick -------------------------------------------------

    def tick(self, force: bool = False) -> int:
        """Serve one batch if ready; returns number of requests served.

        force=True flushes a partial batch regardless of the deadline
        (used by drain) WITHOUT touching the configured deadline_ms.

        The tick is one root span; plan (encode + enqueue) / gemm (device
        wait) / complete (parse + re-rank) are nested spans whose
        boundaries ARE the `BatchTiming` components.
        """
        self._tick_no += 1
        with self.obs.span("serve.tick", engine=self.ENGINE) as tick_sp:
            self.obs.gauge("serve.queue_depth").set(self.batcher.depth)
            self._commit_mutations()
            now = self.clock()
            self._release_held(now)
            if (not self.batcher.ready(now)
                    and not (force and self.batcher.queue)):
                return 0
            cur = self.epoch
            fresh = self._admit(self.batcher.cut(), cur, now)
            fresh = self._inject_answer_faults(fresh, cur, now)
            if not fresh:
                return 0
            tick_sp.set(batch=len(fresh), epoch=cur)

            system = self._serving_system()
            gen = self._generator(system.device)
            for kind, reqs in self._probe_groups(fresh):
                with self.obs.span("serve.plan", batch=len(reqs),
                                   kind=kind[0],
                                   multi_probe=kind[1]) as sp_plan:
                    infl = self._plan_group(system, kind, reqs, gen)
                with self.obs.span("serve.gemm", batch=len(reqs)) as sp_gemm:
                    _wait(infl.pending)
                with self.obs.span("serve.complete",
                                   batch=len(reqs)) as sp_done:
                    results = infl.complete()
                self._append(reqs, results, cur, sp_done.t1, BatchTiming(
                    t_plan=sp_plan.t0, encode_s=sp_plan.dur,
                    gemm_s=sp_gemm.dur, decode_s=sp_done.dur))
            return len(fresh)

    def _append(self, reqs: list[Request], results: list, epoch: int,
                t_done: float, timing: BatchTiming):
        """Append one served group's responses (shared batch timing)."""
        self.obs.counter("serve.responses").inc(len(reqs))
        self.obs.histogram("serve.batch_size",
                           bounds=(1, 2, 4, 8, 16, 32, 64, 128)
                           ).record(len(reqs))
        lat_hist = self.obs.histogram("serve.latency_ms")
        retry_hist = self.obs.histogram("serve.retries",
                                        bounds=(1, 2, 4, 8, 16, 32, 64))
        for req, top in zip(reqs, results):
            lat_hist.record((t_done - req.t_arrival) * 1e3)
            retry_hist.record(req.retries)
            # batch_size = this group's GEMM width, not the tick total
            self.responses.append(Response(
                req.rid, top, t_done, len(reqs), epoch=epoch,
                retries=req.retries, t_arrival=req.t_arrival, timing=timing))

    def _pending_work(self) -> bool:
        return bool(self.batcher.queue or self.mutations or self._backoff
                    or self._delayed or self._commit_retry)

    def drain(self):
        """Serve everything still queued, force-flushing partial batches."""
        while self._pending_work():
            self.tick(force=True)


class PipelinedServeLoop(PIRServeLoop):
    """Plan/dispatch/complete pipelined serving over the same policy core.

    ``depth`` bounds the number of dispatched-but-undecoded batches: the
    tick that dispatches batch N completes batch N−depth, so the device has
    products queued while the host parses and re-ranks an older batch.

    Mutation commits go through `ShadowCommitter`: patches are staged into
    fresh buffers (DB and sub-DB columns written in place at publish) and
    published at the same tick boundary the
    synchronous loop commits on, which is why responses, epochs and retry
    counts stay the same.
    """

    ENGINE = "pipelined"

    def __init__(self, system, *, depth: int = 2, **kwargs):
        super().__init__(system, **kwargs)
        self.depth = max(1, int(depth))
        self._inflight: deque = deque()
        self._shadow = (ShadowCommitter(self.live)
                        if self.live is not None else None)

    @property
    def inflight(self) -> int:
        """Batches dispatched on the device but not yet completed."""
        return len(self._inflight)

    def set_depth(self, depth: int):
        """Adjust the in-flight bound; a shrink retires the excess at the
        next tick, a grow lets more dispatches accumulate."""
        self.depth = max(1, int(depth))

    def _commit_mutations(self):
        if self._shadow is None or not (self.mutations or self._commit_retry):
            return None
        if self._tick_no < self._commit_not_before:
            return None                  # backing off after a failed commit
        try:
            patch = self._shadow.commit(self.mutations)
        except InjectedCommitFault:
            self._commit_failed()
            return None
        self._commit_retry = False
        self._commit_attempts = 0
        return patch

    def tick(self, force: bool = False) -> int:
        """Plan + dispatch one batch if ready; complete anything past depth.

        Returns the number of requests DISPATCHED (their responses land
        when the pipeline retires them).  The plan span's boundaries seed
        each in-flight batch's `BatchTiming`; its gemm and complete spans
        are opened by the later tick that retires it, so a complete span is
        parented by a younger tick than its plan span.
        """
        self._tick_no += 1
        with self.obs.span("serve.tick", engine=self.ENGINE) as tick_sp:
            self.obs.gauge("serve.queue_depth").set(self.batcher.depth)
            self._commit_mutations()
            now = self.clock()
            self._release_held(now)
            if (not self.batcher.ready(now)
                    and not (force and self.batcher.queue)):
                # idle tick: nothing to dispatch, so retire everything in
                # flight — responses must not wait behind the depth bound
                self._retire(0)
                return 0
            cur = self.epoch
            fresh = self._admit(self.batcher.cut(), cur, now)
            fresh = self._inject_answer_faults(fresh, cur, now)
            if not fresh:
                return 0
            tick_sp.set(batch=len(fresh), epoch=cur)

            system = self._serving_system()
            gen = self._generator(system.device)
            for kind, reqs in self._probe_groups(fresh):
                with self.obs.span("serve.plan", batch=len(reqs),
                                   kind=kind[0],
                                   multi_probe=kind[1]) as sp_plan:
                    infl = self._plan_group(system, kind, reqs, gen)
                self._inflight.append((reqs, cur, infl, sp_plan.t0,
                                       sp_plan.dur))
            self.obs.gauge("serve.inflight").set(len(self._inflight))
            self._retire(self.depth)
            return len(fresh)

    def _retire(self, limit: int):
        """Complete the oldest in-flight batches beyond ``limit``.

        The gemm component is the RESIDUAL device wait at retire time, on
        the batch's own event: at steady state its products ran while the
        host worked on other batches, so a small gemm_s is the pipeline
        doing its job (the sync engine reports the full device time).
        """
        while len(self._inflight) > limit:
            reqs, epoch, infl, t_plan, encode_s = self._inflight.popleft()
            with self.obs.span("serve.gemm", batch=len(reqs)) as sp_gemm:
                infl.wait()
            with self.obs.span("serve.complete", batch=len(reqs)) as sp_done:
                results = infl.complete()
            self._append(reqs, results, epoch, sp_done.t1, BatchTiming(
                t_plan=t_plan, encode_s=encode_s, gemm_s=sp_gemm.dur,
                decode_s=sp_done.dur))

    def drain(self):
        """Serve and complete everything: queue, mutations and pipeline."""
        while self._pending_work():
            self.tick(force=True)
        with self.obs.span("serve.drain", engine=self.ENGINE):
            self._retire(0)
