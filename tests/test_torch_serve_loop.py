"""The port's synchronous serve loop against the JAX package's.

Batcher twins of the reference's tests, then both loops on one schedule
under a fake clock — over a converted static system, and over a converted
live index that takes a mutation batch every few submits.  They must serve
the same (rid, epoch, top-k ids) set with the same retry and failure counts,
account for every offered request, and export the same Chrome trace.  The
LWE randomness differs by design (a torch.Generator against a threefry key
stream); decryption is exact, so responses do not.
"""
import numpy as np
import pytest

from repro.core import pipeline as jpipeline
from repro.data import corpus as jcorpus
from repro.obs import Obs as JObs
from repro.serve.engine import PIRServeLoop as JLoop
from repro.update import LiveIndex as JLiveIndex
from repro.update import journal as jjournal
from repro_torch import convert
from repro_torch.fleet.retry import RetryPolicy
from repro_torch.obs import Obs
from repro_torch.serve import DeadlineBatcher, PIRServeLoop, Request
from repro_torch.update import journal


class FakeClock:
    """Monotone virtual clock advancing a fixed step per reading."""

    def __init__(self, step: float = 1e-4):
        self.t = 0.0
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


# ---------------------------------------------------------------------------
# batcher (twins of the reference's)
# ---------------------------------------------------------------------------

def test_batcher_cuts_at_max_batch():
    b = DeadlineBatcher(max_batch=4, deadline_ms=1e9)
    for i in range(5):
        b.submit(Request(i, np.zeros(2), t_arrival=0.0))
    assert b.ready(now=0.0)
    assert [r.rid for r in b.cut()] == [0, 1, 2, 3]
    assert len(b.queue) == 1


def test_batcher_cuts_on_deadline():
    b = DeadlineBatcher(max_batch=100, deadline_ms=20.0)
    b.submit(Request(0, np.zeros(2), t_arrival=1.000))
    assert not b.ready(now=1.010)
    assert b.ready(now=1.025)


def test_batcher_empty_never_ready():
    b = DeadlineBatcher()
    assert not b.ready(now=123.0)


def test_requeue_front_preserves_fifo_among_retries():
    b = DeadlineBatcher(max_batch=8, deadline_ms=1e9)
    for i in range(3):
        b.submit(Request(100 + i, np.zeros(2), t_arrival=0.0))
    b.requeue_front([Request(i, np.zeros(2), t_arrival=0.0)
                     for i in range(4)])
    assert [r.rid for r in b.cut()] == [0, 1, 2, 3, 100, 101, 102]
    b.submit(Request(200, np.zeros(2), t_arrival=0.0))
    b.requeue(Request(7, np.zeros(2), t_arrival=0.0))
    assert [r.rid for r in b.cut()] == [7, 200]


# ---------------------------------------------------------------------------
# the loop, against the reference's, on one schedule
# ---------------------------------------------------------------------------

N_CLUSTERS = 6


@pytest.fixture(scope="module")
def corp():
    return jcorpus.make_corpus(3, 160, emb_dim=16, n_topics=N_CLUSTERS)


def _anchors(corp, n):
    rng = np.random.default_rng(8)
    idx = rng.choice(len(corp.texts), n, replace=False)
    q = corp.embeddings[idx] + 0.02 * rng.standard_normal((n, corp.d))
    return idx, q.astype(np.float32)


def _mutation_batches(corp, n_batches):
    """Seeded (kind, doc id, text, emb) batches: replaces, inserts and a
    delete, never of an anchor's doc."""
    rng = np.random.default_rng(21)
    out = []
    for b in range(n_batches):
        batch = [("replace", int(100 + 3 * b), f"rev {b}".encode(),
                  rng.standard_normal(corp.d).astype(np.float32)),
                 ("insert", 5000 + b, f"new {b}".encode(),
                  corp.embeddings[b] + 0.01)]
        if b % 2:
            batch.append(("delete", int(140 + b), None, None))
        out.append(batch)
    return out


def _as_mutation(mod, kind, doc_id, text, emb):
    return (mod.delete(doc_id) if kind == "delete"
            else getattr(mod, kind)(doc_id, text, emb))


def _drive(loop, mod, queries, batches, every):
    """Submit each query and tick; queue a mutation batch every ``every``
    submits; drain.  Returns the offered count."""
    it = iter(batches)
    for rid, q in enumerate(queries):
        loop.submit(rid, q, top_k=5)
        if loop.live is not None and rid % every == every - 1:
            for mut in next(it, []):
                loop.submit_mutation(_as_mutation(mod, *mut))
        loop.tick()
    loop.drain()
    return len(queries)


def _served(loop):
    return sorted((r.rid, r.epoch, tuple(d for d, _, _ in r.top), r.retries,
                   r.failed) for r in loop.responses)


def _pair_static(corp):
    ref = jpipeline.PirRagSystem.build(corp.texts, corp.embeddings,
                                       n_clusters=N_CLUSTERS, impl="xla",
                                       kmeans_iters=6)
    port = convert.system_from_state(
        corp.texts, corp.embeddings, centroids=np.asarray(ref.centroids),
        assignment=ref.assignment, n_clusters=N_CLUSTERS,
        a_seed=ref.cfg.a_seed, device="cpu")
    return ref, port


def _pair_live(corp):
    ref = JLiveIndex.build(corp.texts, corp.embeddings, n_clusters=N_CLUSTERS,
                           impl="xla", kmeans_iters=6)
    port = convert.live_from_state(
        corp.texts, corp.embeddings,
        centroids=np.asarray(ref.system.centroids),
        assignment=ref.system.assignment, n_clusters=N_CLUSTERS,
        a_seed=ref.system.cfg.a_seed, device="cpu")
    return ref, port


@pytest.mark.parametrize("max_batch", [1, 4])
def test_static_loop_matches_reference(corp, max_batch):
    ref_sys, port_sys = _pair_static(corp)
    idx, queries = _anchors(corp, 10)
    loops = [JLoop(ref_sys, max_batch=max_batch, deadline_ms=1e9,
                   clock=FakeClock(), seed=3),
             PIRServeLoop(port_sys, max_batch=max_batch, deadline_ms=1e9,
                          clock=FakeClock(), seed=3)]
    offered = [_drive(lp, None, queries, [], 1) for lp in loops]
    assert _served(loops[1]) == _served(loops[0])
    assert len(loops[1].responses) == offered[1] == 10
    for r in loops[1].responses:
        assert int(idx[r.rid]) in [d for d, _, _ in r.top]
        assert r.batch_size <= max_batch and r.timing.gemm_s > 0
    assert [r.t_done for r in loops[1].responses] == \
           [r.t_done for r in loops[0].responses]


@pytest.mark.parametrize("every,max_batch", [(2, 4), (3, 3)])
def test_live_loop_matches_reference_under_mutations(corp, every, max_batch):
    ref_live, port_live = _pair_live(corp)
    idx, queries = _anchors(corp, 16)
    batches = _mutation_batches(corp, 16 // every)
    ref_loop = JLoop(ref_live, max_batch=max_batch, deadline_ms=1e9,
                     clock=(rc := FakeClock()), seed=5,
                     obs=JObs(clock=rc, trace=True))
    port_loop = PIRServeLoop(port_live, max_batch=max_batch, deadline_ms=1e9,
                             clock=(pc := FakeClock()), seed=5,
                             obs=Obs(clock=pc, trace=True))
    _drive(ref_loop, jjournal, queries, batches, every)
    offered = _drive(port_loop, journal, queries, batches, every)

    assert _served(port_loop) == _served(ref_loop)
    assert port_loop.stale_retries == ref_loop.stale_retries > 0
    assert port_loop.failed_requests == ref_loop.failed_requests == 0
    served = sum(not r.failed for r in port_loop.responses)
    assert served + port_loop.failed_requests == offered
    assert port_live.epoch == ref_live.epoch == len(batches)
    for r in port_loop.responses:         # anchors are never mutated
        assert int(idx[r.rid]) in [d for d, _, _ in r.top]
    assert port_loop.obs.tracer.to_chrome() == ref_loop.obs.tracer.to_chrome()
    assert port_loop.obs.metrics_dict() == ref_loop.obs.metrics_dict()


def test_retry_budget_fails_terminally_like_the_reference(corp):
    """With no retries allowed, every request a commit makes stale fails
    terminally — in both loops alike, and nothing is lost."""
    ref_live, port_live = _pair_live(corp)
    _, queries = _anchors(corp, 8)
    batches = _mutation_batches(corp, 4)
    from repro.fleet.retry import RetryPolicy as JRetryPolicy
    ref_loop = JLoop(ref_live, max_batch=8, deadline_ms=1e9,
                     clock=FakeClock(), retry=JRetryPolicy(max_retries=0))
    port_loop = PIRServeLoop(port_live, max_batch=8, deadline_ms=1e9,
                             clock=FakeClock(), retry=RetryPolicy(max_retries=0))
    _drive(ref_loop, jjournal, queries, batches, 2)
    offered = _drive(port_loop, journal, queries, batches, 2)
    assert _served(port_loop) == _served(ref_loop)
    assert port_loop.failed_requests == ref_loop.failed_requests > 0
    served = sum(not r.failed for r in port_loop.responses)
    assert served + port_loop.failed_requests == offered


def test_backoff_schedule_matches_reference(corp):
    """With a backoff retry policy the stale requests wait on the heap; the
    port and the reference serve the same set with the same retries."""
    from repro.fleet.retry import RetryPolicy as JRetryPolicy
    ref_live, port_live = _pair_live(corp)
    idx, queries = _anchors(corp, 12)
    batches = _mutation_batches(corp, 4)
    kw = dict(max_retries=4, backoff_base_ms=0.3, jitter_frac=0.5, seed=7)
    ref_loop = JLoop(ref_live, max_batch=4, deadline_ms=1e9,
                     clock=FakeClock(), retry=JRetryPolicy(**kw))
    port_loop = PIRServeLoop(port_live, max_batch=4, deadline_ms=1e9,
                             clock=FakeClock(), retry=RetryPolicy(**kw))
    _drive(ref_loop, jjournal, queries, batches, 3)
    offered = _drive(port_loop, journal, queries, batches, 3)
    assert _served(port_loop) == _served(ref_loop)
    assert port_loop.stale_retries == ref_loop.stale_retries > 0
    served = sum(not r.failed for r in port_loop.responses)
    assert served + port_loop.failed_requests == offered


class _FailFirstCommit:
    """Fires the commit-stage site on its first invocation only."""

    def __init__(self):
        self.calls = 0

    def fire(self, site):
        assert site == "update.commit.stage"
        self.calls += 1
        return self.calls == 1


def test_failed_commit_is_retried_and_stale_clients_are_refused(corp):
    """An injected stage failure leaves the batch pending; the loop commits
    it on a later tick.  A client still at an old epoch is rejected, then
    served at the head."""
    _, port_live = _pair_live(corp)
    idx, queries = _anchors(corp, 4)
    port_live.faults = _FailFirstCommit()
    loop = PIRServeLoop(port_live, max_batch=2, deadline_ms=1e9,
                        clock=FakeClock())
    loop.submit_mutation(_as_mutation(journal, *_mutation_batches(corp, 1)[0][0]))
    loop.submit(0, queries[0])
    loop.tick()                          # the commit fails; epoch stays 0
    assert port_live.epoch == 0 and loop.obs.metrics_dict()[
        "fleet.commit_failures"] == 1
    loop.submit(1, queries[1])
    loop.drain()                         # retried commit lands
    assert port_live.epoch == 1 and port_live.journal.pending() == []
    loop.submit(2, queries[2], epoch=0)  # formed against the old hint
    loop.submit(3, queries[3])
    loop.drain()
    by_rid = {r.rid: r for r in loop.responses}
    assert sorted(by_rid) == [0, 1, 2, 3] and not loop.failed_requests
    assert by_rid[2].retries == 1 and by_rid[2].epoch == 1
    for rid, r in by_rid.items():
        assert int(idx[rid]) in [d for d, _, _ in r.top]
    with pytest.raises(ValueError):
        PIRServeLoop(port_live.system).submit_mutation(None)
