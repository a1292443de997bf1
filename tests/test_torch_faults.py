"""The port's fault plans and answer-fault injection against the JAX
package's.

`FaultPlan.random` draws from ``np.random.default_rng`` in the reference's
order, so a seed gives the same events in both packages; a compiled
injector fires the same events at the same invocations.  On the engines,
twins of the reference's fleet tests: an answer drop charges one retry and
the request is served; an answer delay holds the batch for its window,
then serves it with no retry charged; a commit-stage fault is retried to
the same hint; an armed empty plan changes nothing.  Each is held against
the reference's engine of the same kind on the same schedule under a fake
clock.
"""
import copy

import numpy as np
import pytest
import torch

from repro.data import corpus as jcorpus
from repro.fleet import faults as jfaults
from repro.serve import PIRServeLoop as JLoop
from repro.serve import PipelinedServeLoop as JPipe
from repro.update import LiveIndex as JLiveIndex
from repro_torch import convert
from repro_torch.fleet import faults
from repro_torch.serve import PIRServeLoop, PipelinedServeLoop
from repro_torch.update import journal

N_DOCS = 160
N_CLUSTERS = 6


class FakeClock:
    """Monotone virtual clock advancing a fixed step per reading."""

    def __init__(self, step: float = 1e-4):
        self.t = 0.0
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


def _events(plan):
    return [(e.site, e.at, e.device, e.down_ticks, e.delay_s)
            for e in plan.events]


@pytest.mark.parametrize("seed", [0, 1, 7, 123, 2024])
def test_random_plan_equals_reference(seed):
    kw = dict(n_events=9, horizon=40, n_devices=8)
    assert _events(faults.FaultPlan.random(seed, **kw)) == \
        _events(jfaults.FaultPlan.random(seed, **kw))
    sites = (faults.SITE_ANSWER_DROP, faults.SITE_COMMIT_FAIL)
    kw2 = dict(n_events=5, horizon=7, n_devices=2, max_down_ticks=3,
               max_delay_s=0.5, sites=sites)
    assert _events(faults.FaultPlan.random(seed, **kw2)) == \
        _events(jfaults.FaultPlan.random(seed, **kw2))


def test_sites_and_fixed_plans_equal_reference():
    assert faults.ALL_SITES == jfaults.ALL_SITES
    assert _events(faults.FaultPlan.none()) == []
    one = dict(at_tick=8, device=1, down_ticks=16)
    assert _events(faults.FaultPlan.single_shard_loss(**one)) == \
        _events(jfaults.FaultPlan.single_shard_loss(**one))
    with pytest.raises(ValueError):
        faults.FaultEvent("no.such.site", at=0)


def test_injector_fires_as_reference():
    """Both injectors, compiled from equal plans, fire the same events on
    the same call sequence and count the same invocations."""
    kw = dict(n_events=12, horizon=6, n_devices=4)
    port = faults.FaultPlan.random(5, **kw).compile()
    ref = jfaults.FaultPlan.random(5, **kw).compile()
    calls = np.random.default_rng(3).integers(0, len(faults.ALL_SITES), 60)
    for i in calls:
        site = faults.ALL_SITES[int(i)]
        assert _events(faults.FaultPlan(tuple(port.fire(site)))) == \
            _events(jfaults.FaultPlan(tuple(ref.fire(site))))
    for site in faults.ALL_SITES:
        assert port.invocations(site) == ref.invocations(site)
    assert len(port.fired) == len(ref.fired) > 0


@pytest.fixture(scope="module")
def base():
    corp = jcorpus.make_corpus(2, N_DOCS, emb_dim=16, n_topics=N_CLUSTERS,
                               text_len=(16, 64))
    live = JLiveIndex.build(corp.texts, corp.embeddings,
                            n_clusters=N_CLUSTERS, impl="xla", kmeans_iters=6)
    return corp, live


def _port_live(corp, jlive):
    return convert.live_from_state(
        corp.texts, corp.embeddings,
        centroids=np.asarray(jlive.system.centroids),
        assignment=jlive.system.assignment, n_clusters=N_CLUSTERS,
        a_seed=jlive.system.cfg.a_seed, device="cpu")


def _signature(loop):
    return [(r.rid, r.epoch, r.retries, r.failed, r.t_done - r.t_arrival,
             tuple(d for d, _, _ in r.top)) for r in loop.responses]


def _serve_one(loop, corp):
    loop.submit(0, corp.embeddings[0], top_k=3)
    loop.drain()
    return loop


def _pair(corp, jbase, event, engine=PipelinedServeLoop):
    """The reference's twin engine and the port's, each serving one request
    under a plan of the one event."""
    kw = dict(max_batch=4, deadline_ms=1e9, seed=0)
    pipelined = engine is PipelinedServeLoop
    extra = {"depth": 1} if pipelined else {}
    ref = _serve_one((JPipe if pipelined else JLoop)(
        copy.deepcopy(jbase), clock=FakeClock(),
        faults=jfaults.FaultPlan((event(jfaults),)).compile(), **extra,
        **kw), corp)
    port = _serve_one(engine(_port_live(corp, jbase), clock=FakeClock(),
                             faults=faults.FaultPlan((event(faults),))
                             .compile(), **extra, **kw), corp)
    return ref, port


@pytest.mark.parametrize("engine", [PipelinedServeLoop, PIRServeLoop])
def test_answer_drop_charges_retry_and_serves(base, engine):
    corp, jbase = base
    ref, port = _pair(corp, jbase, lambda m: m.FaultEvent(
        m.SITE_ANSWER_DROP, at=0), engine)
    (r,) = port.responses
    assert not r.failed and r.retries == 1 and len(r.top) == 3
    assert port.obs.metrics_dict()["fleet.answer_drops"] == 1
    assert _signature(port) == _signature(ref)


@pytest.mark.parametrize("engine", [PipelinedServeLoop, PIRServeLoop])
def test_answer_delay_holds_then_serves(base, engine):
    corp, jbase = base
    ref, port = _pair(corp, jbase, lambda m: m.FaultEvent(
        m.SITE_ANSWER_DELAY, at=0, delay_s=0.05), engine)
    (r,) = port.responses
    assert not r.failed and r.retries == 0 and len(r.top) == 3
    assert r.t_done - r.t_arrival > 0.05           # held for the window
    assert port.obs.metrics_dict()["fleet.answer_delays"] == 1
    assert _signature(port) == _signature(ref)


def test_commit_faults_are_retried_to_the_same_hint(base):
    """Two injected stage failures: the commits retry under backoff and the
    final hint equals the unfaulted run's, and the reference's."""
    corp, jbase = base

    def run(faulted):
        plan = faults.FaultPlan((faults.FaultEvent(faults.SITE_COMMIT_FAIL,
                                                   at=0),
                                 faults.FaultEvent(faults.SITE_COMMIT_FAIL,
                                                   at=1)))
        loop = PipelinedServeLoop(
            _port_live(corp, jbase), max_batch=4, deadline_ms=1e9,
            clock=FakeClock(), seed=0, depth=1,
            faults=plan.compile() if faulted else None)
        for i in range(3):
            loop.submit_mutation(journal.replace(
                i, f"fault {i}".encode(), corp.embeddings[i]))
            loop.submit(i, corp.embeddings[i], top_k=3)
            loop.tick()
        loop.drain()
        return loop

    clean, faulted = run(False), run(True)
    assert clean.epoch == 3 and 1 <= faulted.epoch <= 3
    assert torch.equal(faulted.live.system.hint, clean.live.system.hint)
    assert faulted.obs.metrics_dict()["fleet.commit_failures"] == 2
    assert len(faulted.responses) == 3
    assert not any(r.failed for r in faulted.responses)
    jlive = copy.deepcopy(jbase)
    for i in range(3):
        jlive.replace(i, f"fault {i}".encode(), corp.embeddings[i])
    jlive.commit()
    np.testing.assert_array_equal(
        faulted.live.system.hint.numpy().view(np.uint32),
        np.asarray(jlive.system.hint))


def test_armed_empty_plan_changes_nothing(base):
    """An injector with no events guards every site and fires none: the
    response stream equals an uninjected run's."""
    corp, jbase = base

    def run(inj):
        loop = PipelinedServeLoop(_port_live(corp, jbase), max_batch=3,
                                  deadline_ms=1e9, clock=FakeClock(), seed=0,
                                  depth=2, faults=inj)
        for rid in range(7):
            loop.submit(rid, corp.embeddings[rid * 5], top_k=4)
            if rid == 3:
                loop.submit_mutation(journal.replace(
                    9, b"armed", corp.embeddings[9]))
            loop.tick()
        loop.drain()
        return loop

    inj = faults.FaultPlan.none().compile()
    plain, armed = run(None), run(inj)
    assert _signature(armed) == _signature(plain)
    assert inj.invocations(faults.SITE_ANSWER_DROP) > 0
    assert inj.invocations(faults.SITE_COMMIT_FAIL) == 1
    assert not inj.fired
