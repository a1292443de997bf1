"""Multi-probe retrieval through batch-PIR: the port against the JAX package.

`query` and `query_batch` with ``multi_probe > 1`` on a system with
batch-PIR enabled must take the bucketed path, account for it as the
reference does and return the same top-k.  The sync serve loop groups a
tick's requests by kind and probe count; under a fake clock the port's and
the reference's loops must serve the same (rid, epoch, top-k) set, with
and without live commits routed into the buckets, and export the same
Chrome trace.  Fixtures have no near-ties; seeds are fixed.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import pipeline as jpipeline
from repro.data import corpus as jcorpus
from repro.obs import Obs as JObs
from repro.serve.engine import PIRServeLoop as JLoop
from repro.update import LiveIndex as JLiveIndex
from repro.update import journal as jjournal
from repro_torch import convert
from repro_torch.core import pipeline
from repro_torch.obs import Obs
from repro_torch.serve import PIRServeLoop
from repro_torch.update import journal

N_CLUSTERS = 8
KNOBS = dict(kappa=3, n_buckets=9, seed=4)


class FakeClock:
    """Monotone virtual clock advancing a fixed step per reading."""

    def __init__(self, step: float = 1e-4):
        self.t = 0.0
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


@pytest.fixture(scope="module")
def corp():
    return jcorpus.make_corpus(4, 240, emb_dim=16, n_topics=N_CLUSTERS)


@pytest.fixture(scope="module")
def pair(corp):
    jsys = jpipeline.PirRagSystem.build(corp.texts, corp.embeddings,
                                        n_clusters=N_CLUSTERS, impl="xla",
                                        kmeans_iters=6)
    jsys.enable_batch(**KNOBS)
    tsys = convert.system_from_state(
        corp.texts, corp.embeddings, centroids=np.asarray(jsys.centroids),
        assignment=jsys.assignment, n_clusters=N_CLUSTERS,
        a_seed=jsys.cfg.a_seed, batch=KNOBS, device="cpu")
    return jsys, tsys


def _queries(corp, anchors, seed=0):
    rng = np.random.default_rng(seed)
    q = corp.embeddings[anchors] + 0.02 * rng.standard_normal(
        (len(anchors), corp.d))
    return q.astype(np.float32)


def _ids(top):
    return [d for d, _, _ in top]


@pytest.mark.parametrize("probes", [2, 3])
def test_query_multi_probe_matches_reference(corp, pair, probes):
    jsys, tsys = pair
    q = _queries(corp, [17])[0]
    top, st = tsys.query(q, top_k=6, multi_probe=probes,
                         generator=torch.Generator().manual_seed(1))
    jtop, jst = jsys.query(q, top_k=6, multi_probe=probes,
                           key=jax.random.PRNGKey(1))
    assert _ids(top) == _ids(jtop) and 17 in _ids(top)
    assert st.mode == jst.mode == "batch"
    for f in ("uplink_bytes", "downlink_bytes", "cluster_index", "probes",
              "n_buckets", "hint_bytes"):
        assert getattr(st, f) == getattr(jst, f), f


def test_query_modes_route_like_the_reference(corp, pair):
    jsys, tsys = pair
    q = _queries(corp, [40])[0]
    gen = torch.Generator().manual_seed(2)
    for kw in (dict(multi_probe=1), dict(multi_probe=3, mode="legacy"),
               dict(multi_probe=1, mode="batch")):
        top, st = tsys.query(q, top_k=4, generator=gen, **kw)
        jtop, jst = jsys.query(q, top_k=4, key=jax.random.PRNGKey(2), **kw)
        assert st.mode == jst.mode
        assert _ids(top) == _ids(jtop)
    with pytest.raises(ValueError, match="unknown query mode"):
        tsys.query(q, mode="fast")
    plain = convert.system_from_state(
        corp.texts, corp.embeddings, centroids=tsys.centroids,
        assignment=tsys.assignment, n_clusters=N_CLUSTERS,
        a_seed=tsys.cfg.a_seed, device="cpu")
    with pytest.raises(ValueError, match="enable_batch"):
        plain.query(q, mode="batch")


def test_placement_failure_falls_back_to_legacy(corp, pair):
    """More probes than buckets never place: the reference and the port
    both fall back to the legacy path, one query and a batch alike."""
    jsys, tsys = pair
    knobs = dict(kappa=2, n_buckets=6, seed=4)
    jsys = dataclasses.replace(jsys, batch=None)
    jsys.enable_batch(**knobs)
    tsys = dataclasses.replace(tsys, batch=None)
    tsys.enable_batch(**knobs)
    q = _queries(corp, [5, 90])
    top, st = tsys.query(q[0], top_k=5, multi_probe=7,
                         generator=torch.Generator().manual_seed(3))
    jtop, jst = jsys.query(q[0], top_k=5, multi_probe=7,
                           key=jax.random.PRNGKey(3))
    assert st.mode == jst.mode == "legacy" and st.probes == 7
    assert _ids(top) == _ids(jtop)
    got = tsys.query_batch(q, top_k=4, multi_probe=7,
                           generator=torch.Generator().manual_seed(4))
    want = jsys.query_batch(q, top_k=4, multi_probe=7, seed=4)
    assert [_ids(g) for g in got] == [_ids(w) for w in want]


def test_query_batch_multi_probe_matches_reference(corp, pair):
    jsys, tsys = pair
    anchors = [3, 60, 111, 200, 60]
    qs = _queries(corp, anchors, seed=5)
    top_k = [5, 3, 7, 5, 2]
    infl = tsys.query_batch_async(qs, top_k=top_k, multi_probe=3,
                                  generator=torch.Generator().manual_seed(5))
    part = tsys.batch.partition
    assert len(infl.pending) == part.n_buckets
    assert [tuple(a.shape) for a in infl.pending] == \
        [(c.m, len(anchors)) for c in tsys.batch.server.cfgs]
    got = infl.complete()
    want = jsys.query_batch(qs, top_k=top_k, multi_probe=3, seed=5)
    assert [_ids(g) for g in got] == [_ids(w) for w in want]
    for a, g in zip(anchors, got):
        assert a in _ids(g)


def test_batch_pir_is_one_pass_per_batch(corp, pair, monkeypatch):
    """However many clients and probes, a batch makes ONE bucketed call."""
    _, tsys = pair
    from repro_torch.kernels import ops
    calls = []
    real = ops.bucketed_modmatmul
    monkeypatch.setattr(ops, "bucketed_modmatmul",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tsys.query_batch(_queries(corp, [1, 2, 3, 4]), top_k=3, multi_probe=2,
                     generator=torch.Generator().manual_seed(6))
    assert len(calls) == 1


# ---------------------------------------------------------------------------
# the serve loop's multi-probe grouping
# ---------------------------------------------------------------------------

def _drive(loop, mod, queries, probes, batches, every):
    it = iter(batches)
    for rid, (q, p) in enumerate(zip(queries, probes)):
        loop.submit(rid, q, top_k=5, multi_probe=p)
        if loop.live is not None and rid % every == every - 1:
            for kind, d, text, emb in next(it, []):
                loop.submit_mutation(mod.delete(d) if kind == "delete"
                                     else getattr(mod, kind)(d, text, emb))
        loop.tick()
    loop.drain()
    return len(queries)


def _served(loop):
    return sorted((r.rid, r.epoch, tuple(_ids(r.top)), r.retries, r.failed,
                   r.batch_size) for r in loop.responses)


PROBES = [1, 2, 3, 2, 1, 3, 2, 2, 1, 3, 3, 1]


@pytest.mark.parametrize("max_batch", [4, 6])
def test_static_loop_groups_probes_like_the_reference(corp, pair, max_batch):
    jsys, tsys = pair
    anchors = [7 + 19 * i for i in range(len(PROBES))]
    queries = _queries(corp, anchors, seed=8)
    loops = []
    for cls, sysm, obs_cls in ((JLoop, jsys, JObs), (PIRServeLoop, tsys, Obs)):
        clock = FakeClock()
        loops.append(cls(sysm, max_batch=max_batch, deadline_ms=1e9,
                         clock=clock, seed=3,
                         obs=obs_cls(clock=clock, trace=True)))
    for lp in loops:
        _drive(lp, None, queries, PROBES, [], 1)
    ref_loop, port_loop = loops
    assert _served(port_loop) == _served(ref_loop)
    for r in port_loop.responses:
        assert anchors[r.rid] in _ids(r.top)
    assert port_loop.obs.tracer.to_chrome() == ref_loop.obs.tracer.to_chrome()


def test_live_loop_routes_commits_into_buckets_like_the_reference(corp):
    ref_live = JLiveIndex.build(corp.texts, corp.embeddings,
                                n_clusters=N_CLUSTERS, impl="xla",
                                kmeans_iters=6)
    ref_live.system.enable_batch(**KNOBS)
    port_live = convert.live_from_state(
        corp.texts, corp.embeddings,
        centroids=np.asarray(ref_live.system.centroids),
        assignment=ref_live.system.assignment, n_clusters=N_CLUSTERS,
        a_seed=ref_live.system.cfg.a_seed, batch=KNOBS, device="cpu")
    anchors = [11 + 17 * i for i in range(len(PROBES))]
    queries = _queries(corp, anchors, seed=9)
    rng = np.random.default_rng(21)
    batches = [[("replace", int(100 + 5 * b), f"rev {b}".encode(),
                 rng.standard_normal(corp.d).astype(np.float32)),
                ("insert", 5000 + b, f"new {b}".encode(),
                 corp.embeddings[b] + 0.01),
                ("delete", int(150 + b), None, None)] for b in range(4)]
    ref_loop = JLoop(ref_live, max_batch=4, deadline_ms=1e9,
                     clock=(rc := FakeClock()), seed=5,
                     obs=JObs(clock=rc, trace=True))
    port_loop = PIRServeLoop(port_live, max_batch=4, deadline_ms=1e9,
                             clock=(pc := FakeClock()), seed=5,
                             obs=Obs(clock=pc, trace=True))
    _drive(ref_loop, jjournal, queries, PROBES, batches, 3)
    offered = _drive(port_loop, journal, queries, PROBES, batches, 3)
    assert _served(port_loop) == _served(ref_loop)
    assert port_loop.stale_retries == ref_loop.stale_retries > 0
    served = sum(not r.failed for r in port_loop.responses)
    assert served + port_loop.failed_requests == offered
    assert port_live.epoch == ref_live.epoch == len(batches)
    for r in port_loop.responses:
        if not r.failed:
            assert anchors[r.rid] in _ids(r.top)
    bp = port_live.system.batch
    for h, f in zip(bp.server.hints, bp.server.setup()):
        assert torch.equal(h, f)
    assert port_loop.obs.tracer.to_chrome() == ref_loop.obs.tracer.to_chrome()


def test_multi_probe_without_batch_keeps_legacy_width(corp):
    """No batch-PIR: multi_probe P still fetches P clusters per client in
    the one flat GEMM (the reference's behaviour)."""
    sysm = pipeline.PirRagSystem.build(corp.texts, corp.embeddings,
                                       n_clusters=N_CLUSTERS, kmeans_iters=4,
                                       device="cpu")
    infl = sysm.query_batch_async(_queries(corp, [1, 2]), top_k=3,
                                  multi_probe=3)
    assert infl.pending[0].shape == (sysm.cfg.m, 6)
    assert len(infl.complete()) == 2
