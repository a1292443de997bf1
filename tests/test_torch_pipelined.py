"""The port's pipelined serve engine against the JAX package's, and against
the port's own synchronous loop.

Twins of the reference's pipelined-engine tests: scripted interleavings of
submits, mutations, ticks and drains over a live index with batch PIR on
(multi-probe queries take the bucketed path), a static system, idle ticks,
`BatchTiming` parity, donated shadow commits, `set_depth`, and keyed and
mixed batches.  Under a fake clock the port's pipelined engine must give
the reference's pipelined engine's responses, epochs, retry counts,
`BatchTiming` components and Chrome trace, and the port's sync loop's
responses.  The LWE randomness differs by design (a torch.Generator
against a threefry key stream); decryption is exact, so responses do not.
A full rebuild re-runs the port's own k-means, so the scripts stay within
delta epochs (asserted).  Seeds are fixed.
"""
import copy
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.data import corpus as jcorpus
from repro.obs import Obs as JObs
from repro.serve import PIRServeLoop as JLoop
from repro.serve import PipelinedServeLoop as JPipe
from repro.update import LiveIndex as JLiveIndex
from repro.update import journal as jjournal
from repro_torch import convert
from repro_torch.kernels import ops
from repro_torch.obs import Obs
from repro_torch.serve import PIRServeLoop, PipelinedServeLoop
from repro_torch.update import LiveIndex, journal

N_DOCS = 200
N_CLUSTERS = 6


class FakeClock:
    """Monotone virtual clock advancing a fixed step per reading."""

    def __init__(self, step: float = 1e-4):
        self.t = 0.0
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


@pytest.fixture(scope="module")
def base():
    """The reference's live index (batch PIR at kappa 4), built once; each
    engine run gets a deepcopy of it, or the port's conversion of it."""
    corp = jcorpus.make_corpus(1, N_DOCS, emb_dim=16, n_topics=N_CLUSTERS,
                               text_len=(16, 64))
    live = JLiveIndex.build(corp.texts, corp.embeddings,
                            n_clusters=N_CLUSTERS, impl="xla", kmeans_iters=6)
    live.system.enable_batch(kappa=4)
    return corp, live


def _port_live(corp, jlive):
    bp = jlive.system.batch
    return convert.live_from_state(
        corp.texts, corp.embeddings,
        centroids=np.asarray(jlive.system.centroids),
        assignment=jlive.system.assignment, n_clusters=N_CLUSTERS,
        a_seed=jlive.system.cfg.a_seed, device="cpu",
        batch=dict(kappa=bp.kappa, n_buckets=bp.partition.n_buckets,
                   seed=bp.seed))


def _signature(loop):
    return [(r.rid, r.epoch, r.retries, r.batch_size, r.failed,
             tuple((d, t) for d, _, t in r.top)) for r in loop.responses]


def _drive(loop, corp, ops_, mod):
    """ops: ("submit", rid, emb_idx, top_k, multi_probe) |
    ("mutate", kind, doc_id, tag) | ("tick",) | ("drain",)."""
    for op in ops_:
        if op[0] == "submit":
            _, rid, idx, top_k, mp = op
            loop.submit(rid, corp.embeddings[idx], top_k=top_k,
                        multi_probe=mp)
        elif op[0] == "mutate":
            _, kind, doc, tag = op
            if kind == "delete":
                loop.submit_mutation(mod.delete(doc))
            else:
                loop.submit_mutation(getattr(mod, kind)(
                    doc, f"{kind} {doc} {tag}".encode(),
                    corp.embeddings[doc % N_DOCS]))
        elif op[0] == "tick":
            loop.tick()
        else:
            loop.drain()
    loop.drain()


def _script(rng, n_ops):
    """Random interleaving over live doc ids (the reference test's)."""
    ops_, alive, next_id, rid = [], set(range(N_DOCS)), N_DOCS, 0
    for _ in range(n_ops):
        roll = rng.integers(0, 10)
        if roll < 6:
            ops_.append(("submit", rid, int(rng.integers(0, N_DOCS)),
                         int(rng.integers(1, 6)),
                         int(rng.choice([1, 1, 2, 3]))))
            rid += 1
        elif roll < 8 and alive:
            kind = ["replace", "insert", "delete"][int(rng.integers(0, 3))]
            if kind == "insert":
                ops_.append(("mutate", "insert", next_id, rid))
                alive.add(next_id)
                next_id += 1
            elif kind == "delete" and len(alive) > N_DOCS // 2:
                doc = int(sorted(alive)[int(rng.integers(0, len(alive)))])
                ops_.append(("mutate", "delete", doc, rid))
                alive.discard(doc)
            else:
                doc = int(sorted(alive)[int(rng.integers(0, len(alive)))])
                ops_.append(("mutate", "replace", doc, rid))
        elif roll == 8:
            ops_.append(("tick",))
        else:
            ops_.append(("drain",))
    return ops_


def _timings(loop):
    return [(r.rid, r.timing.t_plan, r.timing.encode_s, r.timing.gemm_s,
             r.timing.decode_s, r.t_done) for r in loop.responses]


_RUNS: dict = {}


def _run_three(corp, jbase, seed, *, depth, max_batch=4):
    """(reference pipelined, port pipelined, port sync) over the script of
    ``seed``, the first two traced under the same fake clock; one run per
    (seed, depth) in this module."""
    key = (seed, depth)
    if key not in _RUNS:
        _RUNS[key] = _engines(corp, jbase, _script(
            np.random.default_rng(seed), 60), depth=depth,
            max_batch=max_batch)
    return _RUNS[key]


def _engines(corp, jbase, ops_, *, depth, max_batch):
    jlive = copy.deepcopy(jbase)
    ref = JPipe(jlive, max_batch=max_batch, deadline_ms=1e9,
                clock=(rc := FakeClock()), seed=0, depth=depth,
                donate=True, obs=JObs(clock=rc, trace=True))
    _drive(ref, corp, ops_, jjournal)
    pipe = PipelinedServeLoop(_port_live(corp, jbase), max_batch=max_batch,
                              deadline_ms=1e9, clock=(pc := FakeClock()),
                              seed=0, depth=depth,
                              obs=Obs(clock=pc, trace=True))
    _drive(pipe, corp, ops_, journal)
    sync = PIRServeLoop(_port_live(corp, jbase), max_batch=max_batch,
                        deadline_ms=1e9, clock=FakeClock(), seed=0)
    _drive(sync, corp, ops_, journal)
    assert not any(c.full_rebuild for c in jlive.commits)
    return ref, pipe, sync


@pytest.mark.parametrize("depth", [1, 3])
def test_pipelined_matches_reference_and_sync_scripted(base, depth):
    """Mutations, multi-probe queries and partial drains: the port's
    pipelined engine serves the reference's responses at the same epochs
    with the same retries and trace, and its sync loop's responses."""
    corp, jbase = base
    ref, pipe, sync = _run_three(corp, jbase, 11, depth=depth)
    assert _signature(pipe) == _signature(ref) == _signature(sync)
    assert pipe.stale_retries == ref.stale_retries == sync.stale_retries > 0
    assert pipe.epoch == ref.epoch == sync.epoch > 0
    assert pipe.inflight == ref.inflight == 0
    assert any(r.batch_size > 1 for r in pipe.responses)
    assert pipe.obs.tracer.to_chrome() == ref.obs.tracer.to_chrome()
    assert pipe.obs.metrics_dict() == ref.obs.metrics_dict()


def test_pipelined_static_system(base):
    """No LiveIndex: pipelining over a static corpus still matches."""
    corp, jbase = base
    ops_ = [("submit", rid, rid % N_DOCS, 4, 1 + rid % 2)
            for rid in range(9)]
    ref = JPipe(copy.deepcopy(jbase.system), max_batch=4, deadline_ms=1e9,
                clock=FakeClock(), seed=0, depth=2)
    _drive(ref, corp, ops_, jjournal)
    port_sys = _port_live(corp, jbase).system
    pipe = PipelinedServeLoop(port_sys, max_batch=4, deadline_ms=1e9,
                              clock=FakeClock(), seed=0, depth=2)
    _drive(pipe, corp, ops_, journal)
    sync = PIRServeLoop(port_sys, max_batch=4, deadline_ms=1e9,
                        clock=FakeClock(), seed=0)
    _drive(sync, corp, ops_, journal)
    assert _signature(pipe) == _signature(ref) == _signature(sync)
    assert len(pipe.responses) == 9


def test_idle_ticks_retire_inflight_batches(base):
    """During a lull, tick() flushes the pipeline: finished batches do not
    wait behind `depth`."""
    corp, jbase = base
    loop = PipelinedServeLoop(_port_live(corp, jbase), max_batch=4,
                              deadline_ms=1e9, clock=FakeClock(), seed=0,
                              depth=4)
    for rid in range(4):
        loop.submit(rid, corp.embeddings[rid])
    assert loop.tick() == 4             # dispatches one batch, depth not hit
    assert loop.inflight == 1 and not loop.responses
    assert loop.tick() == 0             # idle tick: nothing to dispatch...
    assert loop.inflight == 0 and len(loop.responses) == 4   # ...but retires


def test_batch_timing_parity_with_reference_and_sync(base):
    """Every response carries a well-formed `BatchTiming`; the port's
    pipelined components equal the reference's under the fake clock, and
    both engines group responses into the same batches."""
    corp, jbase = base
    ref, pipe, sync = _run_three(corp, jbase, 11, depth=3)
    assert _timings(pipe) == _timings(ref)
    for loop in (sync, pipe):
        for r in loop.responses:
            t = r.timing
            assert t.encode_s > 0 and t.gemm_s > 0 and t.decode_s > 0
            assert t.t_plan < r.t_done

    def partition(loop):
        groups: dict = {}
        for r in loop.responses:
            groups.setdefault(id(r.timing), []).append(r.rid)
        return sorted(map(tuple, groups.values()))

    assert partition(pipe) == partition(sync) == partition(ref)


def test_donated_commits_stay_exact(base):
    """After donated shadow commits the card-side state equals a fresh
    setup() of the mutated corpus, the host mirror and the reference's."""
    corp, jbase = base
    jlive, live = copy.deepcopy(jbase), _port_live(corp, jbase)
    loops = [JPipe(jlive, max_batch=4, deadline_ms=1e9, clock=FakeClock(),
                   seed=0, depth=2, donate=True),
             PipelinedServeLoop(live, max_batch=4, deadline_ms=1e9,
                                clock=FakeClock(), seed=0, depth=2)]
    for loop, mod in zip(loops, (jjournal, journal)):
        rng = np.random.default_rng(5)
        for rid in range(24):
            loop.submit(rid, corp.embeddings[rid % N_DOCS])
            if rid % 6 == 0:
                d = int(rng.integers(0, N_DOCS))
                loop.submit_mutation(mod.replace(
                    d, f"donated {d}@{rid}".encode(), corp.embeddings[d]))
            loop.tick()
        loop.drain()
    assert live.epoch == jlive.epoch >= 3
    assert loops[1]._shadow.commits == live.epoch
    assert loops[1]._shadow.stage_seconds > 0
    sys_ = live.system
    np.testing.assert_array_equal(sys_.server.db.numpy(), sys_.db.matrix)
    np.testing.assert_array_equal(sys_.db.matrix, jlive.system.db.matrix)
    assert torch.equal(sys_.server.setup(), sys_.hint)
    np.testing.assert_array_equal(sys_.hint.numpy().view(np.uint32),
                                  np.asarray(jlive.system.hint))
    bserver = sys_.batch.server
    for b in range(sys_.batch.partition.n_buckets):
        fresh = ops.hint_gemm(bserver.sub_dbs[b], bserver.a_matrix(b),
                              impl="torch")
        assert torch.equal(fresh, bserver.hints[b])
    assert _signature(loops[1]) == _signature(loops[0])


def test_set_depth_retires_the_excess_at_the_next_tick(base):
    corp, jbase = base
    loop = PipelinedServeLoop(_port_live(corp, jbase), max_batch=2,
                              deadline_ms=1e9, clock=FakeClock(), seed=0,
                              depth=3)
    for rid in range(0, 6, 2):           # a full batch each tick
        loop.submit(rid, corp.embeddings[rid])
        loop.submit(rid + 1, corp.embeddings[rid + 1])
        loop.tick()
    assert loop.inflight == 3 and not loop.responses
    loop.set_depth(1)
    assert loop.depth == 1
    loop.submit(6, corp.embeddings[6])
    loop.submit(7, corp.embeddings[7])
    loop.tick()                          # dispatches one, retires down to 1
    assert loop.inflight == 1 and len(loop.responses) == 6
    loop.set_depth(0)                    # clamped to 1
    assert loop.depth == 1
    loop.drain()
    assert loop.inflight == 0
    assert [r.rid for r in loop.responses] == list(range(8))


def test_keyed_lookup_mixed_batch_both_engines():
    """Keyed lookups and a similarity query share one tick in both port
    engines and the reference's pipelined one; rows equal the table through
    a replace epoch, and the engines agree response for response."""
    rng = np.random.default_rng(6)
    table = rng.standard_normal((144, 8)).astype(np.float32)
    new_row = rng.standard_normal(8).astype(np.float32)
    asks = [rng.integers(0, 144, size=k).tolist() for k in (3, 9)]

    def drive(loop, mod):
        layout = loop._serving_system().keyed
        for rid, ids in enumerate(asks):
            loop.submit_lookup(rid, ids)
        loop.submit(10, table[7], top_k=3)            # mixed-kind tick
        assert loop.tick(force=True) >= 1
        loop.drain()
        loop.submit_mutation(mod.replace(asks[0][0],
                                         layout.row_text(new_row), new_row))
        loop.submit_lookup(11, asks[0])               # re-fetch after commit
        loop.drain()
        return loop.responses

    kw = dict(max_batch=8, deadline_ms=1e9, seed=0)
    ref = drive(JPipe(JLiveIndex.build_keyed(table, kappa=9, impl="xla",
                                             seed=0),
                      clock=FakeClock(), depth=2, **kw), jjournal)
    sync = drive(PIRServeLoop(LiveIndex.build_keyed(table, kappa=9, seed=0,
                                                    device="cpu"),
                              clock=FakeClock(), **kw), journal)
    pipe = drive(PipelinedServeLoop(LiveIndex.build_keyed(
        table, kappa=9, seed=0, device="cpu"), clock=FakeClock(), depth=2,
        **kw), journal)
    patched = table.copy()
    patched[asks[0][0]] = new_row
    for resp in (sync, pipe):
        by_rid = {r.rid: r for r in resp}
        assert set(by_rid) == {0, 1, 10, 11}
        for rid, ids in enumerate(asks):
            np.testing.assert_array_equal(by_rid[rid].top, table[ids])
        assert by_rid[10].top and by_rid[10].epoch == 0
        assert by_rid[11].epoch == 1
        np.testing.assert_array_equal(by_rid[11].top, patched[asks[0]])
    sig = [[(r.rid, r.epoch, r.batch_size, r.retries) for r in resp]
           for resp in (ref, sync, pipe)]
    assert sig[0] == sig[1] == sig[2]
    for a, b, c in zip(ref, sync, pipe):
        if a.rid == 10:
            assert [d for d, _, _ in a.top] == [d for d, _, _ in b.top] \
                == [d for d, _, _ in c.top]
        else:
            np.testing.assert_array_equal(b.top, a.top)
            np.testing.assert_array_equal(c.top, a.top)


def test_serve_cli_runs_pipelined_on_the_cpu_and_needs_a_card_by_default():
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--docs", "160",
           "--requests", "8", "--max-batch", "4", "--mutate-every", "4"]
    env = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"}
    out = subprocess.run(cmd + ["--device", "cpu", "--engine", "pipelined"],
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[pipelined] served 8 requests" in out.stdout
    assert not torch.cuda.is_available()
    nocard = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                            env=env)
    assert nocard.returncode != 0
    assert "no CUDA device" in nocard.stderr
    fleet = subprocess.run(cmd + ["--engine", "fleet"], capture_output=True,
                           text=True, timeout=300, env=env)
    assert fleet.returncode != 0
    assert "not ported yet: ROADMAP queue 1 item 5" in fleet.stderr
