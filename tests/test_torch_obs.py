"""The port's observability layer against the JAX package's.

The same calls, in the same order, under the same fake clock, must give the
same scrub decisions, the same merged metrics and a byte-identical Chrome
trace.  The one difference by design: `kernel_annotation` opens a
``torch.profiler.record_function`` region instead of JAX's.
"""
import json

import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro_torch import obs


class FakeClock:
    """Monotone virtual clock advancing a fixed step per reading."""

    def __init__(self, step: float = 1e-4):
        self.t = 0.0
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


GOOD = [0, 7, -3, 2.5, True, np.int64(5), np.float32(1.5), np.bool_(False),
        "sync", "delta", "full", "served", "auto"]
BAD = [b"bytes", np.zeros(3), [1, 2], {"a": 1}, None, "free text",
       "decoded document", 1 + 2j, torch.zeros(2)]


@pytest.mark.parametrize("value", GOOD, ids=repr)
def test_scrub_accepts_what_the_reference_accepts(value):
    got, want = obs.scrub(value), jobs.scrub(value)
    assert got == want and type(got) is type(want)


@pytest.mark.parametrize("value", BAD, ids=lambda v: type(v).__name__)
def test_scrub_rejects_what_the_reference_rejects(value):
    with pytest.raises(obs.PrivacyViolation):
        obs.scrub(value)
    if not isinstance(value, torch.Tensor):
        with pytest.raises(jobs.PrivacyViolation):
            jobs.scrub(value)


def test_port_routes_are_registered_enums():
    assert obs.scrub("cuda") == "cuda" and obs.scrub("torch") == "torch"


def _fill(mod, seed):
    reg = mod.MetricsRegistry()
    rng = np.random.default_rng(seed)
    for v in rng.exponential(20.0, 40):
        reg.histogram("serve.latency_ms").record(float(v))
    reg.histogram("serve.latency_ms").record(float("inf"))
    reg.counter("serve.responses").inc(int(rng.integers(1, 50)))
    reg.gauge("serve.queue_depth").set(int(rng.integers(0, 9)))
    reg.histogram("commit.patch_bytes",
                  bounds=mod.DEFAULT_SIZE_BUCKETS).record(int(seed) * 100)
    return reg


@pytest.mark.parametrize("seeds", [(0, 1, 2), (3, 4, 5)])
def test_registry_merge_matches_reference(seeds):
    pa, pb, pc = (_fill(obs, s) for s in seeds)
    ra, rb, rc = (_fill(jobs, s) for s in seeds)
    left = pa.merge(pb).merge(pc).to_dict()
    assert left == pa.merge(pb.merge(pc)).to_dict()
    assert left == ra.merge(rb).merge(rc).to_dict()
    assert json.dumps(left) == json.dumps(ra.merge(rb.merge(rc)).to_dict())
    for q in (50, 90, 99, 100):
        assert (pa.histogram("serve.latency_ms").percentile(q)
                == ra.histogram("serve.latency_ms").percentile(q))
    vals = [3.0, float("inf"), 1.0, 2.0]
    assert obs.percentile(vals, 99) == jobs.percentile(vals, 99)


def _script(o):
    """One fixed sequence of spans, instants and metrics on an `Obs`."""
    with o.span("serve.tick", engine="sync") as tick:
        o.gauge("serve.queue_depth").set(3)
        with o.span("commit.stage", mutations=4) as sp:
            sp.set(kind="delta", touched=2)
        with o.span("commit.publish", kind="delta", epoch=1):
            o.instant("epoch.compact", from_epoch=0, to_epoch=2,
                      segment_bytes=1234)
        tick.set(batch=2, epoch=1)
        for name in ("serve.plan", "serve.gemm", "serve.complete"):
            with o.span(name, batch=2):
                pass
    with o.span("serve.tick", engine="sync"):
        o.counter("serve.responses").inc(2)


def test_chrome_trace_export_is_byte_identical(tmp_path):
    port = obs.Obs(clock=FakeClock(), trace=True)
    ref = jobs.Obs(clock=FakeClock(), trace=True)
    _script(port)
    _script(ref)
    got = port.export_chrome(str(tmp_path / "port.json"))
    want = ref.export_chrome(str(tmp_path / "ref.json"))
    assert got == want
    assert (tmp_path / "port.json").read_bytes() == \
           (tmp_path / "ref.json").read_bytes()
    assert obs.validate_chrome_trace(got) == []
    assert port.metrics_dict() == ref.metrics_dict()
    assert obs.span_coverage(port.tracer.spans) == \
           jobs.span_coverage(ref.tracer.spans)


def test_untraced_obs_reads_the_clock_as_the_traced_one():
    """trace=False keeps span timing (BatchTiming is built from it) but
    retains nothing: the same clock reads, less the one instant it drops
    unread."""
    on, off = FakeClock(), FakeClock()
    traced, untraced = obs.Obs(clock=on, trace=True), obs.Obs(clock=off)
    _script(traced)
    _script(untraced)
    assert on.t - off.t == pytest.approx(on.step)
    assert untraced.tracer.spans == [] and untraced.tracer.instants == []
    assert len(traced.tracer.spans) == 7


def test_kernel_annotation_is_a_noop_until_enabled():
    assert not obs.kernel_annotations_enabled()
    assert obs.kernel_annotation("pirrag.delta_gemm.torch") is \
           obs.kernel_annotation("other")
    obs.enable_kernel_annotations(True)
    try:
        ctx = obs.kernel_annotation("pirrag.delta_gemm.torch")
        assert isinstance(ctx, torch.profiler.record_function)
    finally:
        obs.enable_kernel_annotations(False)
    assert not obs.kernel_annotations_enabled()
