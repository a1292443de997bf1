"""Privacy-safe observability (twin of ``repro/obs``): tracing + metrics.

Three modules:

`scrub`     the privacy audit boundary — a typed allowlist (numbers,
            registered enums) every span attribute and metric value passes
            through at record time; arrays/bytes/free strings raise
            `PrivacyViolation`, so exports are metadata-only BY
            CONSTRUCTION (sizes, timings, epochs, shard/request ids —
            never query vectors, one-hots, probe patterns or plaintexts).
`registry`  `MetricsRegistry`: counters, gauges, fixed-bucket histograms —
            deterministic (no clock reads), associatively mergeable across
            shards, sharing ONE percentile rank rule with `traffic.slo`.
`trace`     `Tracer`/`Span` nested spans with explicit parent ids,
            Chrome-trace/Perfetto export, and the zero-overhead-when-
            disabled `kernel_annotation` hook `repro_torch.kernels.ops` wears.

`Obs` bundles a tracer and a registry behind one handle the serving stack
threads through itself: the serve loop opens tick/plan/gemm/complete spans
(and derives `BatchTiming` from their boundaries), `LiveIndex` opens
stage/publish/rebuild spans and `EpochLog` emits compaction events.  Built
with ``trace=False`` (the loop's default) spans are timestamped but not
retained — the same timeline, none of the memory.  Under the same clock
and the same calls, the Chrome-trace export is byte-identical to the JAX
package's.
"""
from __future__ import annotations

import time

from repro_torch.obs.registry import (DEFAULT_MS_BUCKETS, DEFAULT_SIZE_BUCKETS,
                                Counter, Gauge, Histogram, MetricsRegistry,
                                percentile)
from repro_torch.obs.scrub import PrivacyViolation, register_enum, scrub
from repro_torch.obs.trace import (Span, Tracer, enable_kernel_annotations,
                             kernel_annotation, kernel_annotations_enabled,
                             span_coverage, validate_chrome_trace)

__all__ = [
    "Obs", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_MS_BUCKETS", "DEFAULT_SIZE_BUCKETS", "percentile",
    "PrivacyViolation", "register_enum", "scrub",
    "Span", "Tracer", "span_coverage", "validate_chrome_trace",
    "enable_kernel_annotations", "kernel_annotation",
    "kernel_annotations_enabled",
]


class Obs:
    """One tracer + one metrics registry, threaded through the hot path.

    ``clock`` must match the instrumented component's clock (the serve
    loops pass theirs in), so virtual-time tests stay deterministic.
    ``trace=False`` keeps span TIMING (the engines build `BatchTiming`
    from span boundaries either way) but retains no spans — the default
    serving configuration, within the <2% instrumentation budget.
    """

    def __init__(self, *, clock=time.perf_counter, trace: bool = False):
        self.tracer = Tracer(clock=clock, keep=trace)
        self.metrics = MetricsRegistry()

    def span(self, name: str, **attrs) -> Span:
        """Open a nested span (context manager); attrs are scrubbed."""
        return self.tracer.span(name, **attrs)

    def instant(self, name: str, **attrs) -> None:
        """Record a point-in-time event (no-op when tracing is off)."""
        self.tracer.instant(name, **attrs)

    def counter(self, name: str) -> Counter:
        """The registry counter `name` (created on first use)."""
        return self.metrics.counter(name)

    def gauge(self, name: str) -> Gauge:
        """The registry gauge `name` (created on first use)."""
        return self.metrics.gauge(name)

    def histogram(self, name: str, bounds=DEFAULT_MS_BUCKETS) -> Histogram:
        """The registry histogram `name` (bounds fix on first creation)."""
        return self.metrics.histogram(name, bounds)

    def export_chrome(self, path: str) -> dict:
        """Write the Chrome-trace JSON to `path`; returns the dict."""
        return self.tracer.export_chrome(path)

    def metrics_dict(self) -> dict:
        """Deterministic export of every metric (see MetricsRegistry)."""
        return self.metrics.to_dict()
