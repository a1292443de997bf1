"""Metrics: counters, gauges, fixed-bucket histograms — mergeable, exact.

A copy of ``repro/obs/registry.py`` (numpy only).  Design constraints:

deterministic   Nothing here reads a clock or draws randomness: a metric's
                state is a pure function of the `record`/`inc`/`set` calls
                made against it, so FakeClock-driven tests see identical
                registries run after run.

mergeable       Every metric type has an ASSOCIATIVE merge (counters sum,
                gauges take the max, histograms add bucket counts), so
                per-shard registries fold into a fleet view in any
                grouping order — `merge(merge(a, b), c)` equals
                `merge(a, merge(b, c))` exactly (property-tested).

privacy-safe    Every recorded value passes the `scrub` allowlist first:
                a histogram can hold latencies and byte counts, never an
                embedding or a plaintext.

one rank rule   `percentile` is THE quantile convention for the repo: the
                order statistic at rank ``ceil(q/100·n) − 1``, propagating
                +inf (shed requests) instead of interpolating it into NaN.
                `traffic.slo.summarize` and `Histogram.percentile` both
                call into it, so the SLO fold and the metrics registry
                cannot drift apart.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.obs.scrub import scrub

#: Default latency buckets (milliseconds): sub-ms to multi-second tail.
DEFAULT_MS_BUCKETS = (0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0,
                      200.0, 500.0, 1000.0, 2000.0, 5000.0)

#: Default size buckets (counts/bytes as powers of two-ish).
DEFAULT_SIZE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                        512.0, 2048.0, 8192.0, 65536.0, 1048576.0)


def _rank(n: int, q: float) -> int:
    """Order-statistic rank for the q-th percentile of n samples."""
    return max(min(n - 1, math.ceil(q / 100.0 * n) - 1), 0)


def percentile(values, q: float) -> float:
    """Exact order-statistic percentile, propagating +inf; 0.0 when empty.

    np.percentile interpolates, which turns a single +inf sample into NaN
    for every quantile above the last finite one; the order statistic keeps
    it +inf — exactly the "shed requests dominate the tail" semantics the
    SLO fold pins.  This function is the single rank rule shared by
    `traffic.slo` and `Histogram.percentile`.
    """
    arr = np.asarray(values, np.float64)
    if arr.size == 0:
        return 0.0
    return float(np.sort(arr)[_rank(arr.size, q)])


@dataclasses.dataclass
class Counter:
    """Monotone counter; cross-shard merge is the sum."""
    name: str
    value: float = 0

    def inc(self, n=1) -> None:
        """Add `n` (scrubbed number) to the counter."""
        self.value += scrub(n, where=self.name)

    def to_value(self):
        """Exported form: the plain count."""
        return self.value


@dataclasses.dataclass
class Gauge:
    """Level gauge (queue depth, pipeline depth); merge takes the max.

    Merging last-write-wins across shards is not associative without
    timestamps, so the cross-shard semantics here are explicitly
    "worst level anywhere": ``value`` merges by max, and ``hi`` tracks the
    local peak so a single-shard registry still exposes its own worst case.
    """
    name: str
    value: float | None = None
    hi: float | None = None

    def set(self, v) -> None:
        """Set the current level (scrubbed number); updates the peak."""
        v = scrub(v, where=self.name)
        self.value = v
        self.hi = v if self.hi is None else max(self.hi, v)

    def to_value(self):
        """Exported form: {value, hi} (None when never set)."""
        return {"value": self.value, "hi": self.hi}


class Histogram:
    """Fixed-bucket histogram with exact inf accounting.

    ``bounds`` are ascending upper edges; bucket i counts values
    ``<= bounds[i]`` (first matching edge), with one overflow bucket for
    values above the last edge.  +inf recordings are tracked separately
    (``n_inf``) so `percentile` can propagate them exactly: a rank landing
    in the inf tail returns +inf, one landing in finite overflow returns
    the largest finite value seen (never a made-up edge).  Merging two
    histograms requires identical bounds and is plain vector addition.
    """

    def __init__(self, name: str, bounds=DEFAULT_MS_BUCKETS):
        self.name = name
        self.bounds = tuple(float(b) for b in bounds)
        assert all(a < b for a, b in zip(self.bounds, self.bounds[1:])), \
            "histogram bounds must be strictly ascending"
        self.counts = [0] * (len(self.bounds) + 1)   # [+overflow]
        self.n = 0
        self.n_inf = 0
        self.sum = 0.0          # finite mass only
        self.min: float | None = None                # finite extrema
        self.max: float | None = None

    def record(self, v) -> None:
        """Record one value (scrubbed number; +inf allowed, NaN is not)."""
        v = float(scrub(v, where=self.name))
        assert not math.isnan(v), f"NaN recorded into {self.name}"
        self.n += 1
        if math.isinf(v):
            self.n_inf += 1
            self.counts[-1] += 1
            return
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        idx = int(np.searchsorted(self.bounds, v, side="left"))
        self.counts[idx] += 1

    def percentile(self, q: float) -> float:
        """Bucketed percentile under the shared order-statistic rank rule.

        Returns the upper edge of the bucket the rank lands in; +inf when
        the rank falls inside the recorded-inf tail (same propagation as
        the exact `percentile`); the largest finite recorded value when it
        lands in finite overflow; 0.0 when empty.
        """
        if self.n == 0:
            return 0.0
        k = _rank(self.n, q)
        if k >= self.n - self.n_inf:
            return float("inf")
        seen = 0
        for i, c in enumerate(self.counts[:-1]):
            seen += c
            if k < seen:
                return self.bounds[i]
        return self.max if self.max is not None else float("inf")

    def merge_from(self, other: "Histogram") -> None:
        """Fold `other` (same name and bounds) into this histogram."""
        assert self.bounds == other.bounds, (self.name, "bucket mismatch")
        self.counts = [a + b for a, b in zip(self.counts, other.counts)]
        self.n += other.n
        self.n_inf += other.n_inf
        self.sum += other.sum
        for attr in ("min", "max"):
            mine, theirs = getattr(self, attr), getattr(other, attr)
            pick = min if attr == "min" else max
            setattr(self, attr, theirs if mine is None else
                    (mine if theirs is None else pick(mine, theirs)))

    def to_value(self):
        """Exported form: bounds, counts, n/sum/extrema, p50/p99."""
        return {
            "bounds": list(self.bounds),
            "counts": list(self.counts),
            "n": self.n, "n_inf": self.n_inf,
            "sum": round(self.sum, 6),
            "min": self.min, "max": self.max,
            "p50": self.percentile(50), "p99": self.percentile(99),
        }


class MetricsRegistry:
    """Named counters/gauges/histograms with an associative shard merge.

    `counter`/`gauge`/`histogram` create-or-return by name (a histogram's
    bounds are fixed by its first creation).  `merge` builds a NEW registry
    folding both operands — a pure, associative operation, so per-shard
    registries reduce in any tree shape to the identical fleet view.
    """

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def counter(self, name: str) -> Counter:
        """The counter `name`, created on first use."""
        return self._get(name, Counter, lambda: Counter(name))

    def gauge(self, name: str) -> Gauge:
        """The gauge `name`, created on first use."""
        return self._get(name, Gauge, lambda: Gauge(name))

    def histogram(self, name: str, bounds=DEFAULT_MS_BUCKETS) -> Histogram:
        """The histogram `name`; `bounds` only applies on first creation."""
        return self._get(name, Histogram, lambda: Histogram(name, bounds))

    def _get(self, name, cls, build):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = build()
        assert isinstance(m, cls), f"{name} already registered as {type(m)}"
        return m

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """A new registry = self ⊕ other (associative, operands untouched)."""
        out = MetricsRegistry()
        for src in (self, other):
            for name, m in src._metrics.items():
                if isinstance(m, Counter):
                    out.counter(name).value += m.value
                elif isinstance(m, Gauge):
                    g = out.gauge(name)
                    for attr in ("value", "hi"):
                        mine, theirs = getattr(g, attr), getattr(m, attr)
                        setattr(g, attr, theirs if mine is None else
                                (mine if theirs is None
                                 else max(mine, theirs)))
                else:
                    out.histogram(name, m.bounds).merge_from(m)
        return out

    def to_dict(self) -> dict:
        """Deterministic (name-sorted) export of every metric's value."""
        return {name: self._metrics[name].to_value()
                for name in sorted(self._metrics)}
