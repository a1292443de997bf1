"""Nested spans with explicit parent ids + Chrome-trace/Perfetto export.

`Tracer.span(name, **attrs)` opens a span as a context manager; spans nest
by stack discipline, each one carrying a sequential id and its parent's id,
so the exported tree is DETERMINISTIC under a FakeClock — same schedule,
same ids, same nesting, byte-identical export.  A tracer built with
``keep=False`` still timestamps every span (the serving engines derive
`BatchTiming` from span boundaries, traced or not) but retains nothing:
the per-span cost collapses to two clock reads, which is what keeps default
serving within the <2% instrumentation budget.

Every attribute value passes the `scrub` privacy gate at record time —
see `repro_torch.obs.scrub` — so an export can be shipped off-box without a
redaction pass.

The export is the Chrome Trace Event Format (the JSON both
``chrome://tracing`` and https://ui.perfetto.dev load directly): complete
events (``ph: "X"``) for spans, instant events (``ph: "i"``) for
point-in-time markers, timestamps in microseconds.  `validate_chrome_trace`
structurally checks an export (the CI gate re-checks the privacy allowlist
on every ``args`` value too — `scripts/check_trace.py`).

Kernel regions: `kernel_annotation(name)` returns a
`torch.profiler.record_function` context only while
`enable_kernel_annotations(True)` is in effect, and a shared no-op context
otherwise — the kernel dispatch in `repro_torch.kernels.ops` wears it with
zero overhead when disabled (one global-bool check, no profiler import).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Callable

from repro_torch.obs.scrub import scrub


@dataclasses.dataclass
class Span:
    """One timed region: name, id, parent id, [t0, t1), scrubbed attrs."""
    name: str
    sid: int
    parent: int | None
    t0: float
    t1: float | None = None
    attrs: dict = dataclasses.field(default_factory=dict)
    _tracer: "Tracer | None" = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def dur(self) -> float:
        """Span duration in seconds (0.0 while still open)."""
        return 0.0 if self.t1 is None else self.t1 - self.t0

    def set(self, **attrs) -> "Span":
        """Attach scrubbed attributes (numbers / registered enums only)."""
        for k, v in attrs.items():
            self.attrs[k] = scrub(v, where=f"{self.name}.{k}")
        return self

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        tracer = self._tracer
        assert tracer is not None, "span already closed"
        self.t1 = tracer.clock()
        self._tracer = None
        tracer._close(self)


class Tracer:
    """Span factory + store; ``keep=False`` times spans without retaining.

    ``clock`` must be the same clock the instrumented component uses (the
    serve loops pass theirs through), so FakeClock tests stay deterministic
    and `BatchTiming` derived from span boundaries matches the engine's
    own timeline.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter, *,
                 keep: bool = True):
        self.clock = clock
        self.keep = keep
        self.spans: list[Span] = []      # finished spans, completion order
        self.instants: list[Span] = []   # zero-duration markers
        self._stack: list[int] = []      # open span ids (nesting)
        self._next_sid = 0

    def span(self, name: str, **attrs) -> Span:
        """Open a nested span (use as a context manager)."""
        sid, self._next_sid = self._next_sid, self._next_sid + 1
        sp = Span(name=name, sid=sid,
                  parent=self._stack[-1] if self._stack else None,
                  t0=self.clock(), _tracer=self)
        if attrs:
            sp.set(**attrs)
        self._stack.append(sid)
        return sp

    def _close(self, sp: Span) -> None:
        # stack discipline normally makes sp the top; be defensive about
        # exception paths that unwound an inner span out of order
        if self._stack and self._stack[-1] == sp.sid:
            self._stack.pop()
        else:                                       # pragma: no cover
            self._stack = [s for s in self._stack if s != sp.sid]
        if self.keep:
            self.spans.append(sp)

    def instant(self, name: str, **attrs) -> None:
        """Record a point-in-time event (dropped when ``keep=False``)."""
        if not self.keep:
            return
        sid, self._next_sid = self._next_sid, self._next_sid + 1
        sp = Span(name=name, sid=sid,
                  parent=self._stack[-1] if self._stack else None,
                  t0=self.clock())
        sp.t1 = sp.t0
        if attrs:
            sp.set(**attrs)
        self.instants.append(sp)

    # -- export ---------------------------------------------------------------

    def to_chrome(self) -> dict:
        """The trace as a Chrome Trace Event Format dict (ts/dur in µs)."""
        events = []
        for sp in self.spans:
            events.append({
                "name": sp.name, "ph": "X", "pid": 0, "tid": 0,
                "ts": round(sp.t0 * 1e6, 3),
                "dur": round(max(sp.dur, 0.0) * 1e6, 3),
                "args": {"sid": sp.sid,
                         "parent": -1 if sp.parent is None else sp.parent,
                         **sp.attrs},
            })
        for sp in self.instants:
            events.append({
                "name": sp.name, "ph": "i", "s": "t", "pid": 0, "tid": 0,
                "ts": round(sp.t0 * 1e6, 3),
                "args": {"sid": sp.sid,
                         "parent": -1 if sp.parent is None else sp.parent,
                         **sp.attrs},
            })
        events.sort(key=lambda e: (e["ts"], e["args"]["sid"]))
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome(self, path: str) -> dict:
        """Write the Chrome-trace JSON to `path`; returns the dict."""
        obj = self.to_chrome()
        with open(path, "w") as f:
            json.dump(obj, f, indent=1)
        return obj


def span_coverage(spans: list[Span], *, roots_only: bool = True) -> float:
    """Fraction of [first start, last end] covered by the spans' union.

    With ``roots_only`` (the default) only parentless spans count — the
    engine's tick/drain roots — so nested spans can't double-cover.  This
    is the acceptance metric for "spans cover ≥95% of wall time": the gap
    is exactly the time the instrumented component was NOT inside any root
    span.
    """
    closed = [s for s in spans if s.t1 is not None
              and (s.parent is None or not roots_only)]
    if not closed:
        return 0.0
    t_lo = min(s.t0 for s in closed)
    t_hi = max(s.t1 for s in closed)
    if t_hi <= t_lo:
        return 1.0
    covered, cur_lo, cur_hi = 0.0, None, None
    for s in sorted(closed, key=lambda s: s.t0):
        if cur_hi is None or s.t0 > cur_hi:
            covered += 0.0 if cur_hi is None else cur_hi - cur_lo
            cur_lo, cur_hi = s.t0, s.t1
        else:
            cur_hi = max(cur_hi, s.t1)
    covered += cur_hi - cur_lo
    return covered / (t_hi - t_lo)


def validate_chrome_trace(obj) -> list[str]:
    """Structural check of a Chrome-trace export; returns error strings.

    The CI gate (`scripts/check_trace.py`) layers the checked-in JSON
    schema and the privacy allowlist re-scan on top of this.
    """
    errs: list[str] = []
    if not isinstance(obj, dict):
        return ["top level must be an object"]
    ev = obj.get("traceEvents")
    if not isinstance(ev, list):
        return ["traceEvents must be a list"]
    for i, e in enumerate(ev):
        if not isinstance(e, dict):
            errs.append(f"event {i}: not an object")
            continue
        for key, typ in (("name", str), ("ph", str)):
            if not isinstance(e.get(key), typ):
                errs.append(f"event {i}: bad {key!r}")
        if not isinstance(e.get("ts"), (int, float)):
            errs.append(f"event {i}: bad 'ts'")
        if e.get("ph") == "X" and not isinstance(e.get("dur"), (int, float)):
            errs.append(f"event {i}: complete event missing 'dur'")
        if e.get("ph") not in ("X", "i", "M"):
            errs.append(f"event {i}: unknown phase {e.get('ph')!r}")
    return errs


# -- kernel-region annotations (zero overhead when disabled) -----------------

_KERNEL_ANNOTATIONS = False
_NULL_CTX = contextlib.nullcontext()


def enable_kernel_annotations(on: bool = True) -> None:
    """Toggle `torch.profiler.record_function` wrapping of kernel regions.

    Off (the default), `kernel_annotation` returns a shared no-op context:
    the hot path pays one global-bool check and nothing else.  On, kernel
    dispatches in `repro_torch.kernels.ops` appear as named regions in
    torch.profiler traces (Chrome trace / Perfetto).
    """
    global _KERNEL_ANNOTATIONS
    _KERNEL_ANNOTATIONS = bool(on)


def kernel_annotations_enabled() -> bool:
    """Whether kernel-region profiler annotations are currently on."""
    return _KERNEL_ANNOTATIONS


def kernel_annotation(name: str):
    """Context manager naming a kernel region (no-op unless enabled)."""
    if not _KERNEL_ANNOTATIONS:
        return _NULL_CTX
    from torch.profiler import record_function
    return record_function(name)
