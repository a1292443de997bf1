"""The privacy audit boundary: a typed allowlist for telemetry values.

A copy of ``repro/obs/scrub.py`` (numpy only), whose vocabulary also admits
the port's kernel routes ``torch`` and ``cuda``.

PIR's whole point is that the server learns nothing about queries, so the
observability layer must be *provably metadata-only*: sizes, timings,
epochs, shard ids — never query vectors, LWE ciphertexts, selection
one-hots, bucket probe patterns, or decoded plaintexts.  Rather than audit
every export after the fact, `scrub` enforces the property at RECORD time:
every span attribute and every metric value passes through it, and anything
outside the allowlist raises `PrivacyViolation` immediately (in the test
suite and in production alike — a trace export is safe to ship off-box by
construction, not by review).

Allowed:
  * ``bool`` / ``int`` / ``float`` and their NumPy scalar equivalents
    (coerced to plain Python so no array machinery leaks into exports) —
    this covers timings, byte counts, epochs, shard/request/session ids;
  * ``str`` values that are REGISTERED enum members (`register_enum`) —
    engine names, outcome labels, commit kinds.  Free-form strings are
    rejected: a string that did not come from a code-side vocabulary could
    carry a decoded document fragment.

Rejected (always): ``bytes``/``bytearray``, ``np.ndarray`` and any other
array type (torch.Tensor included via the catch-all), containers, ``None``,
and arbitrary objects.  There is deliberately no escape hatch.
"""
from __future__ import annotations

import numbers

import numpy as np


class PrivacyViolation(TypeError):
    """A telemetry value fell outside the metadata-only allowlist."""

    def __init__(self, value, where: str = ""):
        loc = f" at {where!r}" if where else ""
        super().__init__(
            f"obs value of type {type(value).__name__}{loc} is not "
            "allowlisted telemetry (numbers, registered enums only) — "
            "array/bytes/str payloads could carry query-derived data")


#: Registered enum vocabulary: the only strings telemetry may carry.
_ENUM_VOCAB: set[str] = set()


def register_enum(*values: str) -> None:
    """Admit code-side enum strings (engine names, outcomes) to telemetry.

    Call at import time with literal values; registering data-derived
    strings would defeat the gate, so callers must only pass constants.
    """
    for v in values:
        assert isinstance(v, str), v
        _ENUM_VOCAB.add(v)


# The repo-wide vocabulary.  Everything here is a code literal; none of
# these can encode a query, a probe pattern, or a plaintext.
register_enum(
    "sync", "pipelined",            # serve engines
    "served", "shed", "failed",     # request outcomes (traffic.slo)
    "delta", "full",                # commit / hint-patch kinds
    "xla", "pallas", "auto",        # kernel impl dispatch
    "torch", "cuda",                # (the port's routes)
    "query", "lookup",              # request kinds (serve/traffic)
    "healthy", "suspect", "down",   # fleet device/replica health states
    "recovering",                   # (the fleet's replica states)
)


def scrub(value, *, where: str = ""):
    """Pass `value` through the telemetry allowlist or raise.

    Returns the value coerced to a plain Python ``bool``/``int``/``float``
    (or the registered enum ``str``).  ``where`` names the metric/attr for
    the error message only — it never changes the decision.
    """
    # bool first: it subclasses int and should stay a bool in exports
    if isinstance(value, (bool, np.bool_)):
        return bool(value)
    if isinstance(value, (int, np.integer)):
        return int(value)
    if isinstance(value, (float, np.floating)):
        return float(value)
    if isinstance(value, str):
        if value in _ENUM_VOCAB:
            return value
        raise PrivacyViolation(value, where)
    if isinstance(value, numbers.Number) and not isinstance(value, complex):
        return float(value)
    raise PrivacyViolation(value, where)
