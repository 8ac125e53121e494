"""Bounded span ring: the capture substrate for the timeline export.

Counterpart of ``mxtpu/obs/trace.py``.

Telemetry spans already carry wall-clock endpoints and correlated
trace/span/parent ids (telemetry/tracing.py); the flight recorder keeps
instantaneous events. What was missing for a scrubbable timeline is a
bounded record of *finished spans with their endpoints* — the
``span_ms`` histogram folds the timing away, and the flight ring only
mirrors start/end as instants. This module closes the gap with a
FlightRecorder-shaped ring fed by the ``tracing.set_span_sink`` hook:

  * lock-free: one atomic ``itertools.count`` draw + one slot
    assignment per finished span (same idiom, and same safety argument,
    as ``diagnostics.flight.FlightRecorder`` — a slot is replaced
    atomically, never mutated, so readers always see whole records);
  * bounded: ``MXTPU_TRACE_CAP`` slots (default 4096), oldest spans
    overwritten — capture cost is O(1) per span and O(cap) memory,
  * gated: ``MXTPU_TRACE=0`` never installs the sink, so the disabled
    cost is the existing one-global-read in ``Span.__exit__``.

``trace_export`` reads this ring (plus the flight ring and thread
names) into Chrome trace-event JSON.
"""
from __future__ import annotations

import itertools
import os
import threading

from ..telemetry import tracing as _tracing

__all__ = ["SpanRing", "ring", "install", "set_trace_enabled",
           "trace_enabled"]

_DEFAULT_CAP = 4096


class SpanRing:
    """Fixed-size, lock-free ring of finished-span tuples."""

    def __init__(self, capacity=_DEFAULT_CAP):
        self.capacity = max(16, int(capacity))
        self._slots = [None] * self.capacity
        self._idx = itertools.count()  # .__next__ is atomic (CPython)

    def record(self, span):
        """The span sink: called from ``Span.__exit__`` on every finished
        span. Must stay allocation-light (it runs once a span)."""
        i = next(self._idx)
        self._slots[i % self.capacity] = (
            i, span.name, span.category, span.t0_us, span.t1_us,
            span.span_id, span.parent_id, span.trace_id,
            threading.get_ident(), span.tags or None)

    def __len__(self):
        return sum(1 for r in self._slots if r is not None)

    def snapshot(self, limit=None):
        """Oldest-first list of span dicts (the exporter's input)."""
        rows = [r for r in self._slots if r is not None]
        rows.sort(key=lambda r: r[0])
        if limit is not None:
            rows = rows[-int(limit):]
        return [
            {"seq": r[0], "name": r[1], "category": r[2], "t0_us": r[3],
             "t1_us": r[4], "span_id": r[5], "parent_id": r[6],
             "trace_id": r[7], "thread": r[8], "tags": r[9]}
            for r in rows]

    def clear(self):
        self._slots = [None] * self.capacity


_RING = None


def ring():
    """The installed span ring (None when tracing capture is off)."""
    return _RING


def trace_enabled():
    return _RING is not None and _tracing._sink is not None


def install(capacity=None):
    """Create the ring (once) and point tracing's span sink at it.
    ``MXTPU_TRACE=0`` declines. Idempotent; returns the ring or None."""
    global _RING
    if os.environ.get("MXTPU_TRACE", "1") == "0":
        return None
    if _RING is None:
        if capacity is None:
            try:
                capacity = int(os.environ.get("MXTPU_TRACE_CAP",
                                              str(_DEFAULT_CAP)))
            except ValueError:
                capacity = _DEFAULT_CAP
        _RING = SpanRing(capacity)
    _tracing.set_span_sink(_RING.record)
    return _RING


def set_trace_enabled(flag):
    """Runtime toggle riding ``diagnostics.set_enabled`` — disabling
    unhooks the sink (zero per-span cost) but keeps the captured ring
    readable."""
    if flag:
        install()
    else:
        _tracing.set_span_sink(None)


install()
