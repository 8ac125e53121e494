"""Flight recorder: a lock-free ring of recent runtime events.

Counterpart of ``mxtpu/diagnostics/flight.py``.

When a session wedges, the question is "what was it doing just before?"
— and the answer must be readable from a signal handler or a watchdog
thread without taking any lock a stuck thread might hold. The ring is a
fixed-size list indexed by an ``itertools.count`` (whose ``__next__`` is
atomic under the GIL): a write is one counter bump plus one slot
assignment, never blocks, and costs well under a microsecond.

Events come from the span layer (every telemetry span start/end — fit
steps, executor forwards, engine dispatches, serving requests), from the
engine's push seam, and from anything else that calls ``record()``.
``snapshot()`` reassembles the surviving slots in order; a torn slot
(written concurrently with the read) at worst drops one event — the
recorder trades perfect reads for never perturbing the recorded.
"""
from __future__ import annotations

import itertools
import os
import threading
import time

__all__ = ["FlightRecorder", "recorder", "record", "flight_enabled",
           "set_flight_enabled"]

DEFAULT_CAPACITY = int(os.environ.get("MXTPU_DIAG_FLIGHT_CAP", "512"))


class FlightRecorder:
    """Fixed-capacity event ring; writers never block."""

    def __init__(self, capacity=DEFAULT_CAPACITY):
        self.capacity = max(8, int(capacity))
        self._ring = [None] * self.capacity
        self._idx = itertools.count()
        self._last = -1

    def record(self, kind, name, detail=None):
        """One event: (seq, wall-time, thread, kind, name, detail)."""
        i = next(self._idx)            # atomic (CPython)
        self._ring[i % self.capacity] = (
            i, time.time(), threading.get_ident(), kind, name, detail)
        self._last = i                 # benign race: approximate is fine

    @property
    def events_recorded(self):
        return self._last + 1

    def snapshot(self, limit=None):
        """Recent events, oldest first, as JSON-ready dicts."""
        entries = [e for e in list(self._ring) if e is not None]
        entries.sort(key=lambda e: e[0])
        if limit:
            entries = entries[-int(limit):]
        return [{"seq": e[0], "time": round(e[1], 6), "thread": e[2],
                 "kind": e[3], "name": e[4],
                 "detail": e[5] if isinstance(
                     e[5], (str, int, float, type(None))) else str(e[5])}
                for e in entries]

    def clear(self):
        self._ring = [None] * self.capacity


_RECORDER = FlightRecorder() \
    if os.environ.get("MXTPU_DIAG_FLIGHT", "1") != "0" else None


def recorder():
    """The process-wide recorder (None while disabled)."""
    return _RECORDER


def flight_enabled():
    return _RECORDER is not None


def set_flight_enabled(flag):
    """Runtime toggle (bench harness). Disabling drops the ring;
    re-enabling starts an empty one."""
    global _RECORDER
    if flag and _RECORDER is None:
        _RECORDER = FlightRecorder()
    elif not flag:
        _RECORDER = None
    _rewire()


def record(kind, name, detail=None):
    """Module-level convenience: record into the process ring, if any."""
    r = _RECORDER
    if r is not None:
        r.record(kind, name, detail)


def _rewire():
    """Point the span layer's fast-path hook at the current recorder."""
    from ..telemetry import tracing as _tracing
    _tracing.set_flight_recorder(_RECORDER)


_rewire()
