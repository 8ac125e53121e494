"""Correlated tracing: span IDs flowing across threads and subsystems.

Every ``span()`` gets a process-unique ``span_id``, inherits the ambient
span as ``parent_id`` (contextvar — survives generators and nested
calls), and carries the root's ``trace_id``. Cross-thread hops — engine
``push`` -> native worker dispatch, serving ``submit`` -> dispatcher
batch — capture the submitting span with ``current_span()`` and restore
it on the far side with ``parent=``, so one trace id threads engine push
-> executor run -> kvstore push/pull -> serving request.

Spans are emitted on exit into every armed sink:
  * into ``mxtpu_torch.profiler`` as a chrome://tracing event whose ``args``
    carry trace/span/parent ids (only while the profiler runs);
  * into the telemetry registry as an observation on the labeled
    histogram ``span_ms{span=<name>}`` (always, unless telemetry is
    disabled) — the substrate for the profiler's aggregate_stats tables
    and for Prometheus latency series without a profiler session;
  * into a span sink installed with ``set_span_sink`` (none by
    default: mxtpu's ``obs`` span ring is where mxtpu installs one).
"""
from __future__ import annotations

import contextvars
import itertools
import time

__all__ = ["Span", "span", "current_span", "trace_id"]

_ids = itertools.count(1)  # itertools.count.__next__ is atomic (CPython)
_current = contextvars.ContextVar("mxtpu_telemetry_span", default=None)

# flight-recorder hook (mxtpu_torch.diagnostics.flight): every span start/end
# also lands in the lock-free event ring, so a postmortem shows what the
# process was doing just before a wedge. One global read per span when
# unset; set_flight_recorder is called by the diagnostics package.
_flight = None

# span-sink hook (a timeline exporter): every FINISHED span — with its
# wall-clock endpoints and correlation ids — lands in the bounded span
# ring the timeline exporter reads. Same one-global-read-when-unset
# contract as the flight hook; set_span_sink is called by the exporter.
_sink = None


def set_flight_recorder(rec):
    global _flight
    _flight = rec


def set_span_sink(fn):
    """Install ``fn(span)`` to receive every finished span (None
    unhooks). The callee must be lock-free and allocation-light — it
    runs inside ``Span.__exit__`` on every instrumented region."""
    global _sink
    _sink = fn


class Span:
    """One timed region. Use via the ``span()`` context manager."""

    __slots__ = ("name", "category", "span_id", "parent_id", "trace_id",
                 "tags", "t0_us", "t1_us", "_token", "_t0_perf")

    def __init__(self, name, category="default", parent=None, tags=None):
        self.name = name
        self.category = category
        self.span_id = next(_ids)
        if parent is not None:
            self.parent_id = parent.span_id
            self.trace_id = parent.trace_id
        else:
            self.parent_id = 0
            self.trace_id = self.span_id
        self.tags = tags or {}
        self.t0_us = self.t1_us = 0.0
        self._token = None

    @property
    def duration_ms(self):
        return (self.t1_us - self.t0_us) / 1e3

    def __enter__(self):
        self._token = _current.set(self)
        # wall-clock timestamps: the profiler's op spans use time.time(),
        # and both span families must share one chrome://tracing timebase.
        # Durations still come from the monotonic clock (an NTP step must
        # not produce negative latencies).
        self.t0_us = time.time() * 1e6
        self._t0_perf = time.perf_counter()
        f = _flight
        if f is not None:
            f.record("span_start", self.name, self.span_id)
        return self

    def __exit__(self, *exc):
        self.t1_us = self.t0_us + (time.perf_counter() -
                                   self._t0_perf) * 1e6
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        f = _flight
        if f is not None:
            f.record("span_end", self.name,
                     "%d %.3fms" % (self.span_id, self.duration_ms))
        k = _sink
        if k is not None:
            k(self)
        self._emit()
        return False

    def _emit(self):
        from . import _emit_span  # late: avoids import cycle at module load
        _emit_span(self)

    def __repr__(self):
        return "Span(%s id=%d parent=%d trace=%d)" % (
            self.name, self.span_id, self.parent_id, self.trace_id)


class _NullSpan:
    """No-op stand-in returned while telemetry is disabled."""

    span_id = parent_id = trace_id = 0
    duration_ms = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


def span(name, category="default", parent=None, tags=None):
    """Open a correlated span. ``parent`` overrides the ambient span —
    pass a captured ``current_span()`` when crossing a thread boundary;
    by default the span nests under whatever is ambient on THIS thread.

    Returns a no-op span only when BOTH sinks are off: telemetry disabled
    AND no profiler session running — an explicitly started profiler
    keeps receiving trace spans under ``MXTPU_TELEMETRY=0``."""
    from . import enabled, _profiler_running
    if not enabled() and not _profiler_running():
        return _NULL
    if parent is None:
        parent = _current.get()
    return Span(name, category=category, parent=parent, tags=tags)


def current_span():
    """The ambient span on this thread/context (None outside any span).
    Capture it before handing work to another thread, then pass it as
    ``span(..., parent=captured)`` on the far side."""
    return _current.get()


def trace_id():
    """Trace id of the ambient span, 0 when outside any span."""
    s = _current.get()
    return s.trace_id if s is not None else 0
