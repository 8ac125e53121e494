"""mxtpu_torch.telemetry — framework-wide metrics, correlated tracing,
exposition.

Counterpart of ``mxtpu/telemetry``: the same registry namespace
(``"mxtpu"``), series names and exposition text, so one scrape config
reads either package.

One instrumentation layer for training AND serving (ROADMAP north star:
production traffic needs one pipeline, not per-subsystem ad-hoc logging):

  * ``metrics``    — thread-safe Counter / Gauge / Histogram (fixed-bucket
                     p50/p90/p99) in a process-wide labeled registry
  * ``tracing``    — span IDs flowing engine push -> executor run ->
                     kvstore push/pull -> serving request, emitted into
                     the chrome://tracing profiler AND the registry
  * ``exposition`` — Prometheus text + JSON, served from the serving HTTP
                     server at ``/metrics`` or dumped standalone

Hot-path call sites go through the module-level helpers (``counter()``,
``histogram()``, ``span()``...) which respect ``set_enabled(False)`` /
``MXTPU_TELEMETRY=0`` — disabled, every helper is a cheap no-op so the
bench harness can measure instrumentation overhead honestly.

The pipelined ``Module.fit`` (docs/training_pipeline.md) splits its
timing so async dispatch keeps the series honest: ``fit_dispatch_ms``
is the host cost of ISSUING a step, ``fit_step_ms`` adds the bounded
in-flight pacing wait (``fit_sync_wait_ms``), and ``fit_metric_sync_ms``
is the cadence device->host metric snapshot — with a healthy pipeline
``fit_step_ms ≈ fit_dispatch_ms`` and ``io_prefetch_stall_ms ≈ 0``.

See docs/observability.md.
"""
from __future__ import annotations

import os as _os

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      DEFAULT_MS_BOUNDS)
from .exposition import (PROMETHEUS_CONTENT_TYPE, dump, json_snapshot,
                         prometheus_text)
from .tracing import Span, current_span, span, trace_id

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "DEFAULT_MS_BOUNDS",
    "prometheus_text", "json_snapshot", "dump", "PROMETHEUS_CONTENT_TYPE",
    "Span", "span", "current_span", "trace_id",
    "registry", "counter", "gauge", "histogram",
    "enabled", "set_enabled",
]

class _DefaultRegistry(MetricsRegistry):
    """The process-wide registry: reset() also drops the span-histogram
    fast-path cache so span_ms series re-register instead of observing
    into orphaned objects."""

    def reset(self):
        super().reset()
        _span_hists.clear()


# the process-wide default registry every built-in instrumentation site
# writes into; serving sessions add their own (namespace mxtpu_serving)
_REGISTRY = _DefaultRegistry(namespace="mxtpu")

_ENABLED = _os.environ.get("MXTPU_TELEMETRY", "1") != "0"

#: span durations also land here as span_ms{span=...} observations
SPAN_HISTOGRAM = "span_ms"


def registry():
    """The process-wide default MetricsRegistry."""
    return _REGISTRY


def enabled():
    return _ENABLED


def set_enabled(flag):
    """Flip the helper-mediated instrumentation on/off at runtime (the
    bench harness; ``MXTPU_TELEMETRY=0`` sets the initial state). Scope:
    ``counter()``/``gauge()``/``histogram()``/``span()`` calls go quiet —
    metric objects already handed out keep working, and call sites that
    resolved a helper to the no-op metric while disabled stay no-ops
    until they re-resolve. The standing engine/executor series bypass
    this flag on purpose (registry-direct): they must exist for a scrape
    even in a process that imported bare."""
    global _ENABLED
    _ENABLED = bool(flag)


class _NullMetric:
    """Absorbs writes when telemetry is disabled."""

    name = "disabled"
    labels = {}
    value = 0
    count = 0
    sum = 0.0
    mean = 0.0

    def inc(self, n=1):
        pass

    def dec(self, n=1):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass

    def percentile(self, p):
        return 0.0


_NULL_METRIC = _NullMetric()


def counter(name, labels=None, help=None):
    if not _ENABLED:
        return _NULL_METRIC
    return _REGISTRY.counter(name, labels=labels, help=help)


def gauge(name, labels=None, fn=None, help=None):
    if not _ENABLED:
        return _NULL_METRIC
    return _REGISTRY.gauge(name, labels=labels, fn=fn, help=help)


def histogram(name, labels=None, bounds=None, help=None):
    if not _ENABLED:
        return _NULL_METRIC
    return _REGISTRY.histogram(name, labels=labels, bounds=bounds, help=help)


_prof_mod = None  # resolved lazily once (profiler imports after telemetry)


def _profiler():
    """The profiler module (imported on first use: it imports telemetry)."""
    global _prof_mod
    if _prof_mod is None:
        from .. import profiler as _prof
        _prof_mod = _prof
    return _prof_mod


def _profiler_running():
    """True while a profiler session is active — spans keep flowing into
    the chrome://tracing dump even with metrics disabled."""
    return _profiler()._state["running"]

_span_hists = {}  # per-name histogram cache: span exit skips the
# registry's (name, labels) key build + lock on the hot path. Plain-dict
# reads are safe under the GIL; a racing first-emit just does the
# registry lookup twice and lands on the same Histogram object.


def _emit_span(s):
    """Called by Span.__exit__: mirror the span into the profiler trace
    (ids in args -> chrome://tracing correlation UI) and fold its duration
    into the registry's labeled span histogram."""
    prof = _profiler()
    if prof._state["running"]:
        prof.record_span(
            s.name, s.t0_us, s.t1_us, category=s.category,
            args={"trace_id": s.trace_id, "span_id": s.span_id,
                  "parent_id": s.parent_id, **s.tags})
    if _ENABLED:
        h = _span_hists.get(s.name)
        if h is None:
            h = _span_hists[s.name] = _REGISTRY.histogram(
                SPAN_HISTOGRAM, labels={"span": s.name})
        h.observe(s.duration_ms)
