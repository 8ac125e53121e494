"""Serving observability: a thin adapter over ``mxtpu_torch.telemetry``.

Counterpart of ``mxtpu/serving/metrics.py``. The metric types and
registry live in ``telemetry`` (shared with the engine, executor,
Module.fit, kvstore and io instrumentation); this module keeps the
serving-flavored surface on top:

  * the class names (``Counter``/``Gauge``/``Histogram``/
    ``MetricsRegistry``) keep importing from ``mxtpu_torch.serving``;
  * ``MetricsRegistry.to_dict`` keeps its flat JSON shape — raw series
    plus the derived operator numbers (qps, batch-fill ratio, executor
    cache hit rate, shed rate) and ``*_ms`` percentile keys — the
    contract of the HTTP ``/v1/metrics`` endpoint;
  * ``span`` opens a correlated telemetry span (trace ids flow request
    -> batch -> pool.run -> executor), mirrored into the
    chrome://tracing profiler dump while the profiler runs;
  * the registry renders as Prometheus text under the
    ``mxtpu_serving_*`` namespace via the shared exposition layer, with
    derived qps / hit-rate / latency-percentile gauges appended.

Histograms are fixed-bucket (O(1) memory): percentiles are interpolated
over all observations inside the covering bucket.
"""
from __future__ import annotations

from .. import telemetry as _tel
from ..telemetry import Counter, Gauge, Histogram  # re-export
from ..telemetry.metrics import MetricsRegistry as _BaseRegistry

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


class MetricsRegistry(_BaseRegistry):
    """Named metrics + correlated span emission for one serving session.

    ``namespace`` prefixes the Prometheus series and keys the merged
    ``json_snapshot``; mxtpu's DecodeSession riding the same HTTP server as
    a predict session uses ``mxtpu_decode`` so the two registries' shared
    series names (queue_depth, requests_*, ...) never collide in one
    scrape."""

    def __init__(self, namespace="mxtpu_serving"):
        super().__init__(namespace=namespace)

    def span(self, name, category="serving"):
        """Correlated trace-span context manager: nests under the ambient
        span (cross-thread parents via ``telemetry.current_span()``), is
        mirrored into the chrome://tracing dump while the profiler runs
        (``profiler.set_state('run')``), and lands in the process-wide
        ``span_ms{span=...}`` histogram."""
        return _tel.span(name, category=category)

    # ---------------------------------------------------------- derived
    def _sum_counters(self, name):
        """Sum a counter across its label values (requests_shed carries
        a ``reason`` label; the flat contract wants the total)."""
        return sum(m.value for m in self.series()
                   if isinstance(m, Counter) and m.name == name)

    def _derived(self):
        reqs = self.counter("requests_completed").value
        uptime = self.uptime
        out = {"qps": round(reqs / uptime, 3) if uptime > 0 else 0.0}
        padded = self.counter("batch_rows_padded").value
        valid = self.counter("batch_rows_valid").value
        total = padded + valid
        out["batch_fill_ratio"] = round(valid / total, 4) if total else 0.0
        hits = self.counter("executor_cache_hits").value
        misses = self.counter("executor_cache_misses").value
        probes = hits + misses
        out["executor_cache_hit_rate"] = \
            round(hits / probes, 4) if probes else 0.0
        received = self.counter("requests_received").value
        shed = self._sum_counters("requests_shed")
        out["shed_rate"] = round(shed / received, 4) if received else 0.0
        return out

    def extra_series(self):
        """Prometheus-side derived gauges: the operator numbers plus
        p50/p90/p99 for every histogram (``<name>_p99`` series — the
        acceptance surface a dashboard alerts on without running
        histogram_quantile)."""
        out = [(k, None, v) for k, v in self._derived().items()]
        for m in self.series():
            if isinstance(m, Histogram):
                for p in (50, 90, 99):
                    out.append(("%s_p%d" % (m.name, p), m.labels,
                                round(m.percentile(p), 4)))
        return out

    def to_dict(self):
        """JSON-ready snapshot (the ``/v1/metrics`` contract): raw series
        flat, histograms as ``*_ms``-keyed percentile dicts, derived
        rates computed here so the raw metrics stay single-writer.
        Labeled series key as ``name{k=v}`` (base-registry convention —
        two ``requests_shed`` reasons must not clobber one key)."""
        out = {"uptime_sec": round(self.uptime, 3)}
        for m in self.series():
            key = m.name
            if m.labels:
                key += "{%s}" % ",".join(
                    "%s=%s" % kv for kv in sorted(m.labels.items()))
            if isinstance(m, Histogram):
                out[key] = {
                    "count": m.count,
                    "mean_ms": round(m.mean, 3),
                    "p50_ms": round(m.percentile(50), 3),
                    "p90_ms": round(m.percentile(90), 3),
                    "p99_ms": round(m.percentile(99), 3),
                }
            else:
                out[key] = m.value
        out.update(self._derived())
        return out
