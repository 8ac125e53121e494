"""Serving metrics: counters and latency histograms for one session.

Counterpart of ``mxtpu/serving/metrics.py``, without the telemetry
pipeline it adapts (spans, Prometheus exposition): those arrive with the
port of ``mxtpu/telemetry``. ``to_dict`` keeps the flat ``/v1/metrics``
shape for the series it has.
"""
from __future__ import annotations

import collections
import threading
import time

import numpy as _np

__all__ = ["Counter", "Histogram", "MetricsRegistry"]


class Counter:
    def __init__(self, name):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n=1):
        with self._lock:
            self.value += n


class Histogram:
    """Percentiles over the most recent ``WINDOW`` observations (memory
    stays bounded in a long-running server; the fixed-bucket form comes
    with the telemetry port). ``count`` is the lifetime total."""

    WINDOW = 4096

    def __init__(self, name):
        self.name = name
        self._values = collections.deque(maxlen=self.WINDOW)
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, v):
        with self._lock:
            self._values.append(float(v))
            self.count += 1

    def percentile(self, p):
        with self._lock:
            vals = list(self._values)
        return float(_np.percentile(vals, p)) if vals else 0.0

    @property
    def mean(self):
        with self._lock:
            vals = list(self._values)
        return float(_np.mean(vals)) if vals else 0.0


class MetricsRegistry:
    """Named counters and histograms, created on first use."""

    def __init__(self):
        self._series = {}
        self._lock = threading.Lock()
        self._t0 = time.monotonic()

    def _get(self, cls, name):
        with self._lock:
            m = self._series.get(name)
            if m is None:
                m = self._series[name] = cls(name)
            return m

    def counter(self, name):
        return self._get(Counter, name)

    def histogram(self, name):
        return self._get(Histogram, name)

    @property
    def uptime(self):
        return time.monotonic() - self._t0

    def to_dict(self):
        out = {"uptime_sec": round(self.uptime, 3)}
        with self._lock:
            series = list(self._series.values())
        for m in series:
            if isinstance(m, Histogram):
                out[m.name] = {"count": m.count,
                               "mean_ms": round(m.mean, 3),
                               "p50_ms": round(m.percentile(50), 3),
                               "p90_ms": round(m.percentile(90), 3),
                               "p99_ms": round(m.percentile(99), 3)}
            else:
                out[m.name] = m.value
        done = self.counter("requests_completed").value
        out["qps"] = round(done / self.uptime, 3) if self.uptime > 0 else 0.0
        return out
