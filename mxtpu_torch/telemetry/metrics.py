"""Core metric types: Counter, Gauge, Histogram, and the registry.

One process-wide, thread-safe registry
(``mxtpu_torch.telemetry.registry()``)
holds every series the framework emits — engine, executor, module/fit,
kvstore, io, serving — so training and inference share one observability
pipeline (the role OprExecStat + DumpProfile play for the reference's
engine, widened to the whole system). Design rules:

  * metric objects are cheap singletons per (name, labels) series; hot
    paths hold a reference and call ``inc``/``observe`` — no dict lookup
    per event unless the call site wants labels resolved dynamically;
  * histograms use FIXED log-spaced buckets (Prometheus-style cumulative
    ``le`` export) and derive p50/p90/p99 by interpolating inside the
    bucket that spans the target rank — O(1) memory, no sample ring, so
    an instrumented hot loop never grows;
  * everything is stdlib-only: importable anywhere.
"""
from __future__ import annotations

import threading
import time

# stdlib-light import (analysis/__init__ is lazy): the registry lock is
# part of the declared hierarchy, so it is created tracked
from ..analysis import concurrency as _conc

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_MS_BOUNDS"]

#: default histogram bucket upper bounds, in milliseconds (log-spaced,
#: 0.05ms..10s — covers a kernel span up to a full eval pass)
DEFAULT_MS_BOUNDS = (0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100,
                     250, 500, 1000, 2500, 5000, 10000, float("inf"))


class Counter:
    """Monotonic counter (thread-safe)."""

    __slots__ = ("name", "labels", "help", "_v", "_lock")

    def __init__(self, name, labels=None, help=None):
        self.name = name
        self.labels = labels or {}
        self.help = help
        self._v = 0
        # mxtpu: allow-raw-lock(hottest leaf primitive: one inc per
        # instrumented event; never holds anything else, and the
        # witness's own evidence counters write through it)
        self._lock = threading.Lock()

    def inc(self, n=1):
        with self._lock:
            self._v += n

    @property
    def value(self):
        return self._v


class Gauge:
    """Point-in-time value: set explicitly, adjusted, or read via callback."""

    __slots__ = ("name", "labels", "help", "_v", "_fn", "_lock")

    def __init__(self, name, labels=None, fn=None, help=None):
        self.name = name
        self.labels = labels or {}
        self.help = help
        self._v = 0.0
        self._fn = fn
        # mxtpu: allow-raw-lock(hot leaf primitive — see Counter._lock)
        self._lock = threading.Lock()

    def set(self, v):
        with self._lock:
            self._v = v

    def inc(self, n=1):
        with self._lock:
            self._v += n

    def dec(self, n=1):
        with self._lock:
            self._v -= n

    @property
    def value(self):
        """The callback's value when one is set (a callback that raises
        fails the scrape: a broken reading is never shown as 0)."""
        if self._fn is not None:
            return self._fn()
        return self._v


class Histogram:
    """Fixed-bucket histogram with interpolated percentiles.

    ``observe`` is O(#buckets) worst case with one lock; memory is O(1)
    in the number of observations. ``percentile`` walks the buckets to
    the target rank and interpolates linearly inside the covering bucket,
    clamped to the observed [min, max] — exact at the edges, bucket-width
    accurate in the middle (the classic Prometheus quantile estimate).
    """

    __slots__ = ("name", "labels", "help", "bounds", "bucket_counts",
                 "count", "sum", "min", "max", "_lock")

    def __init__(self, name, bounds=None, labels=None, help=None):
        self.name = name
        self.labels = labels or {}
        self.help = help
        self.bounds = tuple(bounds) if bounds else DEFAULT_MS_BOUNDS
        if self.bounds[-1] != float("inf"):
            self.bounds = self.bounds + (float("inf"),)
        self.bucket_counts = [0] * len(self.bounds)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        # mxtpu: allow-raw-lock(hot leaf primitive — see Counter._lock)
        self._lock = threading.Lock()

    def observe(self, v):
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            for i, b in enumerate(self.bounds):
                if v <= b:
                    self.bucket_counts[i] += 1
                    break

    @property
    def mean(self):
        return self.sum / self.count if self.count else 0.0

    def percentile(self, p):
        """p in [0, 100]; 0.0 when empty."""
        with self._lock:
            n = self.count
            if n == 0:
                return 0.0
            counts = list(self.bucket_counts)
            lo_obs, hi_obs = self.min, self.max
        rank = (p / 100.0) * n
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                if hi == float("inf"):
                    return hi_obs
                frac = (rank - cum) / c
                v = lo + frac * (hi - lo)
                return min(max(v, lo_obs), hi_obs)
            cum += c
        return hi_obs

    def snapshot(self):
        """Consistent (count, sum, min, max, cumulative_counts) tuple."""
        with self._lock:
            cum, out = 0, []
            for c in self.bucket_counts:
                cum += c
                out.append(cum)
            return (self.count, self.sum,
                    self.min if self.count else 0.0,
                    self.max if self.count else 0.0, out)


class MetricsRegistry:
    """Named series store: ``(name, sorted-label-items)`` -> metric.

    ``namespace`` prefixes the Prometheus exposition names
    (``<namespace>_<series>``); JSON keeps raw names.
    """

    def __init__(self, namespace="mxtpu"):
        self.namespace = namespace
        self._series = {}
        self._lock = _conc.lock(type(self).__name__, "_lock")
        self._t0 = time.time()

    @staticmethod
    def _key(name, labels):
        return (name, tuple(sorted((labels or {}).items())))

    def _get(self, name, labels, factory):
        key = self._key(name, labels)
        with self._lock:
            m = self._series.get(key)
            if m is None:
                m = self._series[key] = factory()
            return m

    def counter(self, name, labels=None, help=None):
        return self._get(name, labels,
                         lambda: Counter(name, labels=labels, help=help))

    def gauge(self, name, labels=None, fn=None, help=None):
        g = self._get(name, labels,
                      lambda: Gauge(name, labels=labels, fn=fn, help=help))
        if fn is not None:
            g._fn = fn
        return g

    def histogram(self, name, labels=None, bounds=None, help=None):
        return self._get(name, labels,
                         lambda: Histogram(name, bounds=bounds,
                                           labels=labels, help=help))

    @property
    def uptime(self):
        return time.time() - self._t0

    def series(self):
        """Stable-ordered list of live metric objects."""
        with self._lock:
            items = sorted(self._series.items())
        return [m for _, m in items]

    def extra_series(self):
        """Derived gauges appended at exposition time: list of
        (name, labels, value). Subclasses override (serving adds qps,
        cache-hit-rate, latency percentiles)."""
        return []

    def reset(self):
        """Drop every series (tests; NOT for production use — live call
        sites keep references to the old metric objects)."""
        with self._lock:
            self._series.clear()
            self._t0 = time.time()

    def to_dict(self):
        """JSON-ready snapshot. Histograms expand to count/mean and the
        three standing percentiles; labeled series render as
        ``name{k=v,...}`` keys."""
        out = {"uptime_sec": round(self.uptime, 3)}
        for m in self.series():
            key = m.name
            if m.labels:
                key += "{%s}" % ",".join(
                    "%s=%s" % kv for kv in sorted(m.labels.items()))
            if isinstance(m, Histogram):
                out[key] = {
                    "count": m.count,
                    "mean": round(m.mean, 4),
                    "min": round(m.min, 4) if m.count else 0.0,
                    "max": round(m.max, 4) if m.count else 0.0,
                    "p50": round(m.percentile(50), 4),
                    "p90": round(m.percentile(90), 4),
                    "p99": round(m.percentile(99), 4),
                }
            else:
                out[key] = m.value
        for name, labels, value in self.extra_series():
            key = name
            if labels:
                key += "{%s}" % ",".join(
                    "%s=%s" % kv for kv in sorted(labels.items()))
            out[key] = value
        return out
