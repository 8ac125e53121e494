"""Profiler (parity: python/mxnet/profiler.py + src/engine/profiler.{h,cc}).

Counterpart of ``mxtpu/profiler.py``, in three tiers:
  1. telemetry spans (``fit.step``, ``executor.forward``/``backward``,
     ``kvstore.push``/``pull``, ``engine.dispatch``, serving batches) land
     in the chrome://tracing dump with their trace, span and parent ids
     while the profiler runs;
  2. in an operator mode (``symbolic``, ``imperative``, ``operator``,
     ``all``) the executor's walk records one span per graph node, the
     device synchronized at each node so the span covers its kernels,
     and the backward as one ``backward`` span (DumpProfile parity,
     profiler.cc:152 EmitPid/EmitEvent);
  3. ``profiler_set_state('run')`` also starts a ``torch.profiler``
     session (CPU activity, and CUDA activity where a card is present),
     where mxtpu starts a jax xplane trace; ``dump_profile`` exports it
     beside the chrome trace as ``<filename stem>.torch.json``, and
     :func:`torch_profile` hands out the session (``key_averages()``).
"""
from __future__ import annotations

import json
import os
import threading
import time

from .analysis import concurrency as _conc

_state = {"mode": "symbolic", "filename": "profile.json", "running": False,
          "torch_trace": None, "aggregate_stats": False}
_torch_done = [None]  # the last finished torch.profiler session
_events = []
_agg = {}  # name -> telemetry Histogram of span ms (aggregate_stats mode)
_lock = _conc.lock("profiler", "_lock")

_OP_MODES = ("symbolic", "imperative", "operator", "all")


def profiler_set_config(mode="symbolic", filename="profile.json",
                        aggregate_stats=False, **kwargs):
    """Parity MXSetProfilerConfig(kwargs): mode 'symbolic'|'imperative'|
    'operator'|'api'|'all', output filename, optional aggregate stats.

    With ``aggregate_stats=True`` every span is ALSO folded, at record
    time, into a per-name fixed-bucket histogram (telemetry) — O(1)
    memory per layer, so ``dumps()`` keeps its per-layer table even
    after the raw event list is dumped or truncated (the reference's
    MXAggregateProfileStats contract)."""
    _state["mode"] = mode
    _state["filename"] = filename
    _state["aggregate_stats"] = bool(aggregate_stats)
    if _state["aggregate_stats"]:
        with _lock:
            _agg.clear()  # fresh aggregation session


def profiler_set_state(state="stop"):
    """Parity MXSetProfilerState: 'run' | 'stop'."""
    if state == "run":
        if _state["torch_trace"] is None:
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            _state["torch_trace"] = prof
        _state["running"] = True
    else:
        prof = _state["torch_trace"]
        if prof is not None:
            prof.stop()
            _torch_done[0] = prof
            _state["torch_trace"] = None
        _state["running"] = False


def torch_profile():
    """The last finished ``torch.profiler`` session (None before one)."""
    return _torch_done[0]


# aliases matching python/mxnet/profiler.py's public names
set_config = profiler_set_config
set_state = profiler_set_state


def is_running():
    return _state["running"]


def ops_enabled():
    """True when executors should run node-at-a-time with per-op spans."""
    return _state["running"] and _state["mode"] in _OP_MODES


_tids = {}


def _thread_tid():
    """Small stable tid for the calling thread (chrome://tracing lanes).
    Multi-threaded callers (the serving dispatchers) get one lane each, so
    concurrent spans don't corrupt B/E pairing in ``dumps()``."""
    ident = threading.get_ident()
    with _lock:
        tid = _tids.get(ident)
        if tid is None:
            tid = _tids[ident] = len(_tids)
        return tid


def record_span(name, begin_us, end_us, category="operator", tid=None,
                args=None):
    """Record one op-level span (called by instrumented paths). ``tid``
    defaults to a per-thread lane. ``args`` (e.g. telemetry trace/span
    ids) ride on the B event — chrome://tracing shows them on click, so
    correlated spans can be followed across thread lanes."""
    if not _state["running"]:
        return
    if tid is None:
        tid = _thread_tid()
    begin = {"name": name, "cat": category, "ph": "B",
             "ts": begin_us, "pid": 0, "tid": tid}
    if args:
        begin["args"] = dict(args)
    with _lock:
        _events.append(begin)
        _events.append({"name": name, "cat": category, "ph": "E",
                        "ts": end_us, "pid": 0, "tid": tid})
        if _state["aggregate_stats"]:
            h = _agg.get(name)
            if h is None:
                from .telemetry.metrics import Histogram
                h = _agg[name] = Histogram(name)
            h.observe((end_us - begin_us) / 1e3)


class scope:
    """Context manager: time a region into the trace."""

    def __init__(self, name, category="operator"):
        self.name = name
        self.category = category

    def __enter__(self):
        self.t0 = time.time() * 1e6
        return self

    def __exit__(self, *a):
        record_span(self.name, self.t0, time.time() * 1e6, self.category)


def torch_trace_path(filename=None):
    """Where ``dump_profile`` exports the torch.profiler session: beside
    the chrome trace, ``<stem>.torch.json``."""
    stem, _ext = os.path.splitext(filename or _state["filename"])
    return stem + ".torch.json"


def dump_profile(finished=True):
    """Parity MXDumpProfile: write chrome://tracing JSON (and export the
    last torch.profiler session beside it, when one ran)."""
    with _lock:
        payload = {"traceEvents": list(_events), "displayTimeUnit": "ms"}
    with open(_state["filename"], "w") as f:
        json.dump(payload, f)
    if _torch_done[0] is not None:
        _torch_done[0].export_chrome_trace(torch_trace_path())
    return _state["filename"]


dump = dump_profile


def dumps(reset=False):
    """Aggregate per-op statistics table as text (parity MXAggregateProfile
    StatsToString: name, count, total/avg/min/max ms).

    With ``aggregate_stats`` configured, the table is served from the
    standing per-layer histograms — it survives ``dump_profile`` and event
    truncation, and gains P50/P90/P99 columns. Otherwise it is recomputed
    from the raw in-memory events (pre-existing behavior)."""
    if _state["aggregate_stats"]:
        with _lock:
            hists = dict(_agg)
            if reset:
                _agg.clear()
                _events.clear()
        lines = ["%-40s %8s %12s %12s %12s %12s %12s %12s %12s" %
                 ("Name", "Count", "Total(ms)", "Avg(ms)", "Min(ms)",
                  "Max(ms)", "P50(ms)", "P90(ms)", "P99(ms)")]
        for name in sorted(hists, key=lambda n: -hists[n].sum):
            h = hists[name]
            lines.append(
                "%-40s %8d %12.3f %12.3f %12.3f %12.3f %12.3f %12.3f %12.3f"
                % (name[:40], h.count, h.sum, h.mean, h.min, h.max,
                   h.percentile(50), h.percentile(90), h.percentile(99)))
        return "\n".join(lines)
    stats = {}
    with _lock:
        spans = {}
        for ev in _events:
            key = (ev["name"], ev["tid"])
            if ev["ph"] == "B":
                spans[key] = ev["ts"]
            elif ev["ph"] == "E" and key in spans:
                dur = (ev["ts"] - spans.pop(key)) / 1e3  # ms
                s = stats.setdefault(ev["name"],
                                     [0, 0.0, float("inf"), 0.0])
                s[0] += 1
                s[1] += dur
                s[2] = min(s[2], dur)
                s[3] = max(s[3], dur)
        if reset:
            _events.clear()
    lines = ["%-40s %8s %12s %12s %12s %12s" %
             ("Name", "Count", "Total(ms)", "Avg(ms)", "Min(ms)", "Max(ms)")]
    for name in sorted(stats, key=lambda n: -stats[n][1]):
        c, tot, lo, hi = stats[name]
        lines.append("%-40s %8d %12.3f %12.3f %12.3f %12.3f" %
                     (name[:40], c, tot, tot / c, lo, hi))
    return "\n".join(lines)


def aggregate_stats_snapshot():
    """The standing per-layer histograms of aggregate_stats mode
    (name -> telemetry Histogram); empty dict when not configured."""
    with _lock:
        return dict(_agg)


def clear():
    with _lock:
        _events.clear()
        _agg.clear()
    _torch_done[0] = None
