"""Chrome trace-event / Perfetto export of the merged timeline.

Counterpart of ``mxtpu/obs/trace_export.py``: the same event schema.

``dumps()`` renders one JSON object loadable by Perfetto or
``chrome://tracing``, merging every timeline source the process already
records onto named per-thread tracks:

  * **spans** (the ``obs.trace`` ring) as ``"X"`` complete events —
    engine dispatch, executor fwd/bwd, fit steps, kvstore push/pull,
    serving ``batch[N]``/``pool.run``, decode requests, elastic writer
    generations — with ``trace_id``/``span_id``/``parent_id`` in
    ``args`` so a click shows the correlation ids;
  * **flow events** (``ph: "s"``/``"f"``, id = child span id) wherever
    a span's parent ran on a *different* thread — the existing trace
    ids become visible arrows joining request → batch → pool.run and
    engine push → worker dispatch;
  * **flight-recorder instants** (``ph: "i"``) — engine pushes, fault
    injections, replica quarantine/respawn, decode step/prefill/token/
    block-alloc events, sanitizer findings — everything the diagnostics
    ring holds except its redundant ``span_start``/``span_end`` mirror;
  * **metadata** (``ph: "M"``) naming each thread track from the live
    ``threading.enumerate()`` table (dead threads fall back to
    ``tid-<ident>``).

Timebase: wall-clock microseconds (``Span.t0_us`` convention), shared
with ``mxtpu_torch.profiler``'s op spans, so an exported timeline and a
profiler dump line up. Serving exposes this body at ``GET
/debug/trace``; ``mxtpu_top --trace-out FILE`` fetches it once.
"""
from __future__ import annotations

import json
import os
import threading

from . import trace as _trace

__all__ = ["trace_events", "dumps", "dump"]


def _jsonable(v):
    if isinstance(v, (int, float, str, bool)) or v is None:
        return v
    return str(v)


def _thread_names(idents):
    alive = {t.ident: t.name for t in threading.enumerate()}
    return {i: alive.get(i, "tid-%d" % i) for i in idents}


def trace_events(flight_limit=1024):
    """The merged, ts-sorted event list (metadata events first)."""
    events = []
    idents = set()

    ring = _trace.ring()
    spans = ring.snapshot() if ring is not None else []
    by_id = {s["span_id"]: s for s in spans}
    for s in spans:
        idents.add(s["thread"])
        args = {"trace_id": s["trace_id"], "span_id": s["span_id"],
                "parent_id": s["parent_id"]}
        if s["tags"]:
            for k, v in s["tags"].items():
                args[str(k)] = _jsonable(v)
        events.append({
            "name": s["name"], "cat": s["category"] or "default",
            "ph": "X", "ts": s["t0_us"],
            "dur": max(0.0, s["t1_us"] - s["t0_us"]),
            "pid": 0, "tid": s["thread"], "args": args})
        parent = by_id.get(s["parent_id"])
        if parent is not None and parent["thread"] != s["thread"]:
            # cross-thread hop: the captured-parent handoff becomes a
            # visible flow arrow. id = child span id (process-unique).
            events.append({
                "name": "flow", "cat": "flow", "ph": "s",
                "id": s["span_id"], "pid": 0, "tid": parent["thread"],
                "ts": min(parent["t0_us"], s["t0_us"])})
            events.append({
                "name": "flow", "cat": "flow", "ph": "f", "bp": "e",
                "id": s["span_id"], "pid": 0, "tid": s["thread"],
                "ts": s["t0_us"]})

    # flight ring -> thread-scoped instants (late import: diagnostics
    # imports obs.trace to arm the sink; this direction must stay lazy)
    from .. import diagnostics as _diag
    rec = _diag.recorder()
    for ev in (rec.snapshot(limit=flight_limit) if rec is not None else []):
        if ev["kind"] in ("span_start", "span_end"):
            continue  # the span ring carries the real slices
        idents.add(ev["thread"])
        events.append({
            "name": "%s:%s" % (ev["kind"], ev["name"]),
            "cat": ev["kind"], "ph": "i", "s": "t",
            "ts": float(ev["time"]) * 1e6, "pid": 0, "tid": ev["thread"],
            "args": {"detail": _jsonable(ev["detail"]), "seq": ev["seq"]}})

    names = _thread_names(idents)
    meta = [{"name": "process_name", "ph": "M", "pid": 0,
             "args": {"name": "mxtpu pid=%d" % os.getpid()}}]
    for i in sorted(idents):
        meta.append({"name": "thread_name", "ph": "M", "pid": 0,
                     "tid": i, "args": {"name": names[i]}})
    events.sort(key=lambda e: e.get("ts", 0.0))
    return meta + events


def dumps(flight_limit=1024, indent=None):
    """The full trace.json body as a string."""
    return json.dumps({"traceEvents": trace_events(flight_limit),
                       "displayTimeUnit": "ms"},
                      default=str, indent=indent)


def dump(path, flight_limit=1024):
    """Write trace.json at ``path``; returns the path."""
    body = dumps(flight_limit)
    with open(path, "w") as f:
        f.write(body)
    return path
