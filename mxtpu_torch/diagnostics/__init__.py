"""mxtpu_torch.diagnostics — memory accounting, cost introspection,
flight recorder, hang watchdog.

Counterpart of ``mxtpu/diagnostics``. Telemetry answers "how fast"; this
package answers the two questions an operator asks when a session
misbehaves: **where did the device memory go** and **why is nothing
moving**.

  * ``ledger``   — process-wide device-byte accounting per (ctx, origin)
                   with a drift check against the CUDA caching allocator
                   (``mem_live_bytes{ctx,origin}`` / ``mem_peak_bytes``)
  * ``programs`` — the cost of each program the build seam captures
                   (``diagnostics.program_table()``)
  * ``flight``   — lock-free ring of recent events (spans, engine
                   pushes) readable from a signal handler
  * ``watchdog`` — no-progress detection over the engine queue and the
                   registered device waits; emits a structured postmortem

Postmortems fire on watchdog detection, on ``SIGUSR2``, on fatal
exceptions escaping ``Module.fit``, on a health divergence, and on
demand (``GET /debug/state`` on the serving server, or ``dump_state()``
here).
"""
from __future__ import annotations

import json as _json
import logging as _logging
import os as _os
import threading as _threading
import time as _time

from .. import telemetry as _tel
from ..analysis import concurrency as _conc
from . import ledger as ledger_mod  # module alias BEFORE the function
# import below shadows the package attribute 'ledger'
from .ledger import (DeviceMemoryLedger, alloc_origin, current_origin,
                     device_label, ledger, mem_enabled, set_mem_enabled)
from .programs import (ProgramRecord, cost_enabled, latest_record,
                       program_table, programs, record_program,
                       set_cost_enabled)
from . import flight
from .flight import (FlightRecorder, flight_enabled, record, recorder,
                     set_flight_enabled)
# importing obs.trace ARMS the span ring (tracing.set_span_sink) beside
# the flight hook above: every process that diagnoses also captures an
# exportable timeline (MXTPU_TRACE=0 opts out)
from ..obs import trace as _obs_trace
from .watchdog import (Watchdog, active_waits, add_action, ensure_watchdog,
                       fire_actions, progress_age_s, remove_action,
                       stop_watchdog, wait_begin, wait_end)

__all__ = [
    "DeviceMemoryLedger", "ledger", "alloc_origin", "current_origin",
    "device_label", "mem_enabled", "set_mem_enabled", "reconcile",
    "ProgramRecord", "programs", "program_table", "record_program",
    "latest_record", "cost_enabled", "set_cost_enabled",
    "flight", "FlightRecorder", "recorder", "record", "flight_enabled",
    "set_flight_enabled",
    "Watchdog", "ensure_watchdog", "stop_watchdog", "active_waits",
    "wait_begin", "wait_end", "add_action", "remove_action",
    "fire_actions", "progress_age_s",
    "debug_state", "postmortem", "last_postmortem", "dump_state",
    "install_signal_handler", "uninstall_signal_handler",
    "on_session_start", "on_session_end", "set_enabled",
]

_log = _logging.getLogger("mxtpu_torch.diagnostics")

_LAST_POSTMORTEM = None
_LAST_DUMP_T = {}      # dump destination -> monotonic time of its last file
_LAST_CAPTURE_T = 0.0   # throttles full state CAPTURE for per-event sources
_DUMP_MIN_INTERVAL_S = float(_os.environ.get("MXTPU_DIAG_DUMP_MIN_S", "5"))
_CAPTURE_THROTTLED_SOURCES = ("serving",)
_PM_LOCK = _conc.lock("diagnostics", "_PM_LOCK")


def set_enabled(flag):
    """Master runtime toggle for the per-event costs (ledger seams, flight
    ring, span ring). The watchdog keeps running."""
    set_mem_enabled(flag)
    set_flight_enabled(flag)
    _obs_trace.set_trace_enabled(flag)


def reconcile():
    """Ledger vs the CUDA allocator drift check (see ledger.py)."""
    return ledger().reconcile()


def _engine_state():
    """Engine snapshot WITHOUT instantiating an engine (a debug read must
    not decide which engine the process runs)."""
    from .. import engine as _engine
    e = _engine._ENGINE
    reg = _tel.registry()
    return {
        "type": type(e).__name__ if e is not None else None,
        "queue_depth": _engine._singleton_queue_depth(),
        "workers": _engine._singleton_workers(),
        "ops_dispatched": _engine._M_DISPATCHED.value,
        "ops_completed": _engine._M_COMPLETED.value,
        "queue_wait_ms_p99": round(
            reg.histogram("engine_queue_wait_ms").percentile(99), 4),
    }


def debug_state(flight_limit=256):
    """The live-session debug snapshot, with mxtpu's keys: buffer ledger,
    program table, flight-recorder ring, engine state, active device
    waits, the concurrency witness, the span ring's fill, the ledger's
    reconcile (where a CUDA allocator holds its bytes) and (after a
    health fit) the training-health panel.
    JSON-ready: the body of ``GET /debug/state`` and of every
    postmortem."""
    rec = recorder()
    ring = _obs_trace.ring()
    state = {
        "time": round(_time.time(), 3),
        "pid": _os.getpid(),
        "ledger": ledger().snapshot(),
        "programs": programs(),
        "flight": rec.snapshot(limit=flight_limit) if rec is not None else [],
        "engine": _engine_state(),
        "waits": active_waits(),
        "concurrency": _conc.state(),
        "trace": {
            "enabled": _obs_trace.trace_enabled(),
            "spans": len(ring) if ring is not None else 0,
            "capacity": ring.capacity if ring is not None else 0,
        },
    }
    drift = reconcile()
    if drift["allocator"] is not None:
        # on the CPU there is no allocator to reconcile against: the key
        # is left out, as mxtpu leaves it out when its check cannot run
        state["reconcile"] = drift
    # lazy: obs.health imports diagnostics
    from ..obs import health as _health
    hp = _health.panel()
    if hp is not None:
        state["training_health"] = hp
    return state


def postmortem(reason, exc=None, source="manual", path=None):
    """Build a structured postmortem (debug_state + reason), remember it,
    log it, and — when ``path`` is given or ``MXTPU_DIAG_DUMP_DIR`` is
    set — write it as JSON, rate-limited to one file per
    ``MXTPU_DIAG_DUMP_MIN_S`` for each destination (mxtpu keeps one clock
    for all; a new destination gets its first dump at once). Returns the
    dump dict."""
    global _LAST_POSTMORTEM, _LAST_CAPTURE_T
    dump = {"reason": str(reason), "source": source}
    if exc is not None:
        dump["exception"] = "%s: %s" % (type(exc).__name__, exc)
    capture = True
    if source in _CAPTURE_THROTTLED_SOURCES:
        with _PM_LOCK:
            now = _time.monotonic()
            if now - _LAST_CAPTURE_T < _DUMP_MIN_INTERVAL_S:
                capture = False
            else:
                _LAST_CAPTURE_T = now
    if capture:
        try:
            dump.update(debug_state())
        except Exception as state_exc:  # never let the dump kill the dumper
            dump["state_error"] = repr(state_exc)
    else:
        dump["throttled"] = True
    out_dir = path or _os.environ.get("MXTPU_DIAG_DUMP_DIR")
    with _PM_LOCK:
        _LAST_POSTMORTEM = dump
        _tel.registry().counter(
            "diag_postmortems", labels={"source": source},
            help="structured postmortem dumps emitted").inc()
        throttled = False
        if out_dir:
            now = _time.monotonic()
            last = _LAST_DUMP_T.get(out_dir)
            throttled = last is not None and \
                now - last < _DUMP_MIN_INTERVAL_S
            if not throttled:
                _LAST_DUMP_T[out_dir] = now
    _log.error("postmortem (%s): %s | live=%dB queue=%d programs=%d "
               "flight=%d", source, reason,
               dump.get("ledger", {}).get("live_bytes_total", 0),
               dump.get("engine", {}).get("queue_depth", 0),
               len(dump.get("programs", ())), len(dump.get("flight", ())))
    if out_dir and not throttled:
        try:
            if _os.path.isdir(out_dir):
                fname = _os.path.join(
                    out_dir, "mxtpu_postmortem_%d_%d.json"
                    % (_os.getpid(), int(_time.time() * 1e3)))
            else:
                fname = out_dir
            with open(fname, "w") as f:
                _json.dump(dump, f, indent=2, default=str)
            dump["dump_path"] = fname
        except OSError as io_exc:
            _log.error("postmortem write failed: %r", io_exc)
    return dump


def last_postmortem():
    """The most recent postmortem dict (None if none fired)."""
    return _LAST_POSTMORTEM


def dump_state(path, fmt="json"):
    """Write ``debug_state()`` to ``path`` on demand (no wedge needed)."""
    if fmt != "json":
        raise ValueError("dump_state: fmt must be 'json'")
    state = debug_state()
    with open(path, "w") as f:
        _json.dump(state, f, indent=2, default=str)
    return path


_SIGNAL_INSTALLED = None  # the signal number our handler holds, or None
_SESSIONS = [0, False]    # live fits/sessions; whether they installed it


def install_signal_handler(signum=None):
    """Install the ``SIGUSR2`` -> postmortem handler (main thread only;
    False elsewhere or where signals are unavailable). Declines when the
    signal already has a non-default disposition; ``MXTPU_DIAG_SIGNAL=0``
    opts out."""
    global _SIGNAL_INSTALLED
    if _SIGNAL_INSTALLED is not None:
        return True
    if _os.environ.get("MXTPU_DIAG_SIGNAL", "1") == "0":
        return False
    try:
        import signal

        signum = signum if signum is not None else signal.SIGUSR2
        if signal.getsignal(signum) is not signal.SIG_DFL:
            return False

        def _handler(sig, frame):
            # never dump inline: the handler may interrupt a thread
            # inside a (non-reentrant) lock the dump takes. Hand off.
            _threading.Thread(
                target=postmortem, args=("signal %d" % sig,),
                kwargs={"source": "signal"}, daemon=True,
                name="mxtpu-torch-diag-sigdump").start()

        signal.signal(signum, _handler)
        _SIGNAL_INSTALLED = signum
        return True
    except (ValueError, AttributeError, OSError):
        return False  # non-main thread, or platform without SIGUSR2


def uninstall_signal_handler():
    """Give the signal back its default disposition (main thread only);
    False when ours was not installed or this is not the main thread."""
    global _SIGNAL_INSTALLED
    if _SIGNAL_INSTALLED is None:
        return False
    try:
        import signal
        signal.signal(_SIGNAL_INSTALLED, signal.SIG_DFL)
    except (ValueError, OSError):
        return False  # not the main thread: it stays ours
    _SIGNAL_INSTALLED = None
    return True


def on_session_start():
    """Wired into Module.fit and ServingSession: arm the watchdog and,
    while any fit or session runs, the signal handler. mxtpu keeps its
    handler for the life of the process; the port gives the signal back
    when the last fit or session ends (``on_session_end``), so another
    library of the process can claim it between sessions."""
    if _SESSIONS[0] == 0:
        _SESSIONS[1] = _SIGNAL_INSTALLED is None and \
            install_signal_handler()
    _SESSIONS[0] += 1
    return ensure_watchdog()


def on_session_end():
    """A fit or session ended: the last one out gives the signal back,
    when the first one in installed it."""
    _SESSIONS[0] = max(0, _SESSIONS[0] - 1)
    if _SESSIONS[0] == 0 and _SESSIONS[1]:
        _SESSIONS[1] = False
        uninstall_signal_handler()
