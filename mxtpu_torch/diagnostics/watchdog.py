"""Hang watchdog: detect no-progress intervals and dump a postmortem.

Counterpart of ``mxtpu/diagnostics/watchdog.py``. A wedged training or
serving session is worse than a crashed one — it holds its card and
says nothing. The watchdog is a daemon
thread that samples two progress signals:

* **engine**: the host-side dependency engine has queued work
  (``queue depth > 0``) but its completion counter has not moved for
  longer than ``engine_stall_s`` — a worker is stuck inside a callback
  or the native scheduler lost a wakeup;
* **device waits**: a thread has been blocked inside a registered
  wait (the fit pacer's CUDA-event wait, ``device_wait``; the serving
  pool's collect, ``serving_collect``) for longer than ``wait_stall_s``
  — the device work never completed, the classic sign of a collective
  waiting for a peer.

On detection it emits ONE structured postmortem (flight-recorder ring,
engine state, buffer ledger, program table — see
``diagnostics.postmortem``) and re-arms only after progress resumes, so
a wedge produces a dump, not a dump storm.

Deadlines and cadence come from env vars (``MXTPU_WATCHDOG_INTERVAL_S``,
``MXTPU_WATCHDOG_ENGINE_S``, ``MXTPU_WATCHDOG_WAIT_S``); tests inject a
fake ``engine_probe`` and millisecond deadlines.
"""
from __future__ import annotations

import logging
import os
import threading
import time

from .. import telemetry as _tel
from ..analysis import concurrency as _conc

__all__ = ["Watchdog", "ensure_watchdog", "stop_watchdog", "wait_begin",
           "wait_end", "active_waits", "add_action", "remove_action",
           "fire_actions", "progress_age_s"]

_log = logging.getLogger("mxtpu_torch.diagnostics")

# ------------------------------------------------------------- action hooks
# Subscribers that ACT on a detection (elastic supervisor: checkpoint-
# restore-retry) after the postmortem has been captured. Process-wide:
# every Watchdog instance fires them, so a supervisor subscribed here
# sees detections from the fit-armed singleton AND from test-driven
# instances. GIL-atomic list ops; callbacks run on the watchdog thread
# and must not block (set a flag, enqueue work).
_ACTIONS = []


def add_action(fn):
    """Register ``fn(reason)`` to run after every watchdog detection
    (after the postmortem). Returns ``fn`` so it can be used inline."""
    if fn not in _ACTIONS:
        _ACTIONS.append(fn)
    return fn


def remove_action(fn):
    """Unregister a detection action (no-op when absent)."""
    try:
        _ACTIONS.remove(fn)
    except ValueError:
        pass


def fire_actions(reason):
    """Run every registered action for a detection raised OUTSIDE the
    watchdog thread — the health divergence rollback
    (``MXTPU_HEALTH_ACTION=rollback``, obs/health.py) reuses the same
    subscriber seam the hang detector fires through, so an attached
    elastic supervisor reacts identically to both. Same swallow
    contract as :meth:`Watchdog._fire`: one broken action must not
    starve the rest."""
    for fn in list(_ACTIONS):
        try:
            fn(reason)
        except Exception:
            # an action must never kill the caller that detected the
            # anomaly: it is logged, and the other actions still run
            _log.exception("watchdog action %r failed", fn)

# ------------------------------------------------------- device-wait registry
_WAITS = {}  # thread id -> (t0, description); GIL-atomic dict ops


def wait_begin(desc="device_wait"):
    """Mark this thread as blocked on the device (executor.device_wait).

    Doubles as the concurrency witness's blocking-under-lock seam: a
    registered device wait entered while holding any tracked hierarchy
    lock is exactly the hazard class the witness exists to catch — the
    wedge a watchdog postmortem would later attribute to the device
    when the real fault is the lock held across the wait."""
    _conc.blocking(desc)
    _WAITS[threading.get_ident()] = (time.monotonic(), desc)


def wait_end():
    _WAITS.pop(threading.get_ident(), None)


def active_waits():
    """[{thread, age_s, desc}] for every thread currently blocked."""
    now = time.monotonic()
    out = []
    for tid, (t0, desc) in list(_WAITS.items()):
        out.append({"thread": tid, "age_s": round(now - t0, 3),
                    "desc": desc})
    return out


def _default_engine_probe():
    """(queue_depth, ops_completed) from the live engine singleton (the
    port's native ``ThreadedEngine``'s pending table)."""
    from .. import engine as _engine
    return _engine._singleton_queue_depth(), _engine._M_COMPLETED.value


class Watchdog:
    """Daemon sampling thread; see module docstring for the conditions."""

    def __init__(self, interval=None, engine_stall_s=None, wait_stall_s=None,
                 engine_probe=None, on_detect=None):
        env = os.environ.get
        self.interval = float(interval if interval is not None
                              else env("MXTPU_WATCHDOG_INTERVAL_S", "1.0"))
        self.engine_stall_s = float(
            engine_stall_s if engine_stall_s is not None
            else env("MXTPU_WATCHDOG_ENGINE_S", "30"))
        self.wait_stall_s = float(
            wait_stall_s if wait_stall_s is not None
            else env("MXTPU_WATCHDOG_WAIT_S", "60"))
        self._engine_probe = engine_probe or _default_engine_probe
        self._on_detect = on_detect
        self._stop = threading.Event()
        self._thread = None
        # one dump per wedge, PER DETECTOR: a persistent wait stall must
        # not keep the engine detector disarmed (or vice versa)
        self._armed_engine = True
        self._armed_wait = True
        self._last_completed = None
        self._last_progress_t = time.monotonic()
        self.detections = 0

    # ------------------------------------------------------------ lifecycle
    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mxtpu-torch-watchdog")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.interval + 1.0)
        self._thread = None

    @property
    def running(self):
        return self._thread is not None and self._thread.is_alive()

    # ------------------------------------------------------------ sampling
    def check(self):
        """One sampling pass; returns the detection reason or None.
        Public so tests can drive it without the thread."""
        now = time.monotonic()
        try:
            depth, completed = self._engine_probe()
        except Exception:
            depth, completed = 0, None
        engine_reason = None
        if completed != self._last_completed or depth == 0:
            # progress (or nothing queued): reset the stall clock and
            # re-arm THIS detector (a concurrent wait stall must not
            # keep the engine detector disarmed, and vice versa)
            self._last_completed = completed
            self._last_progress_t = now
            self._armed_engine = True
        elif now - self._last_progress_t > self.engine_stall_s:
            engine_reason = ("engine stalled: queue depth %d, no "
                             "completions for %.1fs"
                             % (depth, now - self._last_progress_t))
        wait_reason = None
        stalled = [w for w in active_waits()
                   if w["age_s"] > self.wait_stall_s]
        if not stalled:
            self._armed_wait = True
        else:
            w = max(stalled, key=lambda x: x["age_s"])
            wait_reason = ("device_wait stalled: thread %d blocked %.1fs "
                           "in %s" % (w["thread"], w["age_s"], w["desc"]))
        if engine_reason is not None and self._armed_engine:
            self._armed_engine = False
            return self._detect(engine_reason)
        if wait_reason is not None and self._armed_wait:
            self._armed_wait = False
            return self._detect(wait_reason)
        return None

    def _detect(self, reason):
        self.detections += 1
        _tel.registry().counter(
            "watchdog_detections",
            help="no-progress intervals the watchdog flagged").inc()
        self._fire(reason)
        return reason

    def _fire(self, reason):
        if self._on_detect is not None:
            try:
                self._on_detect(reason)
            except Exception:
                _log.exception("watchdog on_detect failed")
        else:
            from . import postmortem
            postmortem("watchdog: %s" % reason, source="watchdog")
        # evidence first, action second: the registered actions (elastic
        # supervisor restore-retry) run AFTER the postmortem capture, so
        # a recovery that works still leaves the wedge forensics behind
        fire_actions(reason)

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.check()
            except Exception:
                # the watchdog must outlive anything it watches: a failed
                # sample is logged, and the next one runs
                _log.exception("watchdog sample failed")


_SINGLETON = None
_SINGLETON_LOCK = _conc.lock("watchdog", "_SINGLETON_LOCK")


def _singleton_progress_age():
    """Gauge callback reading the SINGLETON (throwaway test watchdogs
    must not pin or shadow the live one — engine-gauge convention)."""
    w = _SINGLETON
    if w is None:
        return 0.0
    return round(time.monotonic() - w._last_progress_t, 3)


_tel.registry().gauge(
    "watchdog_last_progress_age_s", fn=_singleton_progress_age,
    help="seconds since the watchdog last saw engine progress "
         "(or an empty queue); 0 with no watchdog running")


def progress_age_s():
    """Seconds since the process watchdog last saw progress — the
    cheap health signal admission control reads (0.0 with no watchdog
    running: absence of evidence must not shed traffic)."""
    return _singleton_progress_age()


def ensure_watchdog():
    """Start the process watchdog (idempotent). Called from ``Module.fit``
    and ``ServingSession``; ``MXTPU_WATCHDOG=0`` disables it."""
    global _SINGLETON
    if os.environ.get("MXTPU_WATCHDOG", "1") == "0":
        return None
    with _SINGLETON_LOCK:
        if _SINGLETON is None:
            _SINGLETON = Watchdog()
        _SINGLETON.start()
        return _SINGLETON


def stop_watchdog():
    global _SINGLETON
    with _SINGLETON_LOCK:
        if _SINGLETON is not None:
            _SINGLETON.stop()
            _SINGLETON = None
