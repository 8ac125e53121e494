"""Online refinement: nudge the bounded knobs from live telemetry.

Counterpart of ``mxtpu/tune/online.py``: the same rules, in the same
order, so the same signals make the same adjustments. The port's fit
binds its in-flight window (``fit.max_in_flight``); a serving session
binds the knobs it has (the burst-mode session of this port has no
in-flight depth or refill watermark yet: ROADMAP A.11).

The offline search picks a config from probe evidence; production
traffic then drifts — the request mix shifts, the host gets noisy
neighbors, memory pressure grows. The :class:`OnlineController` closes
that gap the cheap way: at a fixed cadence it reads signals the
framework already emits —

* ``fit_sync_wait_ms`` (pipeline pacing blocks),
* ``batch_service_ms`` / ``dispatch_idle_gap_ms`` / queue depth
  (from the bound serving session's registry),
* memory-ledger headroom (``diagnostics.ledger()``),

and nudges only the knobs the registry certifies a ``safe_range`` for
(in-flight depths, the refill watermark, the admission latency budget)
by one bounded step per tick. It never leaves the certified range, and
every adjustment is recorded twice: as the ``tune_adjustments{knob=}``
/ ``tune_knob_value{knob=}`` telemetry series, and as an
``online-adjust`` event in the active artifact's provenance log — so a
dashboard and a later reader both see exactly what moved, when,
and on which signal.

The controller is deliberately a *refiner*, not a search: one knob step
per signal per tick, always inside the range the offline search
certified. Tests drive :meth:`OnlineController.step` directly with
synthetic signals; production wraps it in the cadence thread
(:meth:`start`).
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict

from ..analysis import concurrency as _conc
from . import registry as _registry

__all__ = ["OnlineController", "attach_fit", "release", "current"]

_CURRENT = [None]   # the process-active controller (None = no refinement)


def current():
    """The active :class:`OnlineController`, or None."""
    return _CURRENT[0]


def attach_fit(holder, name="fit.max_in_flight"):
    """Register a fit loop's live in-flight holder (``{"v": K}``) with
    the active controller; no-op without one. Returns the holder."""
    ctl = _CURRENT[0]
    if ctl is not None:
        ctl.bind_holder(name, holder)
    return holder


def release(holder):
    """Unbind a fit holder when its fit returns (no-op without a
    controller)."""
    ctl = _CURRENT[0]
    if ctl is not None:
        ctl.unbind_holder(holder)


class _Bound:
    """One live, nudgeable knob: getter/setter + its certified range."""

    __slots__ = ("name", "knob", "get", "set", "holder")

    def __init__(self, name, getter, setter, holder=None):
        self.name = name
        self.knob = _registry.get_knob(name)
        if self.knob.safe_range is None:
            raise ValueError(
                "knob %s has no certified safe_range — the online "
                "controller must not touch it" % name)
        self.get = getter
        self.set = setter
        self.holder = holder


class OnlineController:
    """Cadence-driven bounded nudging of live knobs.

    ``artifact`` — the :class:`~mxtpu_torch.tune.TunedConfig` whose
    provenance log receives every adjustment (optional; telemetry is
    always emitted). ``cadence_s`` — seconds between ticks when run as
    a thread. :meth:`activate` installs the controller process-wide so
    ``Module.fit`` binds its in-flight holder automatically.
    """

    def __init__(self, cadence_s=2.0, artifact=None):
        from .. import telemetry as _tel
        self.cadence_s = float(cadence_s)
        self.artifact = artifact
        self._bound = OrderedDict()    # name -> _Bound
        self._last = {}                # signal-name -> last cumulative val
        self._lock = _conc.lock("OnlineController", "_lock")
        self._session = None
        self._thread = None
        self._stop = threading.Event()
        self._ticks = _tel.counter(
            "tune_controller_ticks",
            help="online-refinement evaluation ticks")
        self._tel = _tel

    # ------------------------------------------------------------ binding
    def bind(self, name, getter, setter, holder=None):
        with self._lock:
            self._bound[name] = _Bound(name, getter, setter, holder=holder)
        return self

    def bind_holder(self, name, holder, key="v"):
        """Bind a one-slot dict holder (the fit loop's live window)."""
        return self.bind(name, lambda: holder[key],
                         lambda v: holder.__setitem__(key, v),
                         holder=holder)

    def unbind_holder(self, holder):
        with self._lock:
            for name, b in list(self._bound.items()):
                if b.holder is holder:
                    del self._bound[name]

    def bind_session(self, session):
        """Bind a serving session's live knobs that it has: in-flight
        depth, the batcher's refill watermark, and — when an admission
        policy is installed — its queue-wait budget."""
        self._session = session
        if hasattr(session, "max_in_flight"):
            self.bind("serving.max_in_flight",
                      lambda: session.max_in_flight,
                      lambda v: setattr(session, "max_in_flight", int(v)))
        batcher = session.batcher
        if hasattr(batcher, "refill_watermark"):
            self.bind("serving.refill_watermark",
                      lambda: batcher.refill_watermark,
                      lambda v: setattr(batcher, "refill_watermark",
                                        int(v)))
        pol = getattr(session, "_admission", None)
        if pol is not None and hasattr(pol, "queue_wait_budget_ms"):
            self.bind("serving.queue_wait_budget_ms",
                      lambda: pol.queue_wait_budget_ms,
                      lambda v: setattr(pol, "queue_wait_budget_ms",
                                        float(v)))
        return self

    # ------------------------------------------------------------ signals
    def sample(self):
        """One point-in-time signal snapshot: WINDOW deltas for the
        cumulative series (observations since the previous tick), plus
        instantaneous gauges. Overridable in tests."""
        from .. import diagnostics as _diag
        sig = {}

        def delta(key, cur_count, cur_sum=None):
            prev = self._last.get(key, 0)
            self._last[key] = cur_count
            return max(0, cur_count - prev)

        h = self._tel.histogram("fit_sync_wait_ms")
        sig["fit_pacing_waits"] = delta("fit_sync_wait", h.count)
        sig["fit_sync_wait_mean_ms"] = h.mean
        d = self._tel.histogram("fit_dispatch_ms")
        sig["fit_dispatch_mean_ms"] = d.mean
        sess = self._session
        if sess is not None:
            m = sess.metrics
            gaps = m.histogram("dispatch_idle_gap_ms")
            sig["idle_gaps"] = delta("idle_gaps", gaps.count)
            sig["idle_gap_mean_ms"] = gaps.mean
            svc = m.histogram("batch_service_ms")
            sig["batch_services"] = delta("batch_services", svc.count)
            sig["batch_service_p99_ms"] = svc.percentile(99)
            sig["queue_depth"] = sess.batcher.depth
            sig["sheds"] = delta("sheds",
                                 m.counter("requests_shed").value)
        budget = getattr(sess, "_mem_budget", None) if sess else None
        if budget:
            sig["mem_headroom_frac"] = max(
                0.0, 1.0 - _diag.ledger().live_bytes() / budget)
        return sig

    # ------------------------------------------------------------ control
    def _nudge(self, name, new_value, reason, signals):
        b = self._bound.get(name)
        if b is None:
            return None
        old = b.get()
        new_value = b.knob.clamp(b.knob.coerce(new_value))
        if new_value == old:
            return None
        b.set(new_value)
        self._tel.counter("tune_adjustments", labels={"knob": name},
                          help="online-refinement knob adjustments").inc()
        self._tel.gauge("tune_knob_value", labels={"knob": name},
                        help="current online-refined knob value").set(
            float(new_value))
        adj = {"knob": name, "from": old, "to": new_value,
               "reason": reason,
               "t": time.time()}
        if self.artifact is not None:
            self.artifact.record("online-adjust", signals={
                k: round(v, 4) if isinstance(v, float) else v
                for k, v in signals.items()}, **adj)
        return adj

    def step(self, signals=None):
        """One control tick. Returns the adjustments applied (possibly
        empty). ``signals`` overrides :meth:`sample` (tests)."""
        self._ticks.inc()
        sig = self.sample() if signals is None else signals
        out = []
        with self._lock:
            # --- memory pressure trumps everything: back the in-flight
            # windows off before the allocator (or admission) has to.
            # The floor is the LIVE admission floor (the bound policy's
            # value when a session is attached, else the resolved knob)
            # — the controller must start backing off at 2x wherever
            # admission will actually start shedding
            headroom = sig.get("mem_headroom_frac")
            pol = getattr(self._session, "_admission", None) \
                if self._session is not None else None
            floor = getattr(pol, "min_mem_headroom", None)
            if floor is None:
                floor = _registry.resolve("serving.min_mem_headroom",
                                          artifact=self.artifact)
            if headroom is not None and headroom < 2 * floor:
                for name in ("serving.max_in_flight", "fit.max_in_flight"):
                    b = self._bound.get(name)
                    if b is not None:
                        a = self._nudge(name, b.get() - 1,
                                        "memory: headroom %.1f%% under 2x "
                                        "floor" % (headroom * 100), sig)
                        if a:
                            out.append(a)
                return out
            # --- device starving while work waits: deepen the serving
            # window, then release batches earlier
            if sig.get("idle_gaps", 0) > 0 and sig.get("queue_depth", 0) > 0:
                b = self._bound.get("serving.max_in_flight")
                if b is not None:
                    a = self._nudge("serving.max_in_flight", b.get() + 1,
                                    "idle gaps with queued work: deepen "
                                    "in-flight window", sig)
                    if a:
                        out.append(a)
                w = self._bound.get("serving.refill_watermark")
                if w is not None and not out:
                    a = self._nudge("serving.refill_watermark",
                                    max(1, w.get() // 2),
                                    "idle gaps with queued work: release "
                                    "batches earlier", sig)
                    if a:
                        out.append(a)
            # --- admission shedding while service is fast: the budget
            # is tighter than the measured tail — relax it a step
            if sig.get("sheds", 0) > 0:
                b = self._bound.get("serving.queue_wait_budget_ms")
                p99 = sig.get("batch_service_p99_ms", 0.0)
                if b is not None and p99 and p99 < 0.25 * b.get():
                    a = self._nudge("serving.queue_wait_budget_ms",
                                    b.get() * 1.25,
                                    "shedding while service p99 is far "
                                    "under budget", sig)
                    if a:
                        out.append(a)
            # --- fit pipeline blocking on the oldest step: deepen the
            # window (the jitter absorber)
            if sig.get("fit_pacing_waits", 0) > 0 and \
                    sig.get("fit_sync_wait_mean_ms", 0.0) > \
                    sig.get("fit_dispatch_mean_ms", 0.0):
                b = self._bound.get("fit.max_in_flight")
                if b is not None:
                    a = self._nudge("fit.max_in_flight", b.get() + 1,
                                    "pacing waits dominate dispatch: "
                                    "deepen fit window", sig)
                    if a:
                        out.append(a)
        return out

    # ------------------------------------------------------------ lifecycle
    def activate(self):
        """Install process-wide (fit loops bind their holders here)."""
        _CURRENT[0] = self
        return self

    def deactivate(self):
        if _CURRENT[0] is self:
            _CURRENT[0] = None

    def start(self):
        """Run :meth:`step` every ``cadence_s`` on a daemon thread."""
        if self._thread is not None:
            return self
        self.activate()
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self.cadence_s):
                try:
                    self.step()
                except Exception:   # refinement must never kill serving
                    pass

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="mxtpu-torch-tune-online")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)
        self.deactivate()

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.stop()
