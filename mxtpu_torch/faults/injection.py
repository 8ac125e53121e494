"""Seeded, deterministic fault injection at declared seams.

Every robustness mechanism in this repo — the watchdog, the elastic
supervisor's restore-retry, serving admission shedding — was built
against failures we *imagined*. This module makes failures something a
test (or an operator on a canary) can *schedule*: a fixed catalog of
injection points at the existing seams (:data:`POINTS`), armed by a
seeded schedule, firing deterministically.

Counterpart of ``mxtpu/faults/injection.py`` with the same
:data:`POINTS` (those of subsystems the port does not have yet
included), so an ``MXTPU_FAULTS`` schedule valid for one package is
valid for the other, and the same seeded firing sequence.

``faults.point("name")`` costs one module-global read plus a ``None``
test when nothing is armed, so the points stay in production code
permanently — chaos coverage must not require a special build.

Schedules come from the ``MXTPU_FAULTS`` env::

    MXTPU_FAULTS="elastic.snapshot.write:errno=ENOSPC,p=0.3,seed=7;\\
serving.replica.dispatch:kind=kill,after=5"

or programmatically::

    with mxtpu_torch.faults.scope("kvstore.push:errno=ECONNRESET,p=0.5,seed=3"):
        ...

Spec keys per point (``;`` separates points, ``,`` separates keys):

* ``kind``       — ``raise`` | ``errno`` | ``latency`` | ``kill``
  (inferred from ``errno=`` / ``latency_ms=`` when omitted; default
  ``raise``);
* ``errno``      — symbolic name (``ENOSPC``) or number; raises an
  :class:`InjectedIOError` (an ``OSError`` — the retry layer and real
  IO handlers see exactly what a real disk/socket failure looks like);
* ``latency_ms`` — sleep instead of raising (wedge simulation: inject
  at ``executor.device_wait`` past ``MXTPU_WATCHDOG_WAIT_S`` and the
  watchdog fires for real);
* ``kill``       — raise :class:`FaultKill`, a **BaseException**: the
  per-batch / per-job ``except Exception`` rescue paths cannot swallow
  it, so it propagates to the top of the owning thread exactly like a
  real thread death (serving worker death, snapshot-writer death);
* ``p``          — firing probability per evaluation (default 1.0),
  drawn from a per-spec ``random.Random(seed)`` — the whole schedule
  replays identically run to run;
* ``after``      — skip the first N evaluations (default 0);
* ``times``      — max firings (default: unlimited; ``kill`` defaults
  to 1 — a thread only dies once);
* ``seed``       — the per-spec RNG seed (default 0).

Every firing emits ``fault_injected{point,kind}`` telemetry and a
flight-recorder event, so a postmortem taken during a chaos run names
the injected cause next to the symptom.
"""
from __future__ import annotations

import errno as _errno_mod
import logging
import os
import threading
import time

from .. import telemetry as _tel
from ..analysis import concurrency as _conc
from ..base import MXNetError
from ..diagnostics import flight as _flight

__all__ = ["POINTS", "FaultInjected", "InjectedIOError", "FaultKill",
           "FaultSpec", "FaultSchedule", "point", "configure", "scope",
           "active", "reset", "parse_schedule"]

log = logging.getLogger("mxtpu_torch.faults")

#: The declared injection-point catalog: every name ``point()`` is
#: called with, at the seam it guards. A schedule naming an unknown
#: point is rejected at parse time — a typo must fail loudly, not arm
#: nothing.
POINTS = {
    "elastic.snapshot.write":
        "SnapshotWriter._write, before any file IO of a job (writer "
        "thread) — disk-full / IO-error / writer-death simulation",
    "elastic.snapshot.fsync_rename":
        "the atomic-rename step of _write_atomic/_write_ndsave_atomic, "
        "after the tmp file is written but BEFORE os.replace — a torn "
        "write: crash between data and its rename",
    "serving.replica.dispatch":
        "_Replica.dispatch, before bind+issue (dispatcher thread) — "
        "failing or dying replica worker",
    "serving.replica.collect":
        "_Replica.collect, before the bulk device→host transfer — "
        "retire-path failure",
    "serving.decode.step":
        "DecodeSession step loop, before a bucket step-program "
        "dispatches — failing or dying decode worker mid-sequence",
    "serving.decode.evict":
        "DecodeSession._evict, before a finished/expired sequence's "
        "slot bookkeeping — failure while retiring a sequence (the "
        "slot must still return to the free list)",
    "serving.decode.prefill":
        "DecodeSession._prefill_chunk, before one chunked-prefill "
        "dispatch — failing prefill mid-prompt (the sequence fails "
        "alone; its eviction must return every allocated KV block)",
    "serving.decode.block_alloc":
        "DecodeSession._ensure_blocks, before the paged arena grows a "
        "sequence's block table — allocation failure, indistinguishable "
        "from a dry block pool (per-sequence failure, no leaked blocks)",
    "io.prefetch.produce":
        "PrefetchingIter producer thread, before the underlying "
        "iterator's next() — crashing data pipeline",
    "kvstore.push":
        "KVStore per-key push unit, before aggregation lands — "
        "transient transport failure",
    "kvstore.pull":
        "KVStore per-key pull unit, before weights ship — transient "
        "transport failure",
    "executor.device_wait":
        "executor.device_wait, inside the watchdog-registered wait — "
        "latency injection here IS a wedged device",
    "engine.dispatch":
        "engine push/dispatch seam — failing async op dispatch",
    "quant.calibration_load":
        "compile.quant.load_calibration, before the corpus read that "
        "feeds int8 activation scales — a corrupt/unreadable "
        "calibration store must decline the quant rewrite (the graph "
        "serves unquantized), never crash the build",
}

#: the points of :data:`POINTS` whose seam the port does not have yet,
#: with the slice (ROADMAP section A) that brings it: a schedule may name
#: them, and they never fire here
UNREACHED = {}

_KINDS = ("raise", "errno", "latency", "kill")


class FaultInjected(Exception):
    """An injected fault (kind=raise). Deliberately NOT an
    ``MXNetError``: injected faults model backend/IO failures, which
    the rescue paths treat as unexpected (postmortem, HTTP 500) — a
    usage-error subclass would take the quiet branch everywhere."""


class InjectedIOError(FaultInjected, OSError):
    """An injected OS-level failure (kind=errno): an ``OSError`` with a
    real errno, so ``exc.errno == errno.ENOSPC`` checks, the retry
    layer's transient predicate, and tests' ``except FaultInjected``
    all see it for what it is."""


class FaultKill(BaseException):
    """kind=kill: thread-death simulation. Subclasses **BaseException**
    so per-batch/per-job ``except Exception`` rescue code cannot
    swallow it — it unwinds to the top of the owning thread like a
    real death, exercising the respawn/restart paths."""


def _resolve_errno(spec):
    try:
        return int(spec)
    except (TypeError, ValueError):
        pass
    code = getattr(_errno_mod, str(spec).upper(), None)
    if code is None:
        raise MXNetError("faults: unknown errno %r" % (spec,))
    return code


class FaultSpec:
    """One armed fault at one point. Counters are guarded by the owning
    schedule's lock — evaluation happens on whatever thread crosses the
    point, and determinism requires an exact evaluation order per
    thread-independent point."""

    def __init__(self, point_name, kind=None, p=1.0, after=0, times=None,
                 seed=0, latency_ms=None, errno=None, exc=None):
        if point_name not in POINTS:
            raise MXNetError(
                "faults: unknown injection point %r (declared points: %s)"
                % (point_name, ", ".join(sorted(POINTS))))
        if kind is None:
            kind = ("errno" if errno is not None else
                    "latency" if latency_ms is not None else "raise")
        if kind not in _KINDS:
            raise MXNetError("faults: kind must be one of %s, got %r"
                             % ("/".join(_KINDS), kind))
        self.point = point_name
        self.kind = kind
        self.p = float(p)
        self.after = int(after)
        if times is None and kind == "kill":
            times = 1  # a thread only dies once
        self.times = None if times is None else int(times)
        self.seed = int(seed)
        self.latency_ms = float(latency_ms) if latency_ms is not None \
            else 50.0
        self.errno = _resolve_errno(errno) if errno is not None else None
        self.exc = exc
        import random as _pyrandom
        self._rng = _pyrandom.Random(self.seed)
        self.evaluations = 0
        self.fired = 0

    def should_fire(self):
        """One evaluation (caller holds the schedule lock): advance the
        deterministic state, return True when this crossing fires."""
        self.evaluations += 1
        if self.evaluations <= self.after:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        if self.p < 1.0 and self._rng.random() >= self.p:
            return False
        self.fired += 1
        return True

    def build_exception(self):
        if self.kind == "kill":
            return FaultKill("injected kill at %s (firing %d)"
                             % (self.point, self.fired))
        if self.kind == "errno":
            return InjectedIOError(
                self.errno, "injected %s at %s"
                % (_errno_mod.errorcode.get(self.errno, self.errno),
                   self.point))
        if self.exc is not None:
            e = self.exc
            return e() if isinstance(e, type) else e
        return FaultInjected("injected fault at %s (firing %d)"
                             % (self.point, self.fired))

    def describe(self):
        d = {"point": self.point, "kind": self.kind, "p": self.p,
             "after": self.after, "times": self.times, "seed": self.seed,
             "evaluations": self.evaluations, "fired": self.fired}
        if self.kind == "latency":
            d["latency_ms"] = self.latency_ms
        if self.errno is not None:
            d["errno"] = self.errno
        return d


class FaultSchedule:
    """A set of armed :class:`FaultSpec`\\ s, indexed by point."""

    def __init__(self, specs):
        self._lock = _conc.lock("FaultSchedule", "_lock")
        self._by_point = {}
        for s in specs:
            self._by_point.setdefault(s.point, []).append(s)
        self.fired_total = 0

    @property
    def specs(self):
        return [s for lst in self._by_point.values() for s in lst]

    def evaluate(self, name):
        """One crossing of ``name``: fire every spec whose deterministic
        state says so. Latency specs sleep (then later specs still
        evaluate); raising specs raise immediately."""
        specs = self._by_point.get(name)
        if not specs:
            return
        to_fire = []
        with self._lock:
            for s in specs:
                if s.should_fire():
                    to_fire.append(s)
            self.fired_total += len(to_fire)
        for s in to_fire:
            _fire(s)

    def describe(self):
        return [s.describe() for s in self.specs]


def _fire(spec):
    """Telemetry + flight evidence FIRST (a raising fault must still
    leave its trace for the postmortem), then the fault itself."""
    _tel.counter(
        "fault_injected", labels={"point": spec.point, "kind": spec.kind},
        help="injected-fault firings per point and kind "
             "(mxtpu.faults; 0 outside chaos runs)").inc()
    _flight.record("fault", spec.point, spec.kind)
    log.warning("fault injected: %s kind=%s (firing %d)", spec.point,
                spec.kind, spec.fired)
    if spec.kind == "latency":
        # declared blocking seam: an injected (or fuzzed) latency that
        # fires while the crossing thread holds a hierarchy lock is a
        # blocking-under-lock finding — the schedule fuzzer exists to
        # surface exactly that
        _conc.blocking("sleep", "fault latency at %s" % spec.point)
        time.sleep(spec.latency_ms / 1e3)
        return
    raise spec.build_exception()


# ------------------------------------------------------------ the guard
#: the armed schedule; None = off. ``point()`` below is the only reader
#: on hot paths — one module-global read + None test.
_ACTIVE = None
_CONF_LOCK = _conc.lock("injection", "_CONF_LOCK")


def point(name):
    """THE injection guard. Call at a declared seam; free when nothing
    is armed. May sleep (latency), raise (raise/errno), or raise a
    ``BaseException`` (kill) when an armed spec fires."""
    sched = _ACTIVE
    if sched is not None:
        sched.evaluate(name)


def active():
    """The armed :class:`FaultSchedule` (None when off)."""
    return _ACTIVE


def parse_schedule(text):
    """Parse the ``MXTPU_FAULTS`` grammar into a :class:`FaultSchedule`.

    ``point:key=value,key=value;point2:...`` — see the module docstring
    for the keys. Raises :class:`MXNetError` on unknown points/keys so
    a typo'd schedule fails loudly instead of arming nothing."""
    specs = []
    for part in str(text).split(";"):
        part = part.strip()
        if not part:
            continue
        name, _, body = part.partition(":")
        kwargs = {}
        for kv in filter(None, (s.strip() for s in body.split(","))):
            k, eq, v = kv.partition("=")
            if not eq:
                raise MXNetError("faults: expected key=value, got %r "
                                 "in %r" % (kv, part))
            k = k.strip()
            v = v.strip()
            if k in ("p", "latency_ms", "after", "times", "seed"):
                try:
                    kwargs[k] = float(v) if k in ("p", "latency_ms") \
                        else int(v)
                except ValueError:
                    raise MXNetError(
                        "faults: %s=%r is not a number in %r"
                        % (k, v, part))
            elif k in ("kind", "errno"):
                kwargs[k] = v
            else:
                raise MXNetError(
                    "faults: unknown schedule key %r in %r "
                    "(known: kind/errno/latency_ms/p/after/times/seed)"
                    % (k, part))
        specs.append(FaultSpec(name.strip(), **kwargs))
    return FaultSchedule(specs)


def configure(spec=None):
    """Arm a schedule process-wide. ``spec``: a schedule string, a
    :class:`FaultSchedule`, a list of :class:`FaultSpec`, ``None`` =
    re-read ``MXTPU_FAULTS`` (unset/empty = off), or ``False`` = off.
    Returns the armed schedule (or None)."""
    global _ACTIVE
    with _CONF_LOCK:
        if spec is None:
            env = os.environ.get("MXTPU_FAULTS", "").strip()
            spec = env or False
        if spec is False or spec == "":
            _ACTIVE = None
            return None
        if isinstance(spec, str):
            spec = parse_schedule(spec)
        elif isinstance(spec, (list, tuple)):
            spec = FaultSchedule(list(spec))
        if not isinstance(spec, FaultSchedule):
            raise MXNetError("faults.configure: expected a schedule "
                             "string, FaultSchedule, spec list, None, "
                             "or False, got %r" % (spec,))
        _ACTIVE = spec
        log.warning("fault schedule armed: %s",
                    "; ".join("%(point)s kind=%(kind)s" % d
                              for d in spec.describe()))
        for d in spec.describe():
            if d["point"] in UNREACHED:
                log.warning("fault point %s never fires in the port: its "
                            "seam comes with %s", d["point"],
                            UNREACHED[d["point"]])
        return spec


def reset():
    """Disarm (tests' teardown)."""
    global _ACTIVE
    with _CONF_LOCK:
        _ACTIVE = None


class scope:
    """Context manager arming a schedule for a block, restoring the
    previous one (usually None) on exit::

        with faults.scope("kvstore.push:errno=ECONNRESET,p=0.5,seed=3"):
            ...
    """

    def __init__(self, spec):
        self._spec = spec
        self._prev = None
        self.schedule = None

    def __enter__(self):
        self._prev = _ACTIVE
        self.schedule = configure(self._spec)
        return self.schedule

    def __exit__(self, *exc):
        global _ACTIVE
        with _CONF_LOCK:
            _ACTIVE = self._prev
        return False


# env arming at import (the production surface: a canary process sets
# MXTPU_FAULTS and restarts). A schedule that does not parse raises
# here: the port arms what it is told or refuses to start, never
# quietly nothing (mxtpu logs and leaves faults off).
if os.environ.get("MXTPU_FAULTS", "").strip():
    configure(None)
