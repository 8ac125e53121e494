"""Runtime lock-order witness, blocking-under-lock detection, and the
seeded schedule fuzzer.

Counterpart of ``mxtpu/analysis/concurrency.py``, over the port's own
declarations, telemetry and faults. The witness's evidence series are
emitted directly: nothing here catches an exception to carry on.

The framework around the dependency engine runs several interacting
thread domains (engine workers, serving dispatchers, prefetch
producers, the kvstore heartbeat and server). Their safety argument is
the declared lock hierarchy in
:mod:`mxtpu_torch.analysis.declarations`; this module checks it
**dynamically**, at the level of the high-level constructs (named lock
levels, declared blocking kinds, declared yield points) rather than
instruction interleavings.

Three parts:

* **tracked locks** — :func:`lock` / :func:`rlock` / :func:`condition`
  wrap ``threading`` primitives with the declared ``(owner, attr)``
  key. Disarmed, each acquisition costs one module-global ``None``
  check plus the raw acquire. Armed (:func:`arm` /
  ``MXTPU_CONCURRENCY=1``), the witness keeps a per-thread held-stack
  and a process-wide observed acquisition-order graph, and turns four
  hazard classes into :class:`~mxtpu_torch.analysis.findings.Finding`\\ s:
  hierarchy **inversions**, **cycles** in the observed graph (deadlock
  *potential*, even when none fired), acquisitions of **unregistered**
  locks, and **blocking-under-lock** (a declared blocking call —
  device_wait, bulk device_get, sleep, HTTP — entered while holding any
  tracked hierarchy lock).
* **report surface** — :func:`report` (a
  :class:`~mxtpu_torch.analysis.findings.Report`), :func:`state` (a
  JSON-ready panel), and the ``lock_order_violations`` /
  ``lock_contention_ms{lock=}`` telemetry series.
* **schedule fuzzer** — :class:`ScheduleFuzzer` / :func:`fuzz_scope`
  ride the faults package's latency mode: deterministic, seeded
  perturbation at the declared yield points (the ``faults.POINTS``
  catalog) widens the interleaving space a test explores. Same seed ⇒
  same schedule ⇒ same firings.
"""
from __future__ import annotations

import os as _os
import threading as _threading
import time as _time

from .declarations import (ALLOWED_BLOCKING, ALLOWED_EDGES, BLOCKING_KINDS,
                           LOCK_LEVELS, key_str, lock_rank)
from .findings import ERROR, WARNING, Finding, Report

__all__ = ["TrackedLock", "TrackedRLock", "TrackedCondition",
           "lock", "rlock", "condition", "blocking",
           "ConcurrencyWitness", "arm", "disarm", "armed", "witness",
           "report", "state", "scope", "find_cycles",
           "ScheduleFuzzer", "fuzz_scope"]

PASS_NAME = "concurrency"

# ------------------------------------------------------------ the guard
#: the armed witness; None = off. The tracked-lock fast path below is
#: the only reader on hot paths — one module-global read + None test
#: (one module-global read, the faults guard's convention).
_WITNESS = None

_TLS = _threading.local()  # .held: list of (lock_obj, key, rank_or_None)
#                            .wit: the witness .held belongs to


def _held(w):
    """This thread's held-stack AS SEEN BY witness ``w``. Stamped per
    witness: a stack built under a previous (re-)arming is discarded on
    first touch, so a lock acquired under witness A and released after
    A was disarmed can never leave a stale entry that witness B reads
    as phantom held state (conservative: B misses holds that straddle
    its arming; it never invents them)."""
    if getattr(_TLS, "wit", None) is not w:
        _TLS.wit = w
        _TLS.held = []
    return _TLS.held


class TrackedLock:
    """A ``threading.Lock`` tagged with its declared hierarchy key.

    Drop-in for the raw primitive (``acquire``/``release``/``with``/
    ``locked``); when the witness is disarmed every call forwards to
    the raw lock after one module-global ``None`` test.
    """

    __slots__ = ("_raw", "key", "rank")
    _reentrant = False

    def __init__(self, owner, attr):
        # the wrapped primitive itself is raw by construction
        self._raw = _threading.Lock()  # mxtpu: allow-raw-lock(the tracked
        # factory's own wrapped primitive — tracking it would recurse)
        self.key = (str(owner), str(attr))
        self.rank = lock_rank(self.key)  # (rank, level) or None

    def acquire(self, blocking=True, timeout=-1):
        w = _WITNESS
        if w is None:
            return self._raw.acquire(blocking, timeout)
        return w.acquire(self, blocking, timeout)

    def release(self):
        w = _WITNESS
        if w is not None:
            w.release(self)
        self._raw.release()

    def locked(self):
        return self._raw.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return "<%s %s>" % (type(self).__name__, key_str(self.key))


class TrackedRLock(TrackedLock):
    """Reentrant variant: re-acquisition by the owning thread is NOT a
    hierarchy event (no edge, no violation) — only the outermost
    acquire/release pair touches the held-stack."""

    __slots__ = ()
    _reentrant = True

    def __init__(self, owner, attr):
        TrackedLock.__init__(self, owner, attr)
        self._raw = _threading.RLock()  # mxtpu: allow-raw-lock(wrapped
        # primitive of the tracked factory)

    def locked(self):
        # drop-in parity: threading.RLock has no locked() on this
        # Python — delegate so callers get the raw primitive's exact
        # behavior (AttributeError), never a silently-wrong answer
        return self._raw.locked()


class TrackedCondition:
    """A ``threading.Condition`` over a tracked lock. ``wait`` is a
    declared yield point: the witness drops the condition's lock from
    the held-stack for the duration (the raw condition really releases
    it) — but OTHER locks still held across the wait are a
    blocking-under-lock finding (kind ``cond_wait``)."""

    __slots__ = ("_tlock", "_raw_cond")

    def __init__(self, lock=None, owner=None, attr=None):
        if lock is None:
            lock = TrackedRLock(owner, attr)
        self._tlock = lock
        # mxtpu: allow-raw-lock(the condition wraps the tracked lock's
        # raw primitive — the wrapper above IS the tracking)
        self._raw_cond = _threading.Condition(lock._raw)

    @property
    def key(self):
        return self._tlock.key

    def acquire(self, *a, **kw):
        return self._tlock.acquire(*a, **kw)

    def release(self):
        self._tlock.release()

    def __enter__(self):
        self._tlock.acquire()
        return self

    def __exit__(self, *exc):
        self._tlock.release()
        return False

    def wait(self, timeout=None):
        w = _WITNESS
        if w is None:
            return self._raw_cond.wait(timeout)
        w.begin_wait(self._tlock)
        try:
            return self._raw_cond.wait(timeout)
        finally:
            w.end_wait(self._tlock)

    def wait_for(self, predicate, timeout=None):
        w = _WITNESS
        if w is None:
            return self._raw_cond.wait_for(predicate, timeout)
        w.begin_wait(self._tlock)
        try:
            return self._raw_cond.wait_for(predicate, timeout)
        finally:
            w.end_wait(self._tlock)

    def notify(self, n=1):
        self._raw_cond.notify(n)

    def notify_all(self):
        self._raw_cond.notify_all()

    def __repr__(self):
        return "<TrackedCondition %s>" % key_str(self._tlock.key)


def lock(owner, attr):
    """Create a tracked ``Lock`` declared as ``(owner, attr)`` — the
    key the lint resolves for ``self.<attr>`` / module globals. Every
    ``threading.Lock()`` in mxtpu/ must come through here or carry a
    ``# mxtpu: allow-raw-lock(reason)`` pragma (lint rule
    ``unregistered-lock``)."""
    return TrackedLock(owner, attr)


def rlock(owner, attr):
    return TrackedRLock(owner, attr)


def condition(lock=None, owner=None, attr=None):
    """Tracked ``Condition``: over an existing tracked ``lock``, or —
    like ``threading.Condition()`` — over a fresh internal RLock
    declared as ``(owner, attr)``."""
    return TrackedCondition(lock=lock, owner=owner, attr=attr)


def blocking(kind, detail=None):
    """THE blocking-call guard: call at a declared blocking seam
    (:data:`~mxtpu_torch.analysis.declarations.BLOCKING_KINDS`). Free when
    the witness is disarmed; armed, a caller holding any tracked
    hierarchy lock is recorded as a blocking-under-lock finding."""
    w = _WITNESS
    if w is not None:
        w.note_blocking(kind, detail)


# ------------------------------------------------------------- witness
class ConcurrencyWitness:
    """Process-wide observer fed by every tracked-lock operation.

    All shared structures are guarded by one raw internal lock; the
    per-thread held-stack lives in TLS and is touched lock-free. The
    armed per-acquisition cost (TLS access + one dict update under the
    internal lock) is the price of arming: a diagnosis/CI mode.
    """

    def __init__(self, max_findings=512):
        # RLock, deliberately: a GC-driven weakref finalizer can fire
        # between any two bytecodes — including while THIS thread is
        # inside a witness section — and re-enter via a tracked lock
        # (ledger.free). The in_witness fence routes that re-entry to
        # the raw path, and reentrancy here is the backstop.
        self._lock = _threading.RLock()  # mxtpu: allow-raw-lock(the
        # witness's own bookkeeping lock cannot witness itself)
        self.edges = {}          # key -> set of keys acquired under it
        self.acq_count = {}      # key -> acquisitions
        self.acquisitions = 0
        self.contended = 0
        self.blocked_calls = 0
        self.violations = 0
        self.findings = []
        self.max_findings = int(max_findings)
        self._seen = set()       # dedup key per finding identity
        self.t_armed = _time.time()

    # ------------------------------------------------------- recording
    def _record_finding(self, dedup, finding, series=None):
        """Caller holds the in_witness fence (every entry point below
        sets it): the registry lock the evidence counter takes is
        itself tracked, and must not be witnessed as the instrumented
        thread's own acquisition."""
        with self._lock:
            if dedup in self._seen:
                return
            self._seen.add(dedup)
            if len(self.findings) < self.max_findings:
                self.findings.append(finding)
        if series:
            # lazy: telemetry imports this module at its own import
            from .. import telemetry as _tel
            _tel.counter(series[0], labels=series[1],
                         help=series[2]).inc()

    def acquire(self, tlock, blocking_flag=True, timeout=-1):
        if getattr(_TLS, "in_witness", False):
            # re-entry (evidence emission, or a GC finalizer firing
            # inside a witness section): raw, unobserved
            return tlock._raw.acquire(blocking_flag, timeout)
        # the fence covers the WHOLE instrumented path: any re-entry —
        # including a weakref finalizer interrupting the bookkeeping
        # below and acquiring a tracked lock — takes the raw branch
        # above instead of deadlocking on the witness internals
        _TLS.in_witness = True
        try:
            return self._acquire_observed(tlock, blocking_flag, timeout)
        finally:
            _TLS.in_witness = False

    def _acquire_observed(self, tlock, blocking_flag, timeout):
        held = _held(self)
        if tlock._reentrant:
            for l, _, _ in held:
                if l is tlock:  # reentrant re-acquire: not a hierarchy event
                    got = tlock._raw.acquire(blocking_flag, timeout)
                    if got:
                        held.append((tlock, tlock.key, tlock.rank))
                    return got
        key, rank = tlock.key, tlock.rank
        if held:
            _tl, tk, tr = held[-1]
            if _tl is not tlock:
                with self._lock:
                    self.edges.setdefault(tk, set()).add(key)
                # the inversion check compares against the innermost
                # RANKED entry, not blindly held[-1]: an unregistered
                # (rank=None) lock on top of the stack must not mask an
                # inversion against the ranked lock beneath it
                if tr is None:
                    for _l2, tk2, tr2 in reversed(held):
                        if tr2 is not None and _l2 is not tlock:
                            tk, tr = tk2, tr2
                            break
                if rank is not None and tr is not None \
                        and rank[0] < tr[0] \
                        and (tk, key) not in ALLOWED_EDGES:
                    self.violations += 1
                    self._record_finding(
                        ("inversion", tk, key),
                        Finding(
                            PASS_NAME, ERROR,
                            "acquired '%s' (level %s) while holding '%s' "
                            "(level %s): violates the declared hierarchy"
                            % (key_str(key), rank[1], key_str(tk),
                               tr[1]),
                            node=key_str(key),
                            provenance=(key_str(tk), key_str(key)),
                            fix_hint="acquire in declared order, or move "
                                     "a level / allowlist the edge in "
                                     "analysis/declarations.py with a "
                                     "reason",
                            details={"held": key_str(tk),
                                     "acquired": key_str(key),
                                     "thread":
                                         _threading.current_thread().name}),
                        series=("lock_order_violations", None,
                                "observed acquisitions violating the "
                                "declared lock hierarchy"))
        if rank is None:
            self._record_finding(
                ("unregistered", key),
                Finding(
                    PASS_NAME, WARNING,
                    "acquisition of unregistered lock '%s' (not in "
                    "LOCK_LEVELS)" % key_str(key),
                    node=key_str(key),
                    fix_hint="declare it in analysis/declarations.py "
                             "LOCK_LEVELS at the level matching its "
                             "nesting"))
        # contention-aware acquire: an immediate try first, a timed
        # blocking acquire only when contended (armed mode only)
        got = tlock._raw.acquire(False)
        if not got:
            if not blocking_flag:
                return False
            t0 = _time.perf_counter()
            got = tlock._raw.acquire(True, timeout)
            if got:
                wait_ms = (_time.perf_counter() - t0) * 1e3
                with self._lock:
                    self.contended += 1
                # fence held by acquire(): emission is unobserved
                from .. import telemetry as _tel
                _tel.histogram(
                    "lock_contention_ms",
                    labels={"lock": key_str(key)},
                    help="blocked-acquire wait per tracked lock "
                         "(armed witness only)").observe(wait_ms)
        if got:
            held.append((tlock, key, rank))
            with self._lock:
                self.acquisitions += 1
                self.acq_count[key] = self.acq_count.get(key, 0) + 1
        return got

    def release(self, tlock):
        if getattr(_TLS, "in_witness", False):
            return  # paired with a raw in-witness acquire: no held entry
        held = _held(self)
        # remove the INNERMOST entry for this object (LIFO in the
        # overwhelming case; tolerant of out-of-order release and of
        # locks acquired before arming)
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is tlock:
                del held[i]
                return
        # acquired while disarmed: nothing to unwind

    # condition wait: the condition's own lock leaves the held-stack
    # for the wait (the raw condition really releases it); other held
    # locks make the wait a blocking-under-lock event
    def begin_wait(self, tlock):
        self.note_blocking("cond_wait", key_str(tlock.key),
                           exclude=tlock)
        self.release(tlock)

    def end_wait(self, tlock):
        _held(self).append((tlock, tlock.key, tlock.rank))

    def note_blocking(self, kind, detail=None, exclude=None):
        if getattr(_TLS, "in_witness", False):
            return
        held = _held(self)
        held_keys = [k for l, k, r in held
                     if l is not exclude and r is not None]
        if not held_keys:
            return
        blocked_on = [k for k in held_keys
                      if (kind, k) not in ALLOWED_BLOCKING]
        if not blocked_on:
            return
        _TLS.in_witness = True
        try:
            self._note_blocked(kind, detail, blocked_on)
        finally:
            _TLS.in_witness = False

    def _note_blocked(self, kind, detail, blocked_on):
        with self._lock:
            self.blocked_calls += 1
        self._record_finding(
            ("blocking", kind, tuple(blocked_on)),
            Finding(
                PASS_NAME, ERROR,
                "blocking call '%s'%s while holding %s"
                % (kind, " (%s)" % detail if detail else "",
                   ", ".join(key_str(k) for k in blocked_on)),
                node=kind,
                provenance=tuple(key_str(k) for k in blocked_on),
                fix_hint="move the blocking call outside the lock, or "
                         "allowlist (kind, lock) in "
                         "analysis/declarations.py ALLOWED_BLOCKING "
                         "with a reason",
                details={"kind": kind, "detail": detail,
                         "held": [key_str(k) for k in blocked_on],
                         "thread": _threading.current_thread().name}),
            series=("lock_blocking_under_lock",
                    {"kind": str(kind)},
                    "declared blocking calls entered while holding a "
                    "tracked hierarchy lock"))

    # ------------------------------------------------------- reporting
    def graph(self):
        """Copy of the observed acquisition-order graph
        (key -> sorted list of keys acquired while holding it)."""
        with self._lock:
            return {k: sorted(v) for k, v in self.edges.items()}

    def cycle_findings(self):
        out = []
        for cyc in find_cycles(self.graph()):
            out.append(Finding(
                PASS_NAME, ERROR,
                "cycle in the observed lock acquisition-order graph: %s"
                % " -> ".join(key_str(k) for k in cyc),
                node=key_str(cyc[0]),
                provenance=tuple(key_str(k) for k in cyc),
                fix_hint="a cycle is deadlock POTENTIAL even when no "
                         "deadlock fired — break one edge by reordering "
                         "acquisitions"))
        return out

    def report(self):
        with self._lock:
            findings = list(self.findings)
        return Report(findings + self.cycle_findings(),
                      passes_run=(PASS_NAME,))

    def state(self):
        """JSON-ready snapshot (the ``/debug/state`` panel body)."""
        with self._lock:
            top = sorted(self.acq_count.items(), key=lambda kv: -kv[1])[:12]
            snap = {
                "armed_since": round(self.t_armed, 3),
                "acquisitions": self.acquisitions,
                "tracked_keys": len(self.acq_count),
                "contended_acquires": self.contended,
                "violations": self.violations,
                "blocking_under_lock": self.blocked_calls,
                "findings": len(self.findings),
                "edges": sum(len(v) for v in self.edges.values()),
                "top_locks": [{"lock": key_str(k), "acquisitions": n}
                              for k, n in top],
            }
        cycles = find_cycles(self.graph())
        snap["cycles"] = [[key_str(k) for k in c] for c in cycles]
        snap["acyclic"] = not cycles
        return snap


def find_cycles(graph):
    """Elementary cycles in a ``{node: iterable-of-successors}`` graph
    (iterative DFS; each cycle reported once, rotation-normalized).
    Self-loops count — two distinct instances of one declared key
    nesting is real deadlock potential at key granularity."""
    cycles, seen = [], set()
    for start in sorted(graph):
        stack = [(start, iter(sorted(graph.get(start, ()))))]
        path, on_path = [start], {start}
        while stack:
            node, it = stack[-1]
            advanced = False
            for nxt in it:
                if nxt == start:
                    cyc = tuple(path)
                    norm = min(cyc[i:] + cyc[:i] for i in range(len(cyc)))
                    if norm not in seen:
                        seen.add(norm)
                        cycles.append(list(cyc) + [start])
                elif nxt not in on_path and nxt > start:
                    # only explore nodes > start: each cycle found from
                    # its smallest node exactly once
                    stack.append((nxt, iter(sorted(graph.get(nxt, ())))))
                    path.append(nxt)
                    on_path.add(nxt)
                    advanced = True
                    break
            if not advanced:
                stack.pop()
                on_path.discard(path.pop())
    return cycles


# ------------------------------------------------------------- control
_ARM_LOCK = _threading.Lock()  # mxtpu: allow-raw-lock(arms/disarms the
# witness itself)


def arm(max_findings=512):
    """Arm a fresh witness process-wide (idempotent: re-arming replaces
    the witness and its accumulated state). Arm at a quiesce point —
    locks acquired before arming are invisible until released and
    re-acquired. Returns the armed :class:`ConcurrencyWitness`."""
    global _WITNESS
    with _ARM_LOCK:
        _WITNESS = ConcurrencyWitness(max_findings=max_findings)
        return _WITNESS


def disarm():
    """Disarm (tests' teardown). The last witness's findings remain
    readable via the object :func:`arm` returned."""
    global _WITNESS
    with _ARM_LOCK:
        w, _WITNESS = _WITNESS, None
        return w


def armed():
    return _WITNESS is not None


def witness():
    """The armed :class:`ConcurrencyWitness` (None when off)."""
    return _WITNESS


def report():
    """The armed (or just-disarmed-by-scope) witness's findings as a
    :class:`~mxtpu_torch.analysis.findings.Report`; an empty Report when
    never armed."""
    w = _WITNESS
    if w is None:
        return Report((), passes_run=(PASS_NAME,))
    return w.report()


def state():
    """JSON-ready ``/debug/state`` panel: armed flag + witness counters
    + observed-graph summary."""
    w = _WITNESS
    out = {"armed": w is not None,
           "levels": [lv for lv, _ in LOCK_LEVELS]}
    if w is not None:
        out.update(w.state())
    return out


class scope:
    """Context manager: arm for a block, restore the previous witness
    (usually None) on exit. Exposes ``.witness`` for assertions::

        with concurrency.scope() as w:
            ...
        assert w.report().ok
    """

    def __init__(self, max_findings=512):
        self._max = max_findings
        self.witness = None
        self._prev = None

    def __enter__(self):
        global _WITNESS
        with _ARM_LOCK:
            self._prev = _WITNESS
            self.witness = _WITNESS = ConcurrencyWitness(
                max_findings=self._max)
        return self.witness

    def __exit__(self, *exc):
        global _WITNESS
        with _ARM_LOCK:
            _WITNESS = self._prev
        return False


# -------------------------------------------------------------- fuzzer
class ScheduleFuzzer:
    """Seeded schedule perturbation over the declared yield points.

    Rides the faults package's latency mode: every declared injection point
    (``faults.POINTS`` — the seams where a thread hands work across a
    domain boundary) gets a latency spec whose probability, delay, and
    RNG seed are derived DETERMINISTICALLY from one master seed. Same
    seed ⇒ identical specs ⇒ identical firing sequence, run to run —
    a fuzz-gate failure replays exactly.

    Parameters
    ----------
    seed : master seed
    points : iterable of point names (default: every declared point)
    p : per-evaluation firing probability of each latency spec
    latency_ms : (lo, hi) — each point's delay is drawn once,
        deterministically, from this range
    times : max firings per point (bounds gate wall-clock; the tier-1
        budget rule)
    """

    def __init__(self, seed=0, points=None, p=0.25,
                 latency_ms=(0.2, 2.0), times=16):
        from .. import faults as _faults
        self.seed = int(seed)
        self.points = tuple(points) if points is not None \
            else tuple(sorted(_faults.POINTS))
        unknown = [pt for pt in self.points if pt not in _faults.POINTS]
        if unknown:
            from ..base import MXNetError
            raise MXNetError("ScheduleFuzzer: unknown yield point(s) %s "
                             "(declared: %s)"
                             % (", ".join(unknown),
                                ", ".join(sorted(_faults.POINTS))))
        self.p = float(p)
        self.latency_ms = (float(latency_ms[0]), float(latency_ms[1]))
        self.times = times

    def _derive(self, point):
        """Per-point (seed, latency_ms), stable across runs and
        processes: zlib.crc32 of ``seed:point`` (the retry-jitter
        convention — no salted hash())."""
        import zlib
        h = zlib.crc32(("%d:%s" % (self.seed, point)).encode())
        lo, hi = self.latency_ms
        latency = lo + (h % 1000) / 999.0 * (hi - lo)
        return h & 0x7FFFFFFF, round(latency, 3)

    def specs(self):
        from ..faults import FaultSpec
        out = []
        for pt in self.points:
            s, latency = self._derive(pt)
            out.append(FaultSpec(pt, kind="latency", p=self.p,
                                 latency_ms=latency, seed=s,
                                 times=self.times))
        return out

    def schedule(self):
        from ..faults import FaultSchedule
        return FaultSchedule(self.specs())

    def describe(self):
        """JSON-ready spec list (the determinism contract's test
        surface: equal seeds ⇒ equal describe())."""
        return [s.describe() for s in self.specs()]


class fuzz_scope:
    """Arm a :class:`ScheduleFuzzer`'s schedule for a block (a
    ``faults.scope`` veneer)::

        with concurrency.fuzz_scope(seed=7):
            ... run the racy workload ...
    """

    def __init__(self, seed=0, **kwargs):
        self.fuzzer = ScheduleFuzzer(seed=seed, **kwargs)
        self._scope = None
        self.schedule = None

    def __enter__(self):
        from .. import faults as _faults
        self._scope = _faults.scope(self.fuzzer.schedule())
        self.schedule = self._scope.__enter__()
        return self.schedule

    def __exit__(self, *exc):
        return self._scope.__exit__(*exc)


# env arming at import (CI/canary surface: MXTPU_CONCURRENCY=1 arms the
# witness for the whole process). Tolerant parse per the sanitizer/
# faults convention: any bad value leaves the witness off.
if _os.environ.get("MXTPU_CONCURRENCY", "").strip() \
        in ("1", "true", "on", "arm"):
    arm()
