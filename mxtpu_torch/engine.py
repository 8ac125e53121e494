"""Host-side asynchronous dependency engine.

Counterpart of ``mxtpu/engine.py`` (parity: include/mxnet/engine.h:93-268,
``Engine::Get`` with ``NewVariable``/``PushAsync``/``WaitForVar``/
``WaitForAll``, and the ``MXNET_ENGINE_TYPE`` selection of
src/engine/engine.cc:31-57).

The card's own work is ordered by CUDA streams, so this engine sequences
the host-side task graph instead — prefetch/decode, checkpoint IO,
custom-op callbacks, host staging — with the same read/write-variable
protocol. Two engines, mirroring the reference:

- ``ThreadedEngine`` (default): the native C++ scheduler
  (``src/core/engine.cc``, built by :mod:`mxtpu_torch._native`) via
  ctypes. A failed build raises: there is no quiet fallback to the naive
  engine.
- ``NaiveEngine``: runs every push synchronously on the calling thread,
  only when ``MXTPU_ENGINE_TYPE`` (or ``MXNET_ENGINE_TYPE``) says
  ``NaiveEngine``.

A callback runs on a native worker thread, whose current CUDA device is
its own: a callback that touches a CUDA tensor sets the device from the
tensor (``torch.cuda.device(t.device)``). An exception a callback raises
is kept and raised again by the next ``wait_for_var``/``wait_for_all``.
"""
from __future__ import annotations

import ctypes
import os
import threading
import time

from . import _native
from ._native import check_call
from .base import MXNetError
from .analysis import concurrency as _conc
from . import telemetry as _tel
from .diagnostics import flight as _flight
from .faults import injection as _faults
from .telemetry import tracing as _tracing


class Var:
    """Engine variable handle (parity: engine.h VarHandle)."""

    __slots__ = ("handle", "_engine")

    def __init__(self, handle, engine):
        self.handle = handle
        self._engine = engine


# Engine telemetry series: registered ONCE at module scope, registry-
# direct (immune to MXTPU_TELEMETRY=0 at import — the series must exist
# for /metrics even in a process that started bare), and shared by every
# engine instance. The gauges read the process SINGLETON (tests that
# construct throwaway engines directly never capture them), so a dead
# instance is neither pinned by a closure nor able to shadow the live
# engine's queue depth.
_M_DISPATCHED = _tel.registry().counter(
    "engine_ops_dispatched", help="ops pushed into the engine")
_M_COMPLETED = _tel.registry().counter(
    "engine_ops_completed", help="op callbacks finished")
_M_QUEUE_WAIT = _tel.registry().histogram(
    "engine_queue_wait_ms", help="push -> dispatch latency")
_M_BUSY = _tel.registry().counter(
    "engine_worker_busy_ms", help="total ms spent inside op callbacks; "
    "idle time = wall * workers - busy")


class NaiveEngine:
    """Fully synchronous engine (parity: src/engine/naive_engine.cc:34)."""

    def new_variable(self):
        return Var(None, self)

    def delete_variable(self, var):
        pass

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0):
        _faults.point("engine.dispatch")
        _M_DISPATCHED.inc()
        _flight.record("engine", "push", "sync")
        t0 = time.perf_counter()
        with _tracing.span("engine.dispatch", category="engine"):
            fn()
        _M_BUSY.inc((time.perf_counter() - t0) * 1e3)
        _M_QUEUE_WAIT.observe(0.0)
        _M_COMPLETED.inc()

    def wait_for_var(self, var):
        pass

    def wait_for_all(self):
        pass

    @property
    def num_workers(self):
        return 0

    @property
    def ops_completed(self):
        return 0


class ThreadedEngine:
    """Native C++ dependency engine (src/core/engine.{h,cc})."""

    # the pending table's entries are (fn, push time, pushing span): the
    # span is captured at push time, so the dispatch span on the native
    # worker thread is the pusher's child (contextvars do not follow a
    # ctypes thread by themselves)

    def __init__(self):
        self._lib = _native.get_lib()  # raises MXNetError on a failed build
        self._errors = []
        # One persistent dispatcher CFUNCTYPE for every push: per-op Python
        # closures are kept in a table keyed by the ctx token, so no ctypes
        # thunk is ever freed while a native thread may still be inside it.
        self._pending = {}
        self._pending_lock = _conc.lock("ThreadedEngine", "_pending_lock")
        self._next_token = 0
        self._dispatch_cb = _native.ASYNC_FN(self._dispatch)
        # Drain before interpreter teardown: the native worker threads call
        # back into Python, which must still be alive when they do.
        import atexit

        atexit.register(self.wait_for_all)

    def _dispatch(self, ctx):
        token = int(ctx) if ctx is not None else 0
        with self._pending_lock:
            entry = self._pending.pop(token, None)
        if entry is not None:
            fn, t_push, parent = entry
            t0 = time.perf_counter()
            _M_QUEUE_WAIT.observe((t0 - t_push) * 1e3)
            # the pushing thread's span was captured at push time; running
            # the callback as its child stitches the native-thread hop into
            # one trace (engine push -> worker dispatch)
            try:
                with _tracing.span("engine.dispatch", category="engine",
                                   parent=parent):
                    fn()
            except BaseException as exc:  # a native thread cannot raise:
                self._errors.append(exc)  # the next wait raises it again
            _M_BUSY.inc((time.perf_counter() - t0) * 1e3)
            _M_COMPLETED.inc()

    def new_variable(self):
        h = ctypes.c_void_p()
        check_call(self._lib.MXTPUEngineNewVar(ctypes.byref(h)))
        return Var(h, self)

    def delete_variable(self, var):
        if var.handle is not None:
            check_call(self._lib.MXTPUEngineDeleteVar(var.handle))
            var.handle = None

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0):
        # before the pending-table insert: a raised fault must not leave
        # an orphaned token the native scheduler will never dispatch
        _faults.point("engine.dispatch")
        _M_DISPATCHED.inc()
        with self._pending_lock:
            self._next_token += 1
            token = self._next_token  # nonzero: ctx NULL maps to token 0
            self._pending[token] = (fn, time.perf_counter(),
                                    _tracing.current_span())
        # flight-recorder breadcrumb: a postmortem's last "push" without a
        # matching dispatch span is the op the wedged worker never ran
        _flight.record("engine", "push", token)
        n_c, n_m = len(const_vars), len(mutable_vars)
        cv = (ctypes.c_void_p * max(n_c, 1))(
            *[v.handle for v in const_vars]) if n_c else None
        mv = (ctypes.c_void_p * max(n_m, 1))(
            *[v.handle for v in mutable_vars]) if n_m else None
        check_call(self._lib.MXTPUEnginePushAsync(
            self._dispatch_cb, ctypes.c_void_p(token), cv, n_c, mv, n_m,
            priority))

    def _raise_kept(self):
        if self._errors:
            exc = self._errors.pop(0)
            raise MXNetError("an engine callback raised %s: %s"
                             % (type(exc).__name__, exc)) from exc

    def wait_for_var(self, var):
        if var.handle is not None:
            check_call(self._lib.MXTPUEngineWaitForVar(var.handle))
        self._raise_kept()

    def wait_for_all(self):
        check_call(self._lib.MXTPUEngineWaitForAll())
        self._raise_kept()

    @property
    def num_workers(self):
        out = ctypes.c_int()
        check_call(self._lib.MXTPUEngineNumWorkers(ctypes.byref(out)))
        return out.value

    @property
    def ops_completed(self):
        out = ctypes.c_uint64()
        check_call(self._lib.MXTPUEngineOpsCompleted(ctypes.byref(out)))
        return out.value


_ENGINE = None
_ENGINE_LOCK = _conc.lock("engine", "_ENGINE_LOCK")


def _singleton_queue_depth():
    e = _ENGINE
    return len(e._pending) if isinstance(e, ThreadedEngine) else 0


def _singleton_workers():
    e = _ENGINE
    return e.num_workers if e is not None else 0


_tel.registry().gauge("engine_queue_depth", fn=_singleton_queue_depth,
                      help="ops pushed but not yet dispatched to a worker")
_tel.registry().gauge("engine_workers", fn=_singleton_workers,
                      help="native scheduler worker threads "
                      "(0 = NaiveEngine)")


def get():
    """Engine singleton (parity: Engine::Get, selection engine.cc:31-57)."""
    global _ENGINE
    if _ENGINE is None:
        with _ENGINE_LOCK:
            if _ENGINE is None:
                kind = os.environ.get(
                    "MXTPU_ENGINE_TYPE",
                    os.environ.get("MXNET_ENGINE_TYPE", "ThreadedEngine"))
                if kind == "NaiveEngine":
                    _ENGINE = NaiveEngine()
                elif kind == "ThreadedEngine":
                    _ENGINE = ThreadedEngine()
                else:
                    raise MXNetError(
                        "engine type %r: expected ThreadedEngine or "
                        "NaiveEngine" % kind)
    return _ENGINE


def started():
    """The engine singleton when one was made, else None (``waitall``
    drains an engine that exists and makes none)."""
    return _ENGINE
