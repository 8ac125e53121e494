"""Supervisor: act on wedges and preemption instead of just dumping state.

Counterpart of ``mxtpu/elastic/supervisor.py``. The hang watchdog
*detects* a no-progress interval and captures a postmortem; this module
*acts* on it. A :class:`Supervisor` subscribes
to the watchdog's action hook (``diagnostics.add_action``), and the
elastic fit session polls it between steps:

* **wedge** → the fit raises :class:`WedgeAbort` at the next step
  boundary; :meth:`Supervisor.run` catches it, backs off (bounded,
  ``MXTPU_ELASTIC_RETRIES`` × exponential ``MXTPU_ELASTIC_BACKOFF_S``),
  and re-runs the fit with ``resume=True`` — checkpoint-restore-retry
  from the last durable generation, no human in the loop;
* **SIGTERM as a preemption warning** → the handler sets a flag; the fit
  flushes a FINAL synchronous snapshot at the next step boundary and
  raises :class:`Preempted` (not retried — the platform is about to kill
  the process; the next incarnation resumes from that snapshot).

Both exceptions subclass ``MXNetError`` deliberately: they are
controlled exits, so ``Module.fit``'s fatal-exception forensics filter
does not double-dump on them (the wedge postmortem already fired).
"""
from __future__ import annotations

import logging
import os
import signal as _signal
import threading

from .. import diagnostics as _diag
from .. import telemetry as _tel
from ..analysis import concurrency as _conc
from ..base import MXNetError
from ..faults import RetryPolicy

log = logging.getLogger("mxtpu_torch.elastic")

__all__ = ["Preempted", "WedgeAbort", "Supervisor"]


class Preempted(MXNetError):
    """Raised by the elastic fit session after a SIGTERM preemption
    warning, once the final snapshot is durable."""


class WedgeAbort(MXNetError):
    """Raised by the elastic fit session when the watchdog flagged a
    wedge; :meth:`Supervisor.run` turns it into restore-retry."""


class Supervisor:
    """Watchdog-driven preemption/wedge recovery around ``Module.fit``.

    Typical use (docs/elastic.md)::

        sup = mt.elastic.Supervisor()
        cfg = mt.elastic.ElasticConfig("ckpt/run", every_n_steps=50,
                                       supervisor=sup)
        sup.run(lambda resume: mod.fit(it, num_epoch=8, elastic=cfg,
                                       resume=resume))

    ``run`` returns the fit's return value; after ``retries`` failed
    recoveries the last :class:`WedgeAbort` propagates. The supervisor
    is also usable piecemeal: ``attach()``/``detach()`` manage the
    watchdog subscription, ``install_sigterm()`` arms the preemption
    handler (main thread only; chains any existing handler) and
    ``uninstall_sigterm()`` puts the previous one back. The handler is
    process-wide, so ``run`` holds it only while it runs and restores
    the previous handler on every exit path.
    """

    def __init__(self, retries=None, backoff_s=None, backoff_cap_s=60.0,
                 logger=None, sleep=None, clock=None):
        env = os.environ.get
        self.retries = int(retries if retries is not None
                           else env("MXTPU_ELASTIC_RETRIES", "3"))
        self.backoff_s = float(backoff_s if backoff_s is not None
                               else env("MXTPU_ELASTIC_BACKOFF_S", "1.0"))
        self.backoff_cap_s = float(backoff_cap_s)
        self.logger = logger or log
        self._sleep = sleep          # injectable (tests: no real backoff)
        self._clock = clock
        self._lock = _conc.lock("Supervisor", "_lock")
        self._wedge_reason = None
        self._preempted = threading.Event()
        self._attached = False
        self._prev_sigterm = None
        self.retries_done = 0

    # ------------------------------------------------------- wedge signal
    def attach(self):
        """Subscribe to watchdog detections (idempotent)."""
        if not self._attached:
            _diag.add_action(self._on_detect)
            self._attached = True
        return self

    def detach(self):
        if self._attached:
            _diag.remove_action(self._on_detect)
            self._attached = False

    def _on_detect(self, reason):
        # runs on the watchdog thread: flag only, never block — the fit
        # loop turns the flag into a WedgeAbort at its next step boundary
        with self._lock:
            if self._wedge_reason is None:
                self._wedge_reason = str(reason)
        self.logger.warning("elastic supervisor: wedge flagged (%s) — "
                            "restore-retry at the next step boundary",
                            reason)

    def wedge_reason(self):
        with self._lock:
            return self._wedge_reason

    def clear_wedge(self):
        with self._lock:
            self._wedge_reason = None

    # --------------------------------------------------------- preemption
    def install_sigterm(self):
        """SIGTERM = preemption warning (spot/preemptible capacity): set
        the flag and chain the previous handler. Main thread only;
        returns False elsewhere or when ``MXTPU_ELASTIC_SIGTERM=0``."""
        if os.environ.get("MXTPU_ELASTIC_SIGTERM", "1") == "0":
            return False
        try:
            prev = _signal.getsignal(_signal.SIGTERM)

            def _handler(sig, frame):
                # flag ONLY: the handler interrupts the main thread
                # between bytecodes, possibly inside the telemetry
                # registry or a logging lock — touching either here
                # deadlocks the process at the exact moment the final
                # snapshot must flush (same rule as the SIGUSR2 dump
                # handler). The counter/log land in on_step when the
                # flag is consumed.
                self._preempted.set()
                if callable(prev) and prev not in (_signal.SIG_IGN,
                                                   _signal.SIG_DFL):
                    prev(sig, frame)

            _signal.signal(_signal.SIGTERM, _handler)
            # a handler installed outside Python reads as None: the
            # default action is the closest one to put back
            self._prev_sigterm = _signal.SIG_DFL if prev is None else prev
            return True
        except (ValueError, OSError):
            return False  # non-main thread / platform without signals

    def uninstall_sigterm(self):
        """Put back the handler ``install_sigterm`` replaced."""
        if self._prev_sigterm is not None:
            try:
                _signal.signal(_signal.SIGTERM, self._prev_sigterm)
            except (ValueError, OSError):
                pass
            self._prev_sigterm = None

    def preempted(self):
        return self._preempted.is_set()

    def clear_preemption(self):
        self._preempted.clear()

    # -------------------------------------------------------------- run
    def retry_policy(self):
        """This supervisor's knobs as a
        :class:`~mxtpu_torch.faults.RetryPolicy`
        (the ONE shared retry implementation — docs/faults.md): only
        :class:`WedgeAbort` is retryable, jitter off so the backoff
        schedule stays the documented exact exponential."""
        return RetryPolicy(
            "elastic.supervisor", max_attempts=self.retries + 1,
            backoff_s=self.backoff_s, backoff_cap_s=self.backoff_cap_s,
            jitter_frac=0.0, retryable=WedgeAbort,
            recover=self._on_wedge_retry, sleep=self._sleep,
            clock=self._clock, logger=self.logger)

    def _on_wedge_retry(self, exc, attempt):
        """Policy recover hook: bookkeeping per restore-retry. Returns
        False — the wedge needs the backoff, nothing was 'recovered'."""
        self.retries_done = attempt
        _tel.counter("elastic_retries",
                     help="wedge-triggered restore-retry attempts").inc()
        return False

    def run(self, fit_fn):
        """Drive ``fit_fn(resume)`` to completion through wedges.

        ``fit_fn`` is called with ``resume=False`` on the first attempt
        and ``resume=True`` on retries (``Module.fit`` then restores the
        newest durable generation of its elastic prefix — or starts
        fresh when none exists yet), bounded and backed off by
        :meth:`retry_policy`. :class:`Preempted` is never retried (it is
        not a :class:`WedgeAbort`); it propagates after the final
        snapshot is durable."""
        self.attach()
        self.install_sigterm()
        state = {"attempt": 0}

        def one_attempt():
            self.clear_wedge()
            resume = state["attempt"] > 0
            state["attempt"] += 1
            return fit_fn(resume)

        try:
            return self.retry_policy().call(one_attempt)
        except WedgeAbort as exc:
            # exhaustion: keep the historical counter/field semantics
            # (the give-up attempt counts too), then propagate
            self.retries_done = state["attempt"]
            _tel.counter("elastic_retries",
                         help="wedge-triggered restore-retry attempts"
                         ).inc()
            self.logger.error("elastic supervisor: giving up after %d "
                              "retries (%s)", self.retries, exc)
            raise
        finally:
            self.detach()
            self.uninstall_sigterm()
