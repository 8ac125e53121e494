"""The shared retry/backoff primitive.

Before this module, every failure domain hand-rolled its own loop (the
elastic ``Supervisor.run`` inline retry) or had none at all (KVStore
transport errors, the snapshot writer's IO path). :class:`RetryPolicy`
is the ONE implementation: bounded attempts, exponential backoff with
**deterministic** jitter (same op/seed/attempt → same delay, run to
run — chaos gates replay exactly; different ops still de-herd), a
retryable-exception predicate, an optional per-attempt recovery hook,
and the ``retry_attempts{op}`` / ``retry_exhausted{op}`` series.

Counterpart of ``mxtpu/faults/retry.py``: the same delays for the same
``(op, seed, attempt)``.

The clock and the sleep are injectable (``clock=``/``sleep=``): tests
drive hours of backoff in microseconds.

Per-attempt timeouts are cooperative: when ``attempt_timeout_s`` is set
and the callable's signature accepts a ``timeout`` keyword, the policy
passes it (and classifies ``TimeoutError`` as retryable by default);
a callable that cannot be bounded is documented as such, not silently
wrapped in a thread.
"""
from __future__ import annotations

import inspect
import logging
import os
import random as _pyrandom
import time
import zlib

from .. import telemetry as _tel
from ..analysis import concurrency as _conc
from ..base import MXNetError

__all__ = ["RetryPolicy", "TRANSIENT_EXCEPTIONS", "env_attempts"]

log = logging.getLogger("mxtpu_torch.faults")

#: the default retryable set: what a transient infrastructure failure
#: looks like from Python — sockets reset, IO hiccups, deadlines.
#: Deliberately excludes MXNetError (usage errors never heal on retry).
TRANSIENT_EXCEPTIONS = (ConnectionError, TimeoutError, OSError)


def env_attempts(name, default_retries):
    """``max_attempts`` from a "<N> RETRIES" env var, with the SAME
    semantics as the original ``MXTPU_ELASTIC_RETRIES``: N retries
    AFTER the first attempt, i.e. ``N + 1`` total attempts (so 0 means
    "one attempt, no retries" — never a crash). Tolerant parse: a bad
    value logs and uses the default — robustness knobs must never
    themselves be a crash source."""
    raw = os.environ.get(name)
    n = default_retries
    if raw is not None:
        try:
            n = int(raw)
        except ValueError:
            log.error("%s=%r is not an integer — using default %d",
                      name, raw, default_retries)
    return max(0, n) + 1


class RetryPolicy:
    """Bounded attempts + exponential backoff with deterministic jitter.

    Parameters
    ----------
    op : str — the label on ``retry_attempts{op}`` / ``retry_exhausted``
        and in log lines; also seeds the jitter, so two ops with the
        same schedule never sleep in lockstep.
    max_attempts : total tries including the first (>= 1).
    backoff_s / backoff_cap_s : exponential base delay and its cap.
    jitter_frac : +/- fraction of the delay drawn deterministically
        from ``(op, seed, attempt)``; 0 disables.
    retryable : an exception class / tuple of classes / predicate
        ``fn(exc) -> bool``; default :data:`TRANSIENT_EXCEPTIONS`.
        Non-retryable exceptions propagate immediately, uncounted.
    recover : optional ``fn(exc, attempt) -> handled`` run before the
        backoff sleep of each retry (the snapshot writer's
        ENOSPC→prune hook); a truthy return skips that retry's sleep
        (the recovery already freed the resource — retry NOW); an
        exception from ``recover`` aborts the retry loop by
        propagating.
    attempt_timeout_s : cooperative per-attempt bound (see module doc).
    seed : jitter seed (with ``op`` and the attempt number).
    sleep / clock : injectable for tests (default ``time.sleep`` /
        ``time.monotonic``). ``clock`` is read around each attempt so
        logs and the exhaustion message carry honest elapsed time.
    """

    def __init__(self, op, max_attempts=3, backoff_s=0.1,
                 backoff_cap_s=30.0, jitter_frac=0.1, retryable=None,
                 recover=None, attempt_timeout_s=None, seed=0,
                 sleep=None, clock=None, logger=None):
        if int(max_attempts) < 1:
            raise MXNetError("RetryPolicy: max_attempts must be >= 1")
        self.op = str(op)
        self.max_attempts = int(max_attempts)
        self.backoff_s = float(backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.jitter_frac = float(jitter_frac)
        self.attempt_timeout_s = attempt_timeout_s
        self.seed = int(seed)
        self._retryable = retryable if retryable is not None \
            else TRANSIENT_EXCEPTIONS
        self._recover = recover
        self._sleep = sleep or time.sleep
        self._clock = clock or time.monotonic
        self._log = logger or log

    # ------------------------------------------------------------ policy
    def is_retryable(self, exc):
        pred = self._retryable
        if isinstance(pred, (type, tuple)):
            return isinstance(exc, pred)
        return bool(pred(exc))

    def backoff(self, attempt):
        """Delay before retry #``attempt`` (1-based): exponential,
        capped, with deterministic jitter — a pure function of
        (op, seed, attempt)."""
        delay = min(self.backoff_s * (2.0 ** (attempt - 1)),
                    self.backoff_cap_s)
        if self.jitter_frac and delay > 0:
            # crc32, not hash(): hash() is salted per process and would
            # break run-to-run determinism
            key = zlib.crc32(("%s:%d:%d" % (self.op, self.seed,
                                            attempt)).encode())
            rng = _pyrandom.Random(key)
            delay *= 1.0 + self.jitter_frac * (2.0 * rng.random() - 1.0)
        return delay

    # -------------------------------------------------------------- run
    def call(self, fn, *args, **kwargs):
        """Run ``fn(*args, **kwargs)`` to success through retryable
        failures; returns its result. Raises the LAST exception on
        exhaustion (after counting ``retry_exhausted{op}``) and any
        non-retryable exception immediately."""
        if self.attempt_timeout_s is not None \
                and "timeout" not in kwargs and _accepts_timeout(fn):
            kwargs = dict(kwargs, timeout=self.attempt_timeout_s)
        t0 = self._clock()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kwargs)
            except Exception as exc:
                if not self.is_retryable(exc):
                    raise
                if attempt >= self.max_attempts:
                    _tel.counter(
                        "retry_exhausted", labels={"op": self.op},
                        help="retry loops that gave up (per op)").inc()
                    self._log.error(
                        "%s: giving up after %d attempts in %.2fs (%r)",
                        self.op, attempt, self._clock() - t0, exc)
                    raise
                _tel.counter(
                    "retry_attempts", labels={"op": self.op},
                    help="retries taken after a transient failure "
                         "(per op; first attempts are not counted)").inc()
                handled = False
                if self._recover is not None:
                    handled = self._recover(exc, attempt)
                delay = 0.0 if handled else self.backoff(attempt)
                self._log.warning(
                    "%s: attempt %d/%d failed (%r) — %s",
                    self.op, attempt, self.max_attempts, exc,
                    "recovered, retrying now" if handled
                    else "retrying in %.3fs" % delay)
                if delay > 0:
                    # declared blocking seam: a retry backoff sleeping
                    # while the caller holds a hierarchy lock stalls
                    # every thread behind that lock for the backoff
                    _conc.blocking("sleep", "retry backoff %s" % self.op)
                    self._sleep(delay)

    def wrap(self, fn):
        """``fn`` with this policy applied (decorator form)."""
        def _wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)
        _wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        return _wrapped


_TIMEOUT_CACHE = {}


def _accepts_timeout(fn):
    key = getattr(fn, "__func__", fn)
    try:
        hit = _TIMEOUT_CACHE.get(key)
    except TypeError:           # unhashable callable
        key = None
        hit = None
    if hit is None:
        try:
            params = inspect.signature(fn).parameters
            hit = "timeout" in params or any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in params.values())
        except (TypeError, ValueError):
            hit = False
        if key is not None:
            _TIMEOUT_CACHE[key] = hit
    return hit
