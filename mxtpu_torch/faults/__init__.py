"""mxtpu_torch.faults — seeded fault injection + the shared
retry/backoff primitive.

Counterpart of ``mxtpu/faults``: the same points, schedule grammar,
firing sequence and backoff delays.

Two halves of one robustness story:

* :mod:`~mxtpu.faults.injection` — a process-wide, seeded,
  deterministic fault-injection registry with declared points at the
  existing seams (snapshot writer, serving replicas, prefetch
  producers, KVStore transport, device waits, engine dispatch). Armed
  via ``MXTPU_FAULTS`` or :func:`scope`; free (one module-global
  ``None`` check) when off.
* :mod:`~mxtpu.faults.retry` — :class:`RetryPolicy`, the ONE
  bounded-attempts/exponential-backoff/deterministic-jitter
  implementation every failure domain retries through (the elastic
  supervisor, the snapshot writer's IO path, KVStore push/pull).

Together they turn a robustness claim into something a chaos run
demonstrates under injected failure: a kvstore under transient
transport faults stores what it stores without them, and a crashing
prefetch producer surfaces at the consumer.
"""
from __future__ import annotations

from .injection import (POINTS, FaultInjected, FaultKill, FaultSchedule,
                        FaultSpec, InjectedIOError, active, configure,
                        parse_schedule, point, reset, scope)
from .retry import RetryPolicy, TRANSIENT_EXCEPTIONS, env_attempts

__all__ = [
    "POINTS", "FaultInjected", "InjectedIOError", "FaultKill",
    "FaultSpec", "FaultSchedule", "point", "configure", "scope",
    "active", "reset", "parse_schedule",
    "RetryPolicy", "TRANSIENT_EXCEPTIONS", "env_attempts",
]
