"""Dynamic batcher: coalesce single-example requests into bucketed batches.

Counterpart of ``mxtpu/serving/batcher.py``: ``pick_bucket``,
``pad_rows``, ``WorkItem``, ``Batch``, the burst ``DynamicBatcher`` and
the ``ContinuousBatcher`` (:366-421) that feeds K-in-flight dispatch
at its refill watermark.
Requests coalesce into a small fixed set of bucket sizes, short batches
are padded with zero rows, and a deadline (``max_delay_ms``) bounds the
latency donated to coalescing. The queue is bounded: ``submit`` on a full
queue raises ``QueueFull`` (HTTP 429).

One delta: ``Batch.finish`` hands each request ``rows_per_example`` rows
of every output, where that is the output's leading dim over the bucket.
A head that flattens (B, T) into B*T rows — the transformer LM's
softmax over ``(B*T, vocab)`` — then answers each request with its own T
rows; for the usual one-row-per-example head it is the JAX behaviour.
"""
from __future__ import annotations

import threading
import time

import numpy as _np

from ..analysis import concurrency as _conc
from ..base import MXNetError
from ..telemetry import current_span as _current_span

__all__ = ["QueueFull", "BatcherClosed", "WorkItem", "Batch",
           "DynamicBatcher", "ContinuousBatcher", "pad_rows", "pick_bucket"]


class QueueFull(MXNetError):
    """Bounded request queue is full — shed load (HTTP 429)."""


class BatcherClosed(MXNetError):
    """Submit after close(): the session is draining."""


def pick_bucket(n, buckets):
    """Smallest bucket >= n; the largest bucket if n exceeds them all."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def pad_rows(arr, bucket):
    """Pad ``arr`` along axis 0 to ``bucket`` rows with zeros."""
    n = arr.shape[0]
    if n == bucket:
        return arr
    pad = _np.zeros((bucket - n,) + arr.shape[1:], dtype=arr.dtype)
    return _np.concatenate([arr, pad], axis=0)


class WorkItem:
    """One client request: a dict of arrays with a leading example dim.
    Completed via an event; carries either results or an error. Deadline
    math uses the monotonic clock."""

    __slots__ = ("inputs", "n", "event", "outputs", "error", "t_enqueue",
                 "expire_at", "span")

    def __init__(self, inputs, n, expire_at=None):
        self.inputs = inputs
        self.n = n
        self.event = threading.Event()
        self.outputs = None
        self.error = None
        self.t_enqueue = time.monotonic()
        self.expire_at = expire_at
        # the submitting thread's ambient telemetry span (mxtpu's :79):
        # the dispatcher parents its batch span here, so one trace id
        # follows a request across the queue hop
        self.span = _current_span()

    def finish(self, outputs):
        self.outputs = outputs
        self.event.set()

    def fail(self, exc):
        self.error = exc
        self.event.set()

    def wait(self, timeout=None):
        if not self.event.wait(timeout):
            raise TimeoutError("request did not complete in %.3fs" % timeout)
        if self.error is not None:
            raise self.error
        return self.outputs


class Batch:
    """Items glued into one padded device call."""

    def __init__(self, items, bucket, input_names):
        self.items = items
        self.bucket = bucket
        self.n_valid = sum(it.n for it in items)
        self.inputs = {}
        for name in input_names:
            rows = _np.concatenate([_np.asarray(it.inputs[name])
                                    for it in items], axis=0)
            self.inputs[name] = pad_rows(rows, bucket)
        # why the batcher released this batch (full/watermark/deadline/
        # drain), stamped per batch: N dispatchers share one batcher
        self.flush_reason = None

    def finish(self, outputs):
        """Slice output rows back to their items and complete them."""
        per = [o.shape[0] // self.bucket for o in outputs]
        row = 0
        for it in self.items:
            it.finish([o[row * p:(row + it.n) * p]
                       for o, p in zip(outputs, per)])
            row += it.n

    def fail(self, exc):
        for it in self.items:
            it.fail(exc)


class DynamicBatcher:
    """Thread-safe request queue with deadline-driven bucketed flushing.

    A batch is released as soon as (a) enough examples are pending to
    fill the LARGEST bucket, or (b) the oldest pending request has waited
    ``max_delay_ms`` and arrivals have paused for ``linger`` (hard cap:
    2x ``max_delay_ms``), or (c) ``close()`` was called and a partial
    tail needs draining."""

    def __init__(self, input_names, buckets=(1, 8, 32, 128),
                 max_delay_ms=5.0, max_queue=256, metrics=None,
                 linger_ms=None, example_shapes=None):
        if not buckets:
            raise MXNetError("DynamicBatcher needs at least one bucket")
        self.input_names = list(input_names)
        self.example_shapes = {k: tuple(v)[1:] for k, v in
                               (example_shapes or {}).items()}
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.max_delay = max_delay_ms / 1000.0
        # arrival-quiescence linger: a deadline flush waits for a
        # streaming wave to pause (hard cap 2x max_delay)
        self.linger = (linger_ms / 1000.0) if linger_ms is not None \
            else self.max_delay / 4.0
        self.max_queue = max_queue
        self._items = []
        self._pending_rows = 0
        self._last_enqueue = 0.0
        self._lock = _conc.lock(type(self).__name__, "_lock")
        self._not_empty = _conc.condition(self._lock)
        self._closed = False
        self._metrics = metrics
        self._last_flush_reason = None

    # ---------------------------------------------------------- producer
    def submit(self, inputs, timeout=None):
        """Enqueue one request (dict name -> array with leading example
        dim). Returns a WorkItem future. Raises QueueFull / BatcherClosed."""
        arrs = {}
        n = None
        for name in self.input_names:
            if name not in inputs:
                raise MXNetError("missing serving input '%s'" % name)
            a = _np.asarray(inputs[name])
            if a.ndim == 0:
                raise MXNetError("serving input '%s' must have a leading "
                                 "example dim" % name)
            want = self.example_shapes.get(name)
            if want is not None and tuple(a.shape[1:]) != want:
                raise MXNetError(
                    "serving input '%s' shape %s does not match per-example"
                    " shape %s" % (name, a.shape[1:], want))
            if n is None:
                n = a.shape[0]
            elif a.shape[0] != n:
                raise MXNetError(
                    "inconsistent leading dims across serving inputs")
            arrs[name] = a
        if n > self.buckets[-1]:
            raise MXNetError("request of %d examples exceeds the largest "
                             "bucket %d" % (n, self.buckets[-1]))
        expire_at = time.monotonic() + timeout if timeout is not None \
            else None
        item = WorkItem(arrs, n, expire_at=expire_at)
        with self._lock:
            if self._closed:
                raise BatcherClosed("serving session is draining")
            if len(self._items) >= self.max_queue:
                if self._metrics:
                    self._metrics.counter("requests_rejected").inc()
                raise QueueFull("serving queue full (%d requests)"
                                % self.max_queue)
            self._items.append(item)
            self._pending_rows += n
            self._last_enqueue = time.monotonic()
            self._not_empty.notify()
        return item

    @property
    def depth(self):
        return len(self._items)

    @property
    def closed(self):
        return self._closed

    @property
    def pending_rows(self):
        """Examples waiting in the queue (admission-control signal)."""
        return self._pending_rows

    # ---------------------------------------------------------- consumer
    def _reap_expired(self, now):
        """Fail timed-out items in place (caller holds the lock)."""
        live = []
        for it in self._items:
            if it.expire_at is not None and now > it.expire_at:
                self._pending_rows -= it.n
                if self._metrics:
                    self._metrics.counter("requests_timed_out").inc()
                it.fail(TimeoutError("request timed out in queue"))
            else:
                live.append(it)
        self._items = live

    def _take_locked(self):
        """Pop a prefix of items filling (at most) the largest bucket."""
        target = self.buckets[-1]
        take, rows = [], 0
        for it in self._items:
            if rows + it.n > target:
                break
            take.append(it)
            rows += it.n
        self._items = self._items[len(take):]
        self._pending_rows -= rows
        return take, rows

    def next_batch(self, timeout=None):
        """Block until a batch is ready; None on drain-complete or idle
        ``timeout`` (seconds). A batch whose arrays fail to assemble fails
        ITS items and the wait resumes."""
        deadline = time.monotonic() + timeout if timeout is not None \
            else None
        return self._next(deadline)

    def _next(self, deadline, ready_rows=None, use_linger=True):
        """The wait/assemble/fail loop behind ``next_batch`` and the
        continuous batcher's ``next_fill``."""
        while True:
            got = self._form_batch(deadline, ready_rows=ready_rows,
                                   use_linger=use_linger)
            if got is None:
                return None
            take, rows, reason = got
            try:
                batch = self._assemble(take, rows)
                batch.flush_reason = reason
                return batch
            except (ValueError, TypeError, MXNetError) as exc:
                for it in take:
                    it.fail(MXNetError("batch assembly failed: %r" % exc))
                if self._metrics:
                    self._metrics.counter("requests_failed").inc(len(take))

    def _form_batch(self, deadline, ready_rows=None, use_linger=True):
        """Wait for and dequeue a batch-worth of items; None on idle
        timeout or drain-complete, else ``(items, rows, reason)``.
        ``ready_rows`` lowers the immediate-flush threshold below the
        largest bucket (the refill watermark); ``use_linger=False``
        flushes at exactly ``max_delay``."""
        target = self.buckets[-1]
        with self._lock:
            while True:
                now = time.monotonic()
                self._reap_expired(now)
                if self._items:
                    age = now - self._items[0].t_enqueue
                    since_arrival = now - self._last_enqueue
                    full = self._pending_rows >= target
                    ready = ready_rows is not None \
                        and self._pending_rows >= ready_rows
                    due = age >= self.max_delay and (
                        not use_linger or since_arrival >= self.linger
                        or age >= 2 * self.max_delay)
                    if full or ready or due or self._closed:
                        take, rows = self._take_locked()
                        if take:
                            reason = ("full" if full else
                                      "watermark" if ready else
                                      "deadline" if due else "drain")
                            self._last_flush_reason = reason
                            return take, rows, reason
                        continue
                    if age < self.max_delay:
                        wait = self.max_delay - age
                    else:  # lingering for the arrival wave to quiesce
                        wait = min(self.linger - since_arrival,
                                   2 * self.max_delay - age)
                    wait = max(wait, 0.0005)
                elif self._closed:
                    return None
                else:
                    wait = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    wait = remaining if wait is None else min(wait,
                                                              remaining)
                self._not_empty.wait(wait)

    def _assemble(self, take, rows):
        bucket = pick_bucket(rows, self.buckets)
        if self._metrics:
            self._metrics.counter("batches_formed").inc()
            self._metrics.counter("batch_rows_valid").inc(rows)
            self._metrics.counter("batch_rows_padded").inc(bucket - rows)
        return Batch(take, bucket, self.input_names)

    def abort(self, exc):
        """Fail every queued request with ``exc`` and stop accepting."""
        with self._lock:
            self._closed = True
            for it in self._items:
                it.fail(exc)
            self._items = []
            self._pending_rows = 0
            self._not_empty.notify_all()

    def close(self):
        """Stop accepting; wake consumers so they drain the tail."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()


class ContinuousBatcher(DynamicBatcher):
    """DynamicBatcher for slot-driven (K-in-flight) consumers.

    The moment a device slot frees, dispatching something beats waiting:
    ``next_fill`` releases a batch as soon as pending rows reach the
    **refill watermark** (no deadline wait), and when the deadline does
    fire it skips the arrival-quiescence linger. With ``hungry=False``
    (every slot occupied) it behaves exactly like the burst batcher. The
    watermark is the ``serving.refill_watermark`` knob; ``next_fill``
    re-reads it per call, so the online controller may move it live."""

    def __init__(self, input_names, refill_watermark=None, **kwargs):
        super().__init__(input_names, **kwargs)
        if refill_watermark is None:
            # a quarter of the largest bucket
            refill_watermark = self.buckets[-1] // 4
        self.refill_watermark = max(1, min(int(refill_watermark),
                                           self.buckets[-1]))

    def next_fill(self, timeout=None, hungry=True):
        """``next_batch`` for a consumer with a free device slot: flush at
        the refill watermark, never linger. ``timeout=0`` polls without
        blocking. None on timeout or drain-complete."""
        deadline = time.monotonic() + timeout if timeout is not None \
            else None
        return self._next(deadline,
                          ready_rows=self.refill_watermark if hungry
                          else None,
                          use_linger=not hungry)

    @property
    def last_flush_reason(self):
        """Most recent flush reason (single-consumer convenience; a
        multi-worker consumer reads ``batch.flush_reason``)."""
        return self._last_flush_reason
