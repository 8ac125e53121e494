"""Serving front-ends: in-process ``ServingSession`` + stdlib HTTP server.

Counterpart of ``mxtpu/serving/server.py``. ``ServingSession`` is the
composition root: a batcher feeding an ``ExecutorPool`` through one
worker thread per replica, with a ``MetricsRegistry`` observing every
stage. Two dispatch modes:

* ``continuous`` (default): each worker keeps up to K device batches in
  flight (``max_in_flight``, the ``serving.max_in_flight`` knob) and
  refills a freed slot from the queue at the refill watermark
  (``ContinuousBatcher``). Batch N+1's dispatch overlaps batch N's
  forward and batch N-1's answer copy (the pool's pinned host tensors
  and streams). Signal-driven admission (``serving.admission``) sheds with
  429 before the queue wait blows the latency budget. ``swap_model``
  pre-warms the incoming version in the process-wide warm cache, then
  flips the pool pointer: in-flight batches finish on the old version,
  no request fails. A worker that dies quarantines its replica
  (``healthy_replicas`` and admission see the lost capacity) and a
  respawn thread rebuilds and re-warms it.
* ``burst``: dispatch, wait, answer, repeat; the baseline.

Routes (a thin JSON veneer over ``ThreadingHTTPServer``):

    POST /v1/predict     {"inputs": {"data": [[...]]}} -> {"outputs": [...]}
    POST /v1/generate    {"prompt": [ids], ...} -> tokens (decode session;
                         ``?stream=1`` = chunked NDJSON token stream)
    GET  /v1/metrics     serving metrics JSON
    GET  /metrics        Prometheus text (``?format=json`` for JSON)
    GET  /v1/version     active model version / generation / symbol hash
    POST /v1/admin/swap  {"symbol_file", "params_file", "version_tag"}
                         (needs the admin token in ``X-Admin-Token``)
    GET  /healthz        liveness (200 while accepting, 503 draining)
    GET  /debug/state    diagnostics.debug_state() with the serving panels
                         (``serving``, ``serving_admission``,
                         ``serving_version``, ``serving_warm_cache``,
                         ``decode``)
    GET  /debug/trace    the captured timeline as Chrome trace JSON

Overload taxonomy: **429** = shed (policy or full queue), **504** = the
request out-waited its own deadline in the queue, **503** = the session
is draining. Shutdown drains: the queue closes, in-flight batches finish
and answer, then workers exit.

Deltas from mxtpu: a session without ``contexts`` serves on the CUDA
devices and raises when there is none; each replica is warmed on its
own worker thread before the session accepts (cuDNN keeps its plans per
thread), its ms in ``warmup_ms``; and ``close`` gives back the
warm-cache versions the session served (``WarmExecutableCache.hold`` /
``drop``), so their device weights go with the last session that holds
them.
"""
from __future__ import annotations

import json
import logging
import math
import threading
import time
import weakref
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as _np

from .. import diagnostics as _diag
from .. import telemetry as _tel
from ..analysis import concurrency as _conc
from ..base import MXNetError, NumericsError
from ..compile import pipeline as _pipeline
from ..faults import RetryPolicy, env_attempts
from ..obs import corpus as _obs_corpus
from .admission import (ACCEPTING, AdmissionShed, AdmissionSignals,
                        SignalAdmissionPolicy, STATE_NAMES, derive_knobs,
                        mix_service_model)
from .batcher import (BatcherClosed, ContinuousBatcher, DynamicBatcher,
                      QueueFull)
from .metrics import MetricsRegistry
from .pool import ExecutorPool, warm_cache

__all__ = ["ServingSession", "ServingHTTPServer", "serve", "ReplicaCrash",
           "DEFAULT_BUCKETS"]

log = logging.getLogger("mxtpu_torch.serving")

DEFAULT_BUCKETS = (1, 8, 32, 128)


class ReplicaCrash(Exception):
    """A replica worker died with the batch's fate attached. Not an
    MXNetError: the HTTP layer answers 500 and a postmortem is taken."""


class _InFlight:
    """One dispatched-but-unretired batch in a worker's slot window."""

    __slots__ = ("batch", "handle", "rep", "t_dispatch")

    def __init__(self, batch, handle, rep, t_dispatch):
        self.batch = batch
        self.handle = handle
        self.rep = rep
        self.t_dispatch = t_dispatch


class ServingSession:
    """Batching inference service over one hot-swappable model.

    Parameters
    ----------
    symbol_json : str or Symbol — the inference graph
    params : dict — weights (``arg:``/``aux:`` convention)
    example_shapes : dict name -> per-request shape WITH leading dim 1
    buckets : allowed batch sizes (every one is warmed at startup)
    max_delay_ms : batching deadline before a padded partial batch flushes
    max_queue : bounded queue depth; beyond it ``predict`` raises QueueFull
    contexts : device contexts (default: one replica per CUDA device)
    warmup : warm every (replica, bucket) on its worker before accepting
    default_timeout : per-request timeout in seconds (None: wait)
    mode : "continuous" (K-in-flight refilled dispatch, default) or
        "burst"
    max_in_flight : device batches each worker keeps in flight
        (continuous mode; knob ``serving.max_in_flight``, 2)
    refill_watermark : pending rows that refill a freed slot at once;
        "auto" derives it from the warmup cost rows (``derive_knobs``)
    admission : an ``AdmissionPolicy``, None, or "auto"
        (``SignalAdmissionPolicy`` in continuous mode, None in burst)
    version_tag : this weight set's name in the warm cache (distinct
        weights need distinct tags)
    mem_budget_bytes : device-memory budget for the admission headroom
        signal (knob ``serving.mem_budget_bytes``; unset = off)
    queue_wait_budget_ms : admission latency budget (default half the
        ``default_timeout`` if set, else 1000 ms)
    tuned : a TunedConfig artifact (or path) the knobs above default from
        (``default < artifact < env < explicit argument``)
    """

    def __init__(self, symbol_json, params, example_shapes,
                 buckets=DEFAULT_BUCKETS, max_delay_ms=None, max_queue=None,
                 contexts=None, cache_size=8, warmup=True,
                 default_timeout=None, mode="continuous", max_in_flight=None,
                 refill_watermark="auto", admission="auto",
                 version_tag="v0", mem_budget_bytes=None,
                 queue_wait_budget_ms=None, tuned=None):
        from .. import tune as _tune
        if mode not in ("continuous", "burst"):
            raise MXNetError("serving mode must be 'continuous' or "
                             "'burst', got %r" % (mode,))
        self.mode = mode
        self.metrics = MetricsRegistry()
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.default_timeout = default_timeout
        tuned = _tune.artifact(tuned)
        self._tuned = tuned
        self.max_in_flight = _tune.resolve_int(
            "serving.max_in_flight", explicit=max_in_flight,
            artifact=tuned, floor=1)
        max_queue = _tune.resolve_int("serving.max_queue",
                                      explicit=max_queue, artifact=tuned)
        max_delay_ms = _tune.resolve("serving.max_delay_ms",
                                     explicit=max_delay_ms, artifact=tuned)
        self.version_tag = version_tag
        self._generation = 0
        self._swap_seq = 0
        self._mem_budget = _tune.resolve(
            "serving.mem_budget_bytes", explicit=mem_budget_bytes,
            artifact=tuned) or None
        # the per-replica bind LRU must hold every bucket
        self._cache_size = max(cache_size, len(self.buckets))
        self._pool = ExecutorPool(symbol_json, params, example_shapes,
                                  contexts=contexts,
                                  cache_size=self._cache_size,
                                  metrics=self.metrics,
                                  version_tag=version_tag)
        warm_cache().hold(self._pool.symbol_hash, version_tag, self)
        self._contexts = [r.ctx for r in self._pool.replicas]
        # program builds of this session's executors: flat under traffic
        # once warm. The listener holds the pools weakly and closes over
        # the counter, never the session.
        builds = self.metrics.counter("program_builds")
        self._pool_ref = [weakref.ref(self._pool)]

        def on_build(kind, ex, _c=builds, _refs=self._pool_ref):
            for r in _refs:
                p = r()
                if p is not None and p.owns_executor(ex):
                    _c.inc()
                    return

        self._build_listener = _pipeline.add_build_listener(on_build)
        # the hang watchdog and the SIGUSR2 postmortem handler (given
        # back at close)
        _diag.on_session_start()
        n = len(self._pool.replicas)
        self._swap_lock = _conc.lock("ServingSession", "_swap_lock")
        self._inflight_n = [0] * n
        self._last_retire_t = [None] * n
        # per-worker per-bucket (count, sum_ms) service aggregates: one
        # writer each, merged lock-free by admission
        self._bucket_service = [{} for _ in range(n)]
        self._quarantined = [False] * n
        self._admission = None
        self._admission_state = ACCEPTING
        self._sheds_by_reason = {}
        self._last_shed_reason = None
        self._closed = False
        self.batcher = None
        self._ready = threading.Event()
        warms = [{"done": threading.Event()} if warmup else None
                 for _ in range(n)]
        self._workers = [self._spawn_worker(i, warms[i]) for i in range(n)]
        self.warmup_ms = {}
        for warm in filter(None, warms):
            warm["done"].wait()
            if "error" in warm:
                self._abort_start()
                raise warm["error"]
            self.warmup_ms.update(warm["ms"])
        # knobs from the measured cost rows
        knobs = derive_knobs(self._pool.bucket_costs(), self.buckets)
        if refill_watermark == "auto":
            refill_watermark = _tune.resolve("serving.refill_watermark",
                                             artifact=tuned)
            if refill_watermark is None:
                refill_watermark = knobs["refill_watermark"]
        if mode == "continuous":
            self.batcher = ContinuousBatcher(
                list(example_shapes), buckets=self.buckets,
                max_delay_ms=max_delay_ms, max_queue=max_queue,
                metrics=self.metrics, example_shapes=example_shapes,
                refill_watermark=refill_watermark)
        else:
            self.batcher = DynamicBatcher(
                list(example_shapes), buckets=self.buckets,
                max_delay_ms=max_delay_ms, max_queue=max_queue,
                metrics=self.metrics, example_shapes=example_shapes)
        queue_wait_budget_ms = _tune.resolve(
            "serving.queue_wait_budget_ms", explicit=queue_wait_budget_ms,
            artifact=tuned)
        if queue_wait_budget_ms is None:
            queue_wait_budget_ms = 500.0 * default_timeout \
                if default_timeout else 1000.0
        if admission == "auto":
            admission = SignalAdmissionPolicy(
                queue_wait_budget_ms=queue_wait_budget_ms,
                watchdog_shed_s=_tune.resolve("serving.watchdog_shed_s",
                                              artifact=tuned),
                min_mem_headroom=_tune.resolve("serving.min_mem_headroom",
                                               artifact=tuned),
                queue_frac_shed=_tune.resolve("serving.queue_frac_shed",
                                              artifact=tuned),
                degrade_frac=_tune.resolve("serving.degrade_frac",
                                           artifact=tuned)) \
                if mode == "continuous" else None
        if admission is not None and not hasattr(admission, "decide"):
            self._abort_start()
            raise MXNetError("admission must be an AdmissionPolicy "
                             "(got %r)" % (admission,))
        self._admission = admission
        self.metrics.gauge("queue_depth", fn=lambda: self.batcher.depth)
        self.metrics.gauge("replicas", fn=lambda: len(self._pool))
        self.metrics.gauge("replicas_healthy",
                           fn=lambda: self.healthy_replicas())
        self.metrics.gauge("inflight_depth",
                           fn=lambda: sum(self._inflight_n))
        self.metrics.gauge("admission_state",
                           fn=lambda: self._admission_state)
        self._ready.set()

    def _abort_start(self):
        """A failed start: stop the workers and give back what the
        constructor installed."""
        self._closed = True
        self._ready.set()
        for w in self._workers:
            w.join(timeout=60)
        _pipeline.remove_build_listener(self._build_listener)
        _diag.on_session_end()
        warm_cache().drop(self)

    # ------------------------------------------------------------- pool
    @property
    def pool(self):
        """The active pool (a hot-swap flips this pointer)."""
        return self._pool

    @property
    def example_shapes(self):
        return self._pool.example_shapes

    # ---------------------------------------------------------- hot-swap
    def swap_model(self, symbol_json, params, version_tag=None,
                   warmup=True):
        """Zero-downtime rollout: build and pre-warm the incoming version
        while the old one serves, then flip the pool pointer. Batches
        dispatched before the flip finish on the old version; a rollback
        to a tag the warm cache still holds adopts it and builds nothing.
        Distinct weights need distinct tags (default ``v<n>``)."""
        if self._closed:
            raise BatcherClosed("serving session is closed")
        if version_tag is None:
            with self._swap_lock:
                self._swap_seq += 1
                version_tag = "v%d" % self._swap_seq
        new_pool = ExecutorPool(symbol_json, params, self.example_shapes,
                                contexts=self._contexts,
                                cache_size=self._cache_size,
                                metrics=self.metrics,
                                version_tag=version_tag)
        if len(new_pool) != len(self._pool):
            raise MXNetError(
                "swap_model: replica count changed (%d -> %d); workers "
                "are pinned per replica" % (len(self._pool), len(new_pool)))
        # attribute the new pool's builds before it warms
        self._pool_ref.insert(0, weakref.ref(new_pool))
        warm_cache().hold(new_pool.symbol_hash, version_tag, self)
        if warmup:
            with self.metrics.span("swap_warmup"):
                new_pool.warmup(self.buckets)
        with self._swap_lock:
            self._pool = new_pool
            self._generation += 1
            self.version_tag = version_tag
            # the new model's service profile is learnt afresh
            self._bucket_service = [{} for _ in new_pool.replicas]
            del self._pool_ref[2:]
        self.metrics.counter("model_swaps").inc()
        return self.version_info()

    def version_info(self):
        return {"version": self.version_tag,
                "generation": self._generation,
                "symbol_hash": self._pool.symbol_hash,
                "mode": self.mode,
                "swaps": int(self.metrics.counter("model_swaps").value)}

    # --------------------------------------------------------- admission
    #: per-bucket observations before the aggregate halves
    _SERVICE_WINDOW = 2048

    def _record_service(self, idx, bucket, service_ms):
        """One retired batch's marginal service time: into worker
        ``idx``'s per-bucket aggregate and ``batch_service_ms`` (overall
        and ``bucket=``-labeled), and the corpus's service row."""
        d = self._bucket_service[idx]
        n, s = d.get(bucket, (0, 0.0))
        if n >= self._SERVICE_WINDOW:
            n, s = n // 2, s / 2.0
        d[bucket] = (n + 1, s + service_ms)
        self.metrics.histogram("batch_service_ms").observe(service_ms)
        self.metrics.histogram(
            "batch_service_ms",
            labels={"bucket": str(bucket)}).observe(service_ms)
        if _obs_corpus.enabled():
            _obs_corpus.record_service("serving", service_ms,
                                       bucket=bucket)

    def _service_model(self):
        """The queue-drain model admission budgets with: the live
        per-bucket mix, else the warmup cost rows
        (:func:`mix_service_model`)."""
        merged = {}
        for d in self._bucket_service:
            for b, (n, s) in list(d.items()):
                pn, ps = merged.get(b, (0, 0.0))
                merged[b] = (pn + n, ps + s)
        live = {b: (n, s / n) for b, (n, s) in merged.items() if n}
        return mix_service_model(live, self._pool.bucket_costs(),
                                 self.buckets)

    def _est_batch_ms(self):
        return self._service_model()["est_batch_ms"]

    def _signals(self):
        """Point-in-time :class:`AdmissionSignals`: lock-free reads of
        what the hot path already maintains."""
        model = self._service_model()
        est = model["est_batch_ms"]
        pending = self.batcher.pending_rows
        rows_per_batch = max(1.0, model["est_rows_per_batch"])
        inflight = sum(self._inflight_n)
        healthy = self.healthy_replicas()
        n_rep = max(1, healthy)
        batches_ahead = math.ceil(pending / rows_per_batch) + inflight
        age = _diag.progress_age_s()
        for w in _diag.active_waits():
            age = max(age, w["age_s"])
        mem = None
        if self._mem_budget:
            mem = max(0.0, 1.0 - _diag.ledger().live_bytes()
                      / self._mem_budget)
        return AdmissionSignals(
            queue_depth=self.batcher.depth,
            queue_limit=self.batcher.max_queue,
            pending_rows=pending,
            inflight_depth=inflight,
            inflight_limit=self.max_in_flight * healthy,
            replicas=healthy,
            est_batch_ms=est,
            est_queue_wait_ms=est * batches_ahead / n_rep,
            watchdog_age_s=age,
            mem_headroom_frac=mem)

    def _admit(self):
        pol = self._admission
        if pol is None:
            return
        decision = pol.decide(self._signals())
        self._admission_state = decision.state
        if not decision.admit:
            reason_key = decision.reason.split(":")[0]
            self.metrics.counter("requests_shed",
                                 labels={"reason": reason_key}).inc()
            self._sheds_by_reason[reason_key] = \
                self._sheds_by_reason.get(reason_key, 0) + 1
            self._last_shed_reason = decision.reason
            raise AdmissionShed("admission control: %s" % decision.reason)

    def admission_snapshot(self):
        """The ``serving_admission`` panel: state, sheds by reason, the
        service model and the live signals."""
        return {"state": STATE_NAMES.get(self._admission_state,
                                         self._admission_state),
                "policy": type(self._admission).__name__
                if self._admission is not None else None,
                "sheds_by_reason": dict(self._sheds_by_reason),
                "last_shed_reason": self._last_shed_reason,
                "service_model": self._service_model(),
                "signals": self._signals().to_dict()}

    # ------------------------------------------------------------ workers
    def _spawn_worker(self, idx, warm=None):
        t = threading.Thread(target=self._worker_main, args=(idx, warm),
                             daemon=True,
                             name="mxtpu-torch-serving-%d" % idx)
        t.start()
        return t

    def healthy_replicas(self):
        """Replica slots with a live (non-quarantined) worker."""
        return sum(1 for q in self._quarantined if not q)

    def _worker_main(self, idx, warm=None):
        """The worker's outermost frame. It binds the replica's device,
        warms the replica when ``warm`` is given, waits until the session
        accepts, then loops. A loop that returns is a drain; anything
        else, a ``BaseException`` such as an injected kill included, is
        a worker death: quarantine and respawn."""
        self._pool.replicas[idx].bind_thread()
        if warm is not None:
            try:
                rep = self._pool.replicas[idx]
                warm["ms"] = self._pool.warmup_replica(rep, self.buckets)
            except BaseException as exc:  # re-raised by the constructor
                warm["error"] = exc
                return
            finally:
                warm["done"].set()
        self._ready.wait()
        if self.batcher is None:
            return  # the start failed
        inflight = deque()
        loop = self._continuous_loop if self.mode == "continuous" \
            else self._burst_loop
        try:
            loop(idx, inflight)
        except BaseException as exc:
            self._on_worker_death(idx, inflight, exc,
                                  respawn=not self._closed)

    def _on_worker_death(self, idx, inflight, exc, respawn=True):
        """Quarantine replica ``idx``: answer every in-flight waiter with
        a ReplicaCrash, shrink the advertised capacity, and start the
        rebuild and respawn off the hot path."""
        crash = ReplicaCrash("serving replica %d died: %s: %s"
                             % (idx, type(exc).__name__, exc))
        while inflight:
            self._fail_batch(inflight.popleft().batch, crash)
        self._inflight_n[idx] = 0
        if not respawn:
            return
        self._quarantined[idx] = True
        self.metrics.counter("replica_quarantined").inc()
        _diag.record("serving", "replica_quarantined", idx)
        log.error("serving: worker %d died (%s: %s); replica "
                  "quarantined, capacity %d/%d, respawning",
                  idx, type(exc).__name__, exc,
                  self.healthy_replicas(), len(self._pool.replicas))
        threading.Thread(target=self._respawn_replica, args=(idx,),
                         daemon=True,
                         name="mxtpu-torch-serving-respawn-%d" % idx).start()

    def _respawn_replica(self, idx):
        """Rebuild the dead replica's predictor (fresh: its cached state
        is not trusted), re-warm its buckets, clear the quarantine and
        start a new worker. Bounded by the shared RetryPolicy; a rebuild
        that exhausts its retries leaves the replica quarantined."""
        def rebuild():
            pool = self._pool
            rep = pool.rebuild_replica(idx % len(pool.replicas))
            rep.bind_thread()
            pool.warmup_replica(rep, self.buckets)

        try:
            policy = RetryPolicy(
                "serving.respawn",
                max_attempts=env_attempts(
                    "MXTPU_SERVING_RESPAWN_RETRIES", 1),
                backoff_s=0.2, backoff_cap_s=5.0, retryable=Exception,
                logger=log)
            policy.call(rebuild)
        except BaseException as rebuild_exc:
            # a kill firing inside the re-warm lands here too: the
            # replica stays quarantined, counted and logged
            self.metrics.counter("replica_respawned",
                                 labels={"outcome": "failed"}).inc()
            log.error("serving: replica %d rebuild failed (%r); staying "
                      "quarantined at capacity %d/%d", idx, rebuild_exc,
                      self.healthy_replicas(), len(self._pool.replicas))
            return
        if self._closed:
            return
        self._last_retire_t[idx] = None
        self._quarantined[idx] = False
        self._workers[idx] = self._spawn_worker(idx)
        self.metrics.counter("replica_respawned",
                             labels={"outcome": "ok"}).inc()
        _diag.record("serving", "replica_respawned", idx)
        log.warning("serving: replica %d respawned; capacity %d/%d",
                    idx, self.healthy_replicas(), len(self._pool.replicas))

    def _fail_batch(self, batch, exc):
        """Answer a batch's requests with ``exc``; a backend failure (not
        an MXNetError) takes a postmortem."""
        batch.fail(exc)
        self.metrics.counter("requests_failed").inc(len(batch.items))
        if not isinstance(exc, MXNetError):
            _diag.postmortem("serving_batch_exception", exc=exc,
                             source="serving")

    def _answer(self, batch, rep, handle):
        """Collect a dispatched batch and hand each request its rows."""
        batch.finish(rep.collect(handle))

    def _retire(self, inf, idx):
        """Materialize one in-flight batch's outputs and answer its
        requests. The batch is already out of the worker's window, so a
        ``BaseException`` answers its waiters before unwinding."""
        batch = inf.batch
        try:
            self._answer(batch, inf.rep, inf.handle)
            now = time.monotonic()
            self.metrics.counter("requests_completed").inc(len(batch.items))
            self.metrics.histogram("batch_exec_ms").observe(
                (now - inf.t_dispatch) * 1e3)
            # marginal service time: since the previous retire when this
            # batch overlapped it, else since its own dispatch
            prev = self._last_retire_t[idx]
            base = prev if prev is not None and prev > inf.t_dispatch \
                else inf.t_dispatch
            self._record_service(idx, batch.bucket, (now - base) * 1e3)
            self._last_retire_t[idx] = now
            for it in batch.items:
                self.metrics.histogram("request_latency_ms").observe(
                    (now - it.t_enqueue) * 1e3)
        except Exception as exc:
            self._fail_batch(batch, exc)
        except BaseException as exc:
            self._fail_batch(batch, ReplicaCrash(
                "serving replica died retiring a batch: %s: %s"
                % (type(exc).__name__, exc)))
            raise

    def _pop_retire(self, inflight, idx):
        self._retire(inflight.popleft(), idx)
        self._inflight_n[idx] = len(inflight)
        return time.monotonic()

    def _continuous_loop(self, idx, inflight):
        """Keep up to K batches in flight; refill a freed slot from the
        queue within one dispatch cycle. The only blocking wait is the
        retire of the oldest batch, by which time the card runs the
        newer ones."""
        t_slot_free = None    # a retire freed a slot at this time
        t_device_idle = None  # nothing in flight since this time
        while True:
            # re-read every cycle: the online controller may move it
            k = max(1, self.max_in_flight)
            if len(inflight) >= k:
                t_slot_free = self._pop_retire(inflight, idx)
                if not inflight:
                    t_device_idle = t_slot_free
                continue
            # with work in flight, poll the queue: a wait here would
            # delay the retire of completed batches
            batch = self.batcher.next_fill(
                timeout=0.0 if inflight else 0.25, hungry=True)
            if batch is None:
                if inflight:
                    t_slot_free = self._pop_retire(inflight, idx)
                    if not inflight:
                        t_device_idle = t_slot_free
                    continue
                if self.batcher.closed and self.batcher.depth == 0:
                    return
                continue
            now = time.monotonic()
            if t_slot_free is not None:
                self.metrics.histogram("refill_latency_ms").observe(
                    (now - t_slot_free) * 1e3)
                t_slot_free = None
            if t_device_idle is not None:
                self.metrics.histogram("dispatch_idle_gap_ms").observe(
                    (now - t_device_idle) * 1e3)
                t_device_idle = None
            if batch.flush_reason == "watermark":
                self.metrics.counter("batches_refilled").inc()
            pool = self._pool  # one read: a hot-swap flips this
            rep = pool.replicas[idx % len(pool.replicas)]
            try:
                with _tel.span("batch[%d]" % batch.bucket,
                               category="serving",
                               parent=batch.items[0].span,
                               tags={"n_valid": batch.n_valid}):
                    with self.metrics.span("pool.dispatch"):
                        handle = rep.dispatch(batch.inputs)
            except Exception as exc:
                self._fail_batch(batch, exc)
                continue
            except BaseException as exc:
                # not yet in the window _worker_main rescues
                self._fail_batch(batch, ReplicaCrash(
                    "serving replica %d died dispatching: %s: %s"
                    % (idx, type(exc).__name__, exc)))
                raise
            self.metrics.counter("batches_dispatched").inc()
            inflight.append(_InFlight(batch, handle, rep, now))
            self._inflight_n[idx] = len(inflight)

    def _burst_loop(self, idx, inflight):
        """Pull a batch, run it to completion, answer its requests. The
        card idles from each batch's end to the next dispatch, which
        ``dispatch_idle_gap_ms`` shows."""
        del inflight
        t_idle = None
        while True:
            batch = self.batcher.next_batch(timeout=0.25)
            if batch is None:
                if self.batcher.closed and self.batcher.depth == 0:
                    return
                continue
            t0 = time.monotonic()
            if t_idle is not None:
                self.metrics.histogram("dispatch_idle_gap_ms").observe(
                    (t0 - t_idle) * 1e3)
            pool = self._pool
            rep = pool.replicas[idx % len(pool.replicas)]
            try:
                with _tel.span("batch[%d]" % batch.bucket,
                               category="serving",
                               parent=batch.items[0].span,
                               tags={"n_valid": batch.n_valid}):
                    with self.metrics.span("pool.run"):
                        self._answer(batch, rep,
                                     rep.dispatch(batch.inputs))
                self.metrics.counter("batches_dispatched").inc()
                self.metrics.counter("requests_completed").inc(
                    len(batch.items))
                done = time.monotonic()
                self.metrics.histogram("batch_exec_ms").observe(
                    (done - t0) * 1e3)
                self._record_service(idx, batch.bucket, (done - t0) * 1e3)
                for it in batch.items:
                    self.metrics.histogram("request_latency_ms").observe(
                        (done - it.t_enqueue) * 1e3)
            except Exception as exc:  # answer, keep the worker
                self._fail_batch(batch, exc)
            except BaseException as exc:
                self._fail_batch(batch, ReplicaCrash(
                    "serving replica %d died mid-batch: %s: %s"
                    % (idx, type(exc).__name__, exc)))
                raise
            t_idle = time.monotonic()

    # ------------------------------------------------------------ client
    def predict(self, inputs, timeout=None):
        """Synchronous single-request inference: dict of arrays (leading
        dim = #examples) -> list of numpy outputs. Raises
        AdmissionShed/QueueFull under backpressure (429) and TimeoutError
        past ``timeout`` (504)."""
        if self._closed:
            raise BatcherClosed("serving session is closed")
        timeout = timeout if timeout is not None else self.default_timeout
        self.metrics.counter("requests_received").inc()
        self._admit()
        with self.metrics.span("serving.request"):
            item = self.batcher.submit(inputs, timeout=timeout)
            return item.wait(timeout)

    def predict_async(self, inputs, timeout=None):
        """Enqueue and return the WorkItem future (``.wait(timeout)``)."""
        if self._closed:
            raise BatcherClosed("serving session is closed")
        timeout = timeout if timeout is not None else self.default_timeout
        self.metrics.counter("requests_received").inc()
        self._admit()
        return self.batcher.submit(inputs, timeout=timeout)

    def stats(self):
        return self.metrics.to_dict()

    @property
    def closed(self):
        return self._closed

    def close(self, drain=True):
        """Graceful shutdown: refuse new work, flush the queue, retire
        every in-flight batch, join the workers, drop the warm-cache
        versions this session served. With ``drain=False`` pending
        requests fail instead."""
        if self._closed:
            return
        self._closed = True
        _pipeline.remove_build_listener(self._build_listener)
        _diag.on_session_end()
        if not drain:
            self.batcher.abort(BatcherClosed("serving session shut down"))
        self.batcher.close()
        for w in self._workers:
            w.join(timeout=60)
        warm_cache().drop(self)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# ---------------------------------------------------------------- HTTP
def _overload_status(exc):
    """The HTTP status and body of a request-path exception: 429 shed or
    full, 504 deadline, 503 draining, 400 client error, 500 backend."""
    if isinstance(exc, AdmissionShed):
        return 429, {"error": str(exc), "shed": True}
    if isinstance(exc, QueueFull):
        return 429, {"error": str(exc)}
    if isinstance(exc, TimeoutError):
        return 504, {"error": str(exc)}
    if isinstance(exc, BatcherClosed):
        return 503, {"error": str(exc)}
    if isinstance(exc, NumericsError):
        return 500, {"error": str(exc)}
    if isinstance(exc, MXNetError):
        return 400, {"error": str(exc)}
    return 500, {"error": "%s: %s" % (type(exc).__name__, exc)}


class _Handler(BaseHTTPRequestHandler):
    server_version = "mxtpu-torch-serving/2.0"

    def _json(self, code, payload):
        self._text(code, json.dumps(payload), "application/json")

    def _text(self, code, body, content_type):
        body = body.encode() if isinstance(body, str) else body
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):  # quiet; metrics carry the signal
        pass

    def _body(self):
        length = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(length) or b"{}")

    def do_GET(self):
        session = self.server.session
        decode = self.server.decode
        path, _, query = self.path.partition("?")
        if path in ("/healthz", "/"):
            # a combined server drains when either session is closed
            if any(s.closed for s in (session, decode) if s is not None):
                self._json(503, {"status": "draining"})
                return
            if session is not None:
                healthy = session.healthy_replicas()
                total = len(session.pool)
                body = {"status": "degraded" if healthy < total else "ok",
                        "replicas": total,
                        "healthy_replicas": healthy,
                        "degraded": healthy < total,
                        "buckets": list(session.buckets),
                        "mode": session.mode,
                        "version": session.version_tag,
                        "admission": STATE_NAMES.get(
                            session._admission_state, "?")}
            else:
                body = {"status": "ok", "mode": "decode",
                        "buckets": list(decode.buckets),
                        "version": decode.version_tag,
                        "admission": STATE_NAMES.get(
                            decode._admission_state, "?")}
            if decode is not None and session is not None:
                body["decode"] = {
                    "buckets": list(decode.buckets),
                    "version": decode.version_tag,
                    "admission": STATE_NAMES.get(
                        decode._admission_state, "?")}
            self._json(200, body)
        elif path == "/v1/version":
            owner = session if session is not None else decode
            body = owner.version_info()
            if session is not None and decode is not None:
                body["decode"] = decode.version_info()
            self._json(200, body)
        elif path == "/v1/metrics":
            owner = session if session is not None else decode
            body = owner.stats()
            if session is not None and decode is not None:
                body["decode"] = decode.stats()
            self._json(200, body)
        elif path == "/metrics":
            # the process-wide registry and every attached session's
            regs = (_tel.registry(),) + tuple(
                s.metrics for s in (session, decode) if s is not None)
            if "format=json" in query or "application/json" in \
                    self.headers.get("Accept", ""):
                self._json(200, _tel.json_snapshot(*regs))
            else:
                self._text(200, _tel.prometheus_text(*regs),
                           _tel.PROMETHEUS_CONTENT_TYPE)
        elif path == "/debug/state":
            state = _diag.debug_state()
            if session is not None:
                state["serving"] = session.stats()
                state["serving_admission"] = session.admission_snapshot()
                state["serving_version"] = session.version_info()
            if decode is not None:
                state["decode"] = decode.debug_panel()
            state["serving_warm_cache"] = warm_cache().manifest()
            self._json(200, state)
        elif path == "/debug/trace":
            from ..obs import trace_export as _trace_export
            self._text(200, _trace_export.dumps(), "application/json")
        else:
            self._json(404, {"error": "unknown path %s" % self.path})

    def do_POST(self):
        session = self.server.session
        path, _, query = self.path.partition("?")
        if path == "/v1/admin/swap":
            self._do_swap()
            return
        if path == "/v1/generate":
            self._do_generate(self.server.decode, query)
            return
        if path not in ("/v1/predict", "/predict"):
            self._json(404, {"error": "unknown path %s" % self.path})
            return
        if session is None:
            self._json(404, {"error": "no predict session attached "
                             "(decode-only server; POST /v1/generate)"})
            return
        try:
            payload = self._body()
            if not isinstance(payload, dict) or \
                    not isinstance(payload.get("inputs"), dict):
                raise ValueError("body must be {\"inputs\": {name: array}}")
            inputs = {k: _np.asarray(v, dtype=_np.float32)
                      for k, v in payload["inputs"].items()}
            timeout = payload.get("timeout_sec", self.server.request_timeout)
            timeout = float(timeout) if timeout is not None else None
        except (ValueError, TypeError, KeyError, IndexError) as exc:
            self._json(400, {"error": str(exc)})
            return
        try:
            outs = session.predict(inputs, timeout=timeout)
        except Exception as exc:  # the status taxonomy, never a reset
            self._json(*_overload_status(exc))
            return
        self._json(200, {"outputs": [o.tolist() for o in outs]})

    def _do_generate(self, decode, query=""):
        """POST /v1/generate {"prompt": [token ids], "max_new_tokens"?,
        "eos_id"?, "seed"?, "temperature"?, "timeout_sec"?} -> the result
        dict; with ``?stream=1`` a chunked NDJSON token stream."""
        if decode is None:
            self._json(404, {"error": "no decode session attached "
                             "(pass decode= to ServingHTTPServer)"})
            return
        try:
            payload = self._body()
            if not isinstance(payload, dict) or \
                    not isinstance(payload.get("prompt"), list):
                raise ValueError(
                    "body must be {\"prompt\": [token ids], ...}")
            prompt = [int(t) for t in payload["prompt"]]
            kwargs = {}
            if payload.get("max_new_tokens") is not None:
                kwargs["max_new_tokens"] = int(payload["max_new_tokens"])
            if payload.get("eos_id") is not None:
                kwargs["eos_id"] = int(payload["eos_id"])
            kwargs["seed"] = int(payload.get("seed", 0))
            kwargs["temperature"] = float(payload.get("temperature", 0.0))
            timeout = payload.get("timeout_sec", self.server.request_timeout)
            timeout = float(timeout) if timeout is not None else None
        except (ValueError, TypeError, KeyError) as exc:
            self._json(400, {"error": str(exc)})
            return
        if query and "stream=1" in query.split("&"):
            self._stream_generate(decode, prompt, timeout, kwargs)
            return
        try:
            result = decode.generate(prompt, timeout=timeout, **kwargs)
        except Exception as exc:
            self._json(*_overload_status(exc))
            return
        self._json(200, result)

    def _write_stream_event(self, event):
        """One NDJSON line as one HTTP/1.1 chunk."""
        body = (json.dumps(event) + "\n").encode()
        self.wfile.write(b"%x\r\n" % len(body) + body + b"\r\n")

    def _stream_generate(self, decode, prompt, timeout, kwargs):
        """``POST /v1/generate?stream=1``: chunked ``application/
        x-ndjson``, ``{"token", "index"}`` per retired token, then a
        terminal ``{"done": result}`` or ``{"error", "type"}``. Errors
        before the stream commits keep the status taxonomy; after the
        200 header every failure is a terminal error event."""
        try:
            item = decode.generate_async(prompt, timeout=timeout,
                                         stream=True, **kwargs)
        except Exception as exc:
            self._json(*_overload_status(exc))
            return
        self.protocol_version = "HTTP/1.1"
        self.close_connection = True
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()
        # per-event wait: the session enforces the deadline; this bound
        # only catches a wedged producer
        wait_s = (timeout + 5.0) if timeout is not None \
            else (self.server.request_timeout or 30.0)
        try:
            while True:
                try:
                    ev = item.stream.get(wait_s)
                except TimeoutError as exc:
                    self._write_stream_event(
                        {"error": str(exc), "type": "TimeoutError"})
                    break
                if ev is None:
                    break
                self._write_stream_event(ev)
                if "done" in ev or "error" in ev:
                    break
            self.wfile.write(b"0\r\n\r\n")
        except OSError:
            pass  # client went away: the sequence finishes server-side

    def _do_swap(self):
        """POST /v1/admin/swap {"symbol_file", "params_file",
        "version_tag"?, "target"?}: hot-swap from checkpoint files on the
        server's filesystem. 403 unless the server holds an admin token
        (``admin_token=`` / ``MXTPU_SERVING_ADMIN_TOKEN``) and the request
        carries it in ``X-Admin-Token``."""
        import hmac
        from .. import ndarray as _nd
        token = self.server.admin_token
        if not token:
            self._json(403, {"error": "admin API disabled: pass "
                             "admin_token= to ServingHTTPServer or set "
                             "MXTPU_SERVING_ADMIN_TOKEN"})
            return
        sent = self.headers.get("X-Admin-Token", "")
        if not hmac.compare_digest(sent, token):
            self._json(403, {"error": "admin token mismatch"})
            return
        try:
            payload = self._body()
            symbol_file = payload["symbol_file"]
            params_file = payload["params_file"]
            tag = payload.get("version_tag")
            target = payload.get("target")
            if target is None:
                target = "predict" if self.server.session is not None \
                    else "decode"
            if target not in ("predict", "decode"):
                raise ValueError("target must be 'predict' or 'decode' "
                                 "(got %r)" % (target,))
            session = self.server.session if target == "predict" \
                else self.server.decode
            if session is None:
                raise ValueError("no %s session attached" % target)
            with open(symbol_file) as f:
                symbol_json = f.read()
            params = _nd.load(params_file)
        except (KeyError, ValueError, TypeError, OSError) as exc:
            self._json(400, {"error": "swap request: %s" % exc})
            return
        try:
            info = session.swap_model(symbol_json, params, version_tag=tag)
        except Exception as exc:
            self._json(*_overload_status(exc))
            return
        self._json(200, info)


class ServingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer bound to a ServingSession, a DecodeSession
    (``decode=``) or both. ``shutdown`` drains the sessions before the
    socket closes."""

    daemon_threads = True

    def __init__(self, session, host="127.0.0.1", port=0,
                 request_timeout=30.0, admin_token=None, decode=None):
        import os
        if session is None and decode is None:
            raise MXNetError("ServingHTTPServer needs a ServingSession, "
                             "a DecodeSession (decode=), or both")
        super().__init__((host, port), _Handler)
        self.session = session
        self.decode = decode
        self.request_timeout = request_timeout
        # gates POST /v1/admin/swap; None (and no env) disables it
        self.admin_token = admin_token if admin_token is not None \
            else os.environ.get("MXTPU_SERVING_ADMIN_TOKEN") or None

    @property
    def endpoint(self):
        return "http://%s:%d" % self.server_address[:2]

    def shutdown(self):
        for s in (self.session, self.decode):
            if s is not None:
                s.close(drain=True)
        super().shutdown()
        self.server_close()


def serve(symbol_json, params, example_shapes, host="127.0.0.1", port=8080,
          block=True, **session_kwargs):
    """Build the session, bind the socket, serve. With ``block=False``
    returns the running server (serving on a daemon thread); call
    ``server.shutdown()`` to drain and stop."""
    session = ServingSession(symbol_json, params, example_shapes,
                             **session_kwargs)
    server = ServingHTTPServer(session, host=host, port=port)
    if not block:
        threading.Thread(target=server.serve_forever, daemon=True).start()
        return server
    try:
        server.serve_forever()
    finally:
        server.shutdown()
    return server
