"""Executor pool: one Predictor replica per device over a process-wide
warm cache.

Counterpart of ``mxtpu/serving/pool.py``: ``default_contexts``,
``symbol_json_hash``, ``params_token``, the process-wide
:class:`WarmExecutableCache` (:80) keyed (symbol hash, version tag, ctx)
with per-(bucket, pipeline config) cost rows, ``_Replica`` with its
dispatch/collect split, the round-robin ``ExecutorPool`` with
``rebuild_replica`` (quarantine recovery), ``bucket_costs`` and
``bucket_axes``, and ``prewarm`` (:534). A pool for a (model, version,
weights) the process has already served adopts the cached predictors,
their bind caches included, so a hot-swap rollback builds no executor
plan. A reused tag with other weights (``params_token`` mismatch) is
rebuilt, never served stale.

What differs from the JAX pool is how a batch reaches the card and comes
back, because JAX dispatch is asynchronous by nature and PyTorch's host
copies are not:

* a replica on a CUDA device owns a compute stream and a copy stream
  (shared by every pool that adopts its predictor). ``dispatch`` stages
  the padded numpy inputs in pinned host tensors and copies them with
  ``non_blocking=True`` on the compute stream, so it never waits for
  the batch queued ahead of it;
* the forward's outputs are copied into pinned host tensors on the copy
  stream, which waits on an event recorded at the end of the forward:
  the answer of batch N crosses the bus while batch N+1 runs, and
  ``collect`` synchronizes on that copy's event alone. The requests get
  numpy views of their batch's own pinned tensors, which keep them
  alive: no later batch can write under an answer;
* the pinned tensors come from PyTorch's caching host allocator, which
  hands a freed block out again only after the events recorded behind
  the non-blocking copies that used it, so a staging or answer buffer is
  never overwritten under a copy in flight. They are host memory and
  stay out of the device ledger (``host_pinned_bytes`` reports them);
* PyTorch's current stream is per thread, so every call runs under
  ``torch.cuda.stream(...)`` of its replica, and the output tensors stay
  referenced by the dispatch handle until their copy has completed.

On the CPU a dispatch runs the forward and ``collect`` copies its
outputs, as before. A dispatch and a collect cross the
``serving.replica.dispatch`` and ``serving.replica.collect`` fault
points; a replica's binds count in the memory ledger under
``serving_pool``; its collect is a watchdog-registered wait
(``serving_collect``). Warmup runs in the compile pipeline's
``prewarm_scope``; the session warms each replica on its own worker
thread (cuDNN keeps its plans per thread).
"""
from __future__ import annotations

import hashlib
import time
from collections import OrderedDict

import numpy as _np
import torch

from .. import diagnostics as _diag
from ..analysis import concurrency as _conc
from ..base import MXNetError
from ..context import Context, num_gpus
from ..faults import injection as _faults
from ..predict import Predictor, to_host

__all__ = ["ExecutorPool", "WarmExecutableCache", "warm_cache", "prewarm",
           "default_contexts", "symbol_json_hash", "params_token"]


def default_contexts(max_replicas=None):
    """One gpu(i) per CUDA device; raises when there is none (pass
    ``contexts=[cpu()]`` to serve on the host)."""
    n = num_gpus()
    if n == 0:
        raise MXNetError("no CUDA device: serving defaults to the GPUs; "
                         "pass contexts=[cpu()] to serve on the host")
    if max_replicas is not None:
        n = min(n, max_replicas)
    return [Context("gpu", i) for i in range(n)]


def symbol_json_hash(symbol_json):
    """Stable 16-hex digest of a graph (str or Symbol), as
    ``Predictor.symbol_hash``."""
    if not isinstance(symbol_json, str):
        symbol_json = symbol_json.tojson()
    return hashlib.sha1(symbol_json.encode()).hexdigest()[:16]


def params_token(params):
    """Identity token of a weight set: (name, buffer id) pairs, and the
    referenced objects, which the cache entry pins so an id cannot be
    recycled by another array. Returns ``(token, pin)``."""
    toks, pin = [], []
    for k in sorted(params or {}):
        v = params[k]
        data = getattr(v, "_data", None)
        ref = data if data is not None else v
        toks.append((k, id(ref)))
        pin.append(ref)
    return tuple(toks), pin


class WarmExecutableCache:
    """Process-wide warm-predictor cache keyed (symbol hash, version tag).

    Each version entry holds one Predictor per ctx (its weights on the
    device and its shape-keyed bind cache), the ``params_token`` that
    built it, and the per-(bucket, pipeline) cost rows warmup measured.
    ``adopt`` is the zero-build path; a token mismatch under the same tag
    drops the entry. LRU over whole versions, capped by the
    ``serving.warm_versions`` knob (default 4). A session ``hold``s each
    version it serves and ``drop``s them at close: a version the last
    holder drops is evicted with its device weights (a version nobody
    held, such as a deploy-time ``prewarm``, stays until adopted)."""

    def __init__(self, max_versions=None):
        self._lock = _conc.lock("WarmExecutableCache", "_lock")
        self._versions = OrderedDict()  # (hash, tag) -> entry dict
        self._max_versions = int(max_versions) \
            if max_versions is not None else None

    @property
    def max_versions(self):
        """The retention cap, resolved live through the knob registry
        unless pinned at construction."""
        if self._max_versions is not None:
            return self._max_versions
        from ..tune import registry as _knobs
        return _knobs.resolve_int("serving.warm_versions")

    @max_versions.setter
    def max_versions(self, v):
        self._max_versions = int(v)

    def adopt(self, sym_hash, tag, ctx, token):
        """The cached predictor for (model, version, ctx), or None; drops
        the version when ``token`` shows other weights."""
        key = (sym_hash, tag)
        with self._lock:
            v = self._versions.get(key)
            if v is None:
                return None
            if v["token"] != token:
                del self._versions[key]  # stale weights: never serve them
                return None
            self._versions.move_to_end(key)
            return v["replicas"].get(str(ctx))

    def register(self, sym_hash, tag, ctx, token, predictor, pin=()):
        key = (sym_hash, tag)
        with self._lock:
            v = self._versions.get(key)
            if v is None or v["token"] != token:
                v = {"token": token, "pin": list(pin), "replicas": {},
                     "costs": {}, "created": time.time(),
                     "holders": set()}
                self._versions[key] = v
            v["replicas"][str(ctx)] = predictor
            self._versions.move_to_end(key)
            while len(self._versions) > self.max_versions:
                self._versions.popitem(last=False)

    @staticmethod
    def _cost_key(bucket, pipeline=None):
        """(bucket, compile-pipeline config); ``pipeline=None`` stamps the
        current config: a bf16 or quantized forward is not the f32 one's
        cost."""
        if pipeline is None:
            from ..compile import pipeline as _pipeline
            pipeline = _pipeline.configured()
        return (int(bucket), tuple(pipeline))

    def record_cost(self, sym_hash, tag, bucket, cost, pipeline=None):
        key = self._cost_key(bucket, pipeline)
        with self._lock:
            v = self._versions.get((sym_hash, tag))
            if v is not None:
                v["costs"][key] = dict(cost)

    def costs_for(self, sym_hash, tag, pipeline=None):
        """The version's rows for one pipeline config (default: the
        current one) as ``{bucket: cost}``."""
        want = self._cost_key(0, pipeline)[1]
        with self._lock:
            v = self._versions.get((sym_hash, tag))
            if v is None:
                return {}
            return {b: dict(c) for (b, cfg), c in v["costs"].items()
                    if cfg == want}

    def hold(self, sym_hash, tag, owner):
        """Record that ``owner`` (a session) serves the version."""
        with self._lock:
            v = self._versions.get((sym_hash, tag))
            if v is not None:
                v["holders"].add(id(owner))

    def drop(self, owner):
        """``owner`` no longer serves: evict every version it held that
        no other holder serves."""
        with self._lock:
            for key in [k for k, v in self._versions.items()
                        if id(owner) in v["holders"]]:
                holders = self._versions[key]["holders"]
                holders.discard(id(owner))
                if not holders:
                    del self._versions[key]

    def evict(self, sym_hash=None, tag=None):
        """Drop matching versions (both None = clear). Returns #evicted."""
        with self._lock:
            keys = [k for k in self._versions
                    if (sym_hash is None or k[0] == sym_hash)
                    and (tag is None or k[1] == tag)]
            for k in keys:
                del self._versions[k]
            return len(keys)

    def __len__(self):
        with self._lock:
            return len(self._versions)

    def manifest(self):
        """JSON-ready inventory (the ``serving_warm_cache`` panel): per
        version, which ctxs hold predictors, which buckets are bound, and
        the measured cost rows, snapshotted under the lock."""
        with self._lock:
            items = [((key, dict(v["replicas"]), dict(v["costs"]),
                       v["created"]))
                     for key, v in self._versions.items()]
        out = []
        for (sym_hash, tag), replicas, costs, created in items:
            ctxs = {}
            for ctx, pred in replicas.items():
                keys = list(pred._bind_cache)
                ctxs[ctx] = sorted({shapes[0][1][0] for shapes in keys})
            out.append({"symbol_hash": sym_hash, "version": tag,
                        "created": created, "replicas": ctxs,
                        "bucket_costs": {
                            "%d@%s" % (b, ",".join(cfg)) if cfg
                            else str(b): c
                            for (b, cfg), c in costs.items()}})
        return out


_WARM_CACHE = WarmExecutableCache()


def warm_cache():
    """The process-wide :class:`WarmExecutableCache` singleton."""
    return _WARM_CACHE


def _pinned(shape):
    """A float32 pinned host tensor from PyTorch's caching host
    allocator: a block freed while a non-blocking copy still uses it is
    not handed out again before the event recorded behind that copy."""
    return torch.empty(shape, dtype=torch.float32, pin_memory=True)


class _DeviceIO:
    """A CUDA predictor's streams: the compute stream its forwards run
    on and the copy stream its answers come back on. Kept on the
    predictor, so pools that adopt it share them."""

    def __init__(self, device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.copy_stream = torch.cuda.Stream(device)


def host_pinned_bytes():
    """Pinned host bytes PyTorch's caching host allocator holds (where
    this PyTorch reports them; None otherwise)."""
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is None:
        return None
    st = stats()
    return st.get("reserved_bytes.current",
                  st.get("allocated_bytes.current"))


class _Dispatched:
    """A dispatched batch: its output tensors, kept alive until their
    copy has completed, and on a card its pinned answer tensors and the
    events of the batch's start and end on the compute stream and of
    its copy."""

    __slots__ = ("outputs", "answers", "start", "done", "copied")

    def __init__(self, outputs, answers=None, start=None, done=None,
                 copied=None):
        self.outputs = outputs
        self.answers = answers
        self.start = start
        self.done = done
        self.copied = copied

    def device_ms(self):
        """The batch's time on the compute stream, input copy to last
        kernel (after ``collect``); None on the CPU."""
        if self.start is None:
            return None
        return self.start.elapsed_time(self.done)

    def copy_ms(self):
        """The answer's copy to the host (after ``collect``)."""
        if self.start is None:
            return None
        return self.done.elapsed_time(self.copied)


class _Replica:
    """One device's predictor: one weight copy plus the shape-keyed bind
    cache the Predictor keeps. The dispatch lock lives on the predictor
    (``_serving_lock``): pools that adopt the same cached predictor
    serialize on one lock."""

    def __init__(self, symbol_json, params, example_shapes, ctx, cache_size,
                 metrics=None, record_executor=None, version_tag="v0",
                 shared_cache=None):
        self.ctx = ctx
        self.metrics = metrics
        self._record = record_executor or (lambda ex: None)
        self.sym_hash = symbol_json_hash(symbol_json)
        self.version_tag = version_tag
        token, pin = params_token(params)
        base = shared_cache.adopt(self.sym_hash, version_tag, ctx, token) \
            if shared_cache is not None else None
        self.adopted = base is not None
        if base is not None:
            base._max_cached_binds = max(base._max_cached_binds, cache_size)
            if metrics:
                metrics.counter("warm_cache_adoptions").inc()
        else:
            # every array the replica's executors bind lands in the
            # memory ledger under the pool's own origin
            with _diag.alloc_origin("serving_pool"):
                base = Predictor(symbol_json, params, ctx=ctx,
                                 input_shapes=example_shapes,
                                 max_cached_binds=cache_size)
            if shared_cache is not None:
                shared_cache.register(self.sym_hash, version_tag, ctx,
                                      token, base, pin=pin)
        self.base = base
        if getattr(base, "_serving_lock", None) is None:
            base._serving_lock = _conc.lock("_Replica", "lock")
        self.lock = base._serving_lock
        if ctx.device_type == "gpu" and \
                getattr(base, "_serving_io", None) is None:
            base._serving_io = _DeviceIO(ctx.torch_device)
        self.io = getattr(base, "_serving_io", None) \
            if ctx.device_type == "gpu" else None
        self._record(self.base._executor)

    def bind_thread(self):
        """Make this replica's device current on the calling thread."""
        if self.ctx.device_type == "gpu":
            torch.cuda.set_device(self.ctx.device_id)

    def predictor_for(self, shapes):
        """The replica predictor bound to exact input ``shapes`` (caller
        holds ``self.lock``)."""
        key = Predictor.shape_key(shapes)
        cache = self.base._bind_cache
        hit = key in cache
        before = len(cache)
        with _diag.alloc_origin("serving_pool"):
            self.base.reshape(shapes)
        self._record(self.base._executor)
        if self.metrics:
            self.metrics.counter("executor_cache_hits" if hit
                                 else "executor_cache_misses").inc()
            if not hit and len(cache) == before:
                self.metrics.counter("executor_cache_evictions").inc()
        return self.base

    def dispatch(self, inputs):
        """Issue one padded batch without waiting for results; returns
        the handle ``collect`` takes."""
        _faults.point("serving.replica.dispatch")
        shapes = {k: tuple(v.shape) for k, v in inputs.items()}
        with self.lock:
            pred = self.predictor_for(shapes)
            if self.io is None:
                pred.forward(**inputs)
                return _Dispatched([o._data for o in
                                    pred._executor.outputs])
            return self._dispatch_cuda(pred, shapes, inputs)

    def _dispatch_cuda(self, pred, shapes, inputs):
        io = self.io
        names = sorted(inputs)
        staged = [_pinned(shapes[n]) for n in names]
        for t, n in zip(staged, names):
            _np.copyto(t.numpy(), inputs[n], casting="unsafe")
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(io.stream):
            start.record(io.stream)
            for t, n in zip(staged, names):
                pred._arg_arrays[n]._data.copy_(t, non_blocking=True)
            outs = [o._data for o in
                    pred._executor.forward(is_train=False)]
            done.record(io.stream)
        answers = [_pinned(tuple(o.shape)) for o in outs]
        io.copy_stream.wait_event(done)
        with torch.cuda.stream(io.copy_stream):
            for dst, src in zip(answers, outs):
                dst.copy_(src.to(torch.float32) if src.dtype !=
                          torch.float32 else src, non_blocking=True)
            copied = torch.cuda.Event(enable_timing=True)
            copied.record(io.copy_stream)
        return _Dispatched(outs, answers, start, done, copied)

    def collect(self, handle):
        """Materialize a dispatched batch's outputs. On a card: wait for
        its answer copy alone and return numpy views of the batch's own
        pinned tensors (each view keeps its tensor alive, so no later
        batch writes under it); on the CPU: copies. A watchdog-registered
        wait (``serving_collect``)."""
        _diag.wait_begin("serving_collect")
        try:
            _faults.point("serving.replica.collect")
            if handle.answers is None:
                return to_host(handle.outputs)
            handle.copied.synchronize()
            handle.outputs = None
            return [t.numpy() for t in handle.answers]
        finally:
            _diag.wait_end()

    def run(self, inputs):
        """Forward one padded batch synchronously; numpy outputs."""
        return self.collect(self.dispatch(inputs))


class ExecutorPool:
    """Round-robin scheduler over device replicas.

    ``example_shapes`` are per-request input shapes with a leading batch
    dim of 1; ``bucket_axes`` names, per input, the axes the bucket size
    substitutes into (default the leading one; ``()`` pins a fixed-side
    input such as a single sequence's KV view under a token-bucketed
    prefill). ``version_tag`` names this pool's weights in the
    process-wide warm cache: distinct weights need distinct tags."""

    def __init__(self, symbol_json, params, example_shapes, contexts=None,
                 cache_size=8, metrics=None, version_tag="v0",
                 shared_cache=None, bucket_axes=None):
        if not example_shapes:
            raise MXNetError("ExecutorPool requires example_shapes")
        self.example_shapes = {k: tuple(v)
                               for k, v in example_shapes.items()}
        self.bucket_axes = {
            k: tuple(int(a) for a in (bucket_axes or {}).get(k, (0,)))
            for k in self.example_shapes}
        for k, axes in self.bucket_axes.items():
            for a in axes:
                if not 0 <= a < len(self.example_shapes[k]):
                    raise MXNetError(
                        "bucket_axes[%r]=%r out of range for example "
                        "shape %r" % (k, axes, self.example_shapes[k]))
        contexts = contexts or default_contexts()
        self.metrics = metrics
        self.version_tag = version_tag
        # kept for a replica's rebuild (quarantine and respawn)
        self._symbol_json = symbol_json if isinstance(symbol_json, str) \
            else symbol_json.tojson()
        self._params = params
        self._cache_size = cache_size
        self._shared = warm_cache() if shared_cache is None \
            else shared_cache
        # executor ownership for the build-listener seam, recorded at
        # bind time under its own lock
        self._owned_ids = set()
        self._owned_lock = _conc.lock("ExecutorPool", "_owned_lock")

        def _record(ex):
            with self._owned_lock:
                self._owned_ids.add(id(ex))

        self._record_executor = _record
        self.replicas = [
            _Replica(symbol_json, params, self.example_shapes, ctx,
                     cache_size, metrics=metrics, record_executor=_record,
                     version_tag=version_tag, shared_cache=self._shared)
            for ctx in contexts]
        # (bucket, pipeline config) -> cost row, this pool's own copy of
        # what it measured or adopted (the cache may evict the version)
        self._costs = {}
        self._rr = 0
        self._rr_lock = _conc.lock("ExecutorPool", "_rr_lock")

    def __len__(self):
        return len(self.replicas)

    @property
    def symbol_hash(self):
        return self.replicas[0].sym_hash

    @property
    def adopted(self):
        """True when every replica came warm out of the process cache."""
        return all(r.adopted for r in self.replicas)

    def owns_executor(self, executor):
        """Whether ``executor`` was bound by one of this pool's replicas."""
        with self._owned_lock:
            return id(executor) in self._owned_ids

    def bucket_shapes(self, bucket):
        """Batch shapes at ``bucket``: the bucket size at each input's
        ``bucket_axes``."""
        out = {}
        for k, s in self.example_shapes.items():
            shape = list(s)
            for a in self.bucket_axes[k]:
                shape[a] = int(bucket)
            out[k] = tuple(shape)
        return out

    def bucket_costs(self, pipeline=None):
        """Measured per-bucket cost rows ``{bucket: {exec_ms, flops,
        bytes_accessed, compile_ms}}`` under one pipeline config (default:
        the current one), from warmup or from the warm-cache entry an
        adopted pool inherits."""
        want = WarmExecutableCache._cost_key(0, pipeline)[1]
        own = {b: dict(c) for (b, cfg), c in self._costs.items()
               if cfg == want}
        return own or self._shared.costs_for(self.symbol_hash,
                                             self.version_tag, pipeline)

    def next_replica(self):
        with self._rr_lock:
            r = self.replicas[self._rr % len(self.replicas)]
            self._rr += 1
            return r

    def rebuild_replica(self, idx):
        """Replace replica ``idx`` with a fresh predictor (quarantine
        recovery), built without adoption and registered over the cached
        one. The list-slot assignment is atomic; dispatchers read
        ``replicas[idx]`` per batch."""
        old = self.replicas[idx]
        rep = _Replica(self._symbol_json, self._params,
                       self.example_shapes, old.ctx, self._cache_size,
                       metrics=self.metrics,
                       record_executor=self._record_executor,
                       version_tag=self.version_tag, shared_cache=None)
        token, pin = params_token(self._params)
        self._shared.register(rep.sym_hash, self.version_tag, old.ctx,
                              token, rep.base, pin=pin)
        self.replicas[idx] = rep
        return rep

    def run(self, inputs, replica=None):
        """Run one padded batch round-robin (or on ``replica``)."""
        rep = replica if replica is not None else self.next_replica()
        if self.metrics:
            with self.metrics.span("pool.run", category="serving"):
                return rep.run(inputs)
        return rep.run(inputs)

    def warmup(self, buckets):
        """Warm every (replica, bucket) on the calling thread, in the
        compile pipeline's ``prewarm_scope``. Returns the number of
        (replica, bucket) programs warmed."""
        built = sum(len(self.warmup_replica(rep, buckets))
                    for rep in self.replicas)
        if self.metrics:
            self.metrics.counter("warmup_programs").inc(built)
        return built

    def warmup_replica(self, rep, buckets):
        """Bind and run every bucket on ``rep`` twice, so traffic never
        pays a first-call cost (plan build, allocator growth, the thread's
        cuDNN plans). A bucket the replica adopted warm with a cost row
        for the current pipeline config is skipped. Returns ``{bucket:
        ms}`` of the second, steady-state runs."""
        from ..compile import pipeline as _pipeline
        times = {}
        costs = self.bucket_costs()
        with _pipeline.prewarm_scope():
            for b in buckets:
                shapes = self.bucket_shapes(b)
                key = Predictor.shape_key(shapes)
                if rep.adopted and key in rep.base._bind_cache \
                        and int(b) in costs:
                    continue
                dummy = {k: _np.zeros(s, dtype=_np.float32)
                         for k, s in shapes.items()}
                rep.run(dummy)
                t0 = time.perf_counter()
                rep.run(dummy)
                ms = (time.perf_counter() - t0) * 1e3
                times[int(b)] = ms
                if int(b) not in costs:
                    rec = _diag.latest_record("fwd_eval")
                    cost = {"exec_ms": round(ms, 3),
                            "flops": rec.flops if rec else 0.0,
                            "bytes_accessed":
                                rec.bytes_accessed if rec else 0.0,
                            "compile_ms": rec.compile_ms if rec else 0.0}
                    self._shared.record_cost(rep.sym_hash, rep.version_tag,
                                             b, cost)
                    self._costs[WarmExecutableCache._cost_key(b)] = cost
                    costs[int(b)] = cost
        return times


def prewarm(symbol_json, params, example_shapes, buckets, contexts=None,
            version_tag="v0", cache_size=8, metrics=None):
    """Deploy-time pre-warm from a bucket manifest: build the weights and
    warm every (ctx, bucket) into the process-wide warm cache before any
    session exists. A session built afterwards with the same symbol, the
    same weight arrays and the same ``version_tag`` adopts everything.
    Returns the number of (ctx, bucket) programs warmed."""
    pool = ExecutorPool(symbol_json, params, example_shapes,
                        contexts=contexts,
                        cache_size=max(cache_size, len(tuple(buckets))),
                        metrics=metrics, version_tag=version_tag)
    return pool.warmup(tuple(buckets))
