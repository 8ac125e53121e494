"""Executor pool: one Predictor replica per device, round robin.

Counterpart of ``mxtpu/serving/pool.py``: ``default_contexts``,
``_Replica`` with its dispatch/collect split (:295-325) and the round
robin ``ExecutorPool``. Each replica owns the model weights on its
device once and the Predictor's shape-keyed bind cache. A dispatch and
a collect cross the ``serving.replica.dispatch`` and
``serving.replica.collect`` fault points, and a pool with metrics opens
a ``pool.run`` span around each batch. Warmup is
``warmup_replica``, which the session calls on each replica's own
dispatcher thread, because cuDNN keeps its plans per thread; it runs in
the compile pipeline's ``prewarm_scope`` (its builds are deploy-time,
not mid-traffic misses), and each bucket's steady-state time is kept
under (bucket, pipeline config), mxtpu's cost-row stamp (:149-158): a
bf16 or quantized forward is not the f32 one's cost. The process-wide
warm cache and hot-swap adoption of the JAX pool arrive in a later
slice.
"""
from __future__ import annotations

import time

import numpy as _np
import torch

from ..analysis import concurrency as _conc
from ..base import MXNetError
from ..faults import injection as _faults
from ..context import Context, num_gpus
from ..predict import Predictor, to_host

__all__ = ["ExecutorPool", "default_contexts"]


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


class _Replica:
    """One device's predictor: one weight copy plus the shape-keyed
    executor LRU the Predictor keeps. ``lock`` serializes bind + issue."""

    def __init__(self, symbol_json, params, example_shapes, ctx, cache_size,
                 metrics=None):
        self.ctx = ctx
        self.metrics = metrics
        self.base = Predictor(symbol_json, params, ctx=ctx,
                              input_shapes=example_shapes,
                              max_cached_binds=cache_size)
        self.lock = _conc.lock("_Replica", "lock")

    def bind_thread(self):
        """Make this replica's device current on the calling thread (a
        dispatcher thread calls it once before its loop)."""
        if self.ctx.device_type == "gpu":
            torch.cuda.set_device(self.ctx.device_id)

    def predictor_for(self, shapes):
        """The replica predictor bound to exact input ``shapes`` (caller
        holds ``self.lock``)."""
        hit = Predictor.shape_key(shapes) in self.base._bind_cache
        self.base.reshape(shapes)
        if self.metrics:
            self.metrics.counter("executor_cache_hits" if hit
                                 else "executor_cache_misses").inc()
        return self.base

    def dispatch(self, inputs):
        """Issue one padded batch WITHOUT waiting for results: returns the
        output tensors, whose kernels are queued on the device's stream."""
        _faults.point("serving.replica.dispatch")
        shapes = {k: tuple(v.shape) for k, v in inputs.items()}
        with self.lock:
            pred = self.predictor_for(shapes)
            pred.forward(**inputs)
            return [o._data for o in pred._executor.outputs]

    def collect(self, handles):
        """Materialize dispatched outputs: one bulk device->host copy,
        which waits for the device."""
        _faults.point("serving.replica.collect")
        return to_host(handles)

    def run(self, inputs):
        """Forward one padded batch synchronously; numpy outputs."""
        return self.collect(self.dispatch(inputs))


class ExecutorPool:
    """Round-robin scheduler over device replicas. ``example_shapes`` are
    per-request input shapes with a leading batch dim of 1; a bucket's
    batch shapes substitute the bucket size for it."""

    def __init__(self, symbol_json, params, example_shapes, contexts=None,
                 cache_size=8, metrics=None):
        if not example_shapes:
            raise MXNetError("ExecutorPool requires example_shapes")
        self.example_shapes = {k: tuple(v)
                               for k, v in example_shapes.items()}
        contexts = contexts or default_contexts()
        self.metrics = metrics
        self.replicas = [_Replica(symbol_json, params, self.example_shapes,
                                  ctx, cache_size, metrics=metrics)
                         for ctx in contexts]
        self._rr = 0
        self._rr_lock = _conc.lock("ExecutorPool", "_rr_lock")
        self._costs = {}  # (bucket, pipeline config) -> warm ms

    @staticmethod
    def _cost_key(bucket, pipeline=None):
        """(bucket, compile-pipeline config): ``pipeline=None`` stamps
        the current config."""
        if pipeline is None:
            from ..compile import pipeline as _pipeline
            pipeline = _pipeline.configured()
        return (int(bucket), tuple(pipeline))

    def bucket_costs(self, pipeline=None):
        """{bucket: warm ms} measured under one pipeline config (default:
        the current one)."""
        want = self._cost_key(0, pipeline)[1]
        return {b: ms for (b, cfg), ms in self._costs.items() if cfg == want}

    def owns_executor(self, ex):
        """Whether ``ex`` is one of the replicas' bound executors."""
        return any(hit[0] is ex for rep in self.replicas
                   for hit in list(rep.base._bind_cache.values()))

    def __len__(self):
        return len(self.replicas)

    def bucket_shapes(self, bucket):
        return {k: (int(bucket),) + s[1:]
                for k, s in self.example_shapes.items()}

    def next_replica(self):
        with self._rr_lock:
            r = self.replicas[self._rr % len(self.replicas)]
            self._rr += 1
            return r

    def run(self, inputs, replica=None):
        """Run one padded batch round-robin (or on ``replica``)."""
        rep = replica if replica is not None else self.next_replica()
        if self.metrics:
            with self.metrics.span("pool.run", category="serving"):
                return rep.run(inputs)
        return rep.run(inputs)

    def warmup_replica(self, rep, buckets):
        """Bind and run every bucket on ``rep`` twice, on the calling
        thread, so traffic never pays a first-call cost (kernel build,
        allocator growth, the thread's cuDNN plans). Returns
        ``{bucket: ms}`` of the second, steady-state runs."""
        from ..compile import pipeline as _pipeline
        times = {}
        with _pipeline.prewarm_scope():
            for b in buckets:
                dummy = {k: _np.zeros(s, dtype=_np.float32)
                         for k, s in self.bucket_shapes(b).items()}
                rep.run(dummy)
                t0 = time.perf_counter()
                rep.run(dummy)
                times[int(b)] = (time.perf_counter() - t0) * 1e3
                self._costs[self._cost_key(b)] = times[int(b)]
        return times
