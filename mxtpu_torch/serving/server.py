"""Serving front-ends: in-process ``ServingSession`` + stdlib HTTP server.

Counterpart of ``mxtpu/serving/server.py`` in its burst mode: a batcher
feeding an ``ExecutorPool`` through one dispatcher thread per replica
(dispatch, wait, answer, repeat), and ``POST /v1/predict``
``{"inputs": {"data": [[...]]}} -> {"outputs": [...]}`` over
``ThreadingHTTPServer``. Without ``contexts`` a session serves on every
CUDA device and raises when there is none.

Telemetry as mxtpu's (server.py:673, 717, 755, 859-880): the engine's
series exist from its module's import, before the first scrape (the
session starts no engine: nothing in serving pushes to it);
``predict`` runs in a ``serving.request`` span, and each batch in
a ``batch[<bucket>]`` span whose parent is its first request's span
(captured at submit, across the queue hop). ``GET /v1/metrics`` answers
the session's flat JSON stats; ``GET /metrics`` the process-wide
registry merged with the session's, as Prometheus text, or as JSON with
``?format=json`` or an ``Accept: application/json`` header.

Not ported yet (later slices): continuous K-in-flight dispatch,
admission control, hot-swap (``swap_model``) and the warm executable
cache, tuned knobs, replica quarantine and respawn, diagnostics, the
decode session and ``/v1/generate``, and the other HTTP routes
(``/healthz``, ``/debug/*``, ``/v1/version``, ``/v1/admin/swap``).
"""
from __future__ import annotations

import json
import logging
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as _np

from .. import telemetry as _tel
from ..base import MXNetError
from ..compile import pipeline as _pipeline
from .batcher import BatcherClosed, DynamicBatcher, QueueFull
from .metrics import MetricsRegistry
from .pool import ExecutorPool

__all__ = ["ServingSession", "ServingHTTPServer", "serve"]

log = logging.getLogger("mxtpu_torch.serving")

DEFAULT_BUCKETS = (1, 8, 32, 128)


class ServingSession:
    """Batching inference service over one model.

    Parameters
    ----------
    symbol_json : str or Symbol — the inference graph
    params : dict — weights (``arg:``/``aux:`` convention)
    example_shapes : dict name -> per-request shape WITH leading dim 1
    buckets : allowed batch sizes (every one is warmed at startup)
    max_delay_ms : batching deadline before a padded partial batch flushes
    max_queue : bounded queue depth; beyond it ``predict`` raises QueueFull
    contexts : device contexts (default: one replica per CUDA device)
    warmup : run every (replica, bucket) on its dispatcher thread before
        accepting
    default_timeout : per-request timeout in seconds (None: wait)
    """

    def __init__(self, symbol_json, params, example_shapes,
                 buckets=DEFAULT_BUCKETS, max_delay_ms=5.0, max_queue=256,
                 contexts=None, warmup=True, default_timeout=None):
        self.metrics = MetricsRegistry()
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.default_timeout = default_timeout
        self._pool = ExecutorPool(symbol_json, params, example_shapes,
                                  contexts=contexts,
                                  cache_size=max(8, len(self.buckets)),
                                  metrics=self.metrics)
        self.batcher = DynamicBatcher(
            list(example_shapes), buckets=self.buckets,
            max_delay_ms=max_delay_ms, max_queue=max_queue,
            metrics=self.metrics, example_shapes=example_shapes)
        self._closed = False
        self._workers = []
        # program builds of this session's executors (mxtpu
        # server.py:190-200): flat under traffic once warm
        builds = self.metrics.counter("program_builds")
        pool_ref = weakref.ref(self._pool)

        def on_build(kind, ex):
            p = pool_ref()
            if p is not None and p.owns_executor(ex):
                builds.inc()

        self._build_listener = _pipeline.add_build_listener(on_build)
        warms = []
        for i in range(len(self._pool.replicas)):
            warm = {"done": threading.Event()} if warmup else None
            t = threading.Thread(target=self._burst_loop, args=(i, warm),
                                 daemon=True,
                                 name="mxtpu-torch-serving-%d" % i)
            t.start()
            self._workers.append(t)
            warms.append(warm)
        self.warmup_ms = {}
        for warm in filter(None, warms):
            warm["done"].wait()
            if "error" in warm:
                self.close(drain=False)
                raise warm["error"]
            self.warmup_ms.update(warm["ms"])

    @property
    def pool(self):
        return self._pool

    @property
    def example_shapes(self):
        return self._pool.example_shapes

    def _burst_loop(self, idx, warm=None):
        """Warm the replica (when ``warm`` is given), then pull a batch,
        run it to completion, answer its requests. The warmup runs here,
        on the thread that serves: cuDNN keeps its plan caches per thread,
        so a replica warmed on another thread pays ~0.1-0.2 s again on its
        first batch (ResNet-50 on an H100)."""
        replica = self._pool.replicas[idx]
        replica.bind_thread()
        if warm is not None:
            try:
                warm["ms"] = self._pool.warmup_replica(replica, self.buckets)
            except Exception as exc:  # re-raised by the constructor
                warm["error"] = exc
                return
            finally:
                warm["done"].set()
        while True:
            batch = self.batcher.next_batch(timeout=0.25)
            if batch is None:
                if self.batcher.closed and self.batcher.depth == 0:
                    return
                continue
            t0 = time.monotonic()
            try:
                with _tel.span("batch[%d]" % batch.bucket,
                               category="serving",
                               parent=batch.items[0].span,
                               tags={"n_valid": batch.n_valid}):
                    outs = self._pool.run(batch.inputs, replica=replica)
            except Exception as exc:  # answer the batch, keep the worker
                log.exception("serving: batch of %d failed", batch.n_valid)
                batch.fail(exc)
                self.metrics.counter("requests_failed").inc(len(batch.items))
                continue
            self.metrics.counter("batches_dispatched").inc()
            batch.finish(outs)
            done = time.monotonic()
            self.metrics.counter("requests_completed").inc(len(batch.items))
            self.metrics.histogram("batch_exec_ms").observe((done - t0) * 1e3)
            for it in batch.items:
                self.metrics.histogram("request_latency_ms").observe(
                    (done - it.t_enqueue) * 1e3)

    def predict(self, inputs, timeout=None):
        """Synchronous single-request inference: dict of arrays (leading
        dim = #examples) -> list of numpy outputs. Raises QueueFull under
        backpressure and TimeoutError past ``timeout``."""
        timeout = timeout if timeout is not None else self.default_timeout
        with self.metrics.span("serving.request"):
            return self.predict_async(inputs, timeout).wait(timeout)

    def predict_async(self, inputs, timeout=None):
        """Enqueue and return the WorkItem future (``.wait(timeout)``)."""
        if self._closed:
            raise BatcherClosed("serving session is closed")
        timeout = timeout if timeout is not None else self.default_timeout
        self.metrics.counter("requests_received").inc()
        return self.batcher.submit(inputs, timeout=timeout)

    def stats(self):
        return self.metrics.to_dict()

    @property
    def closed(self):
        return self._closed

    def close(self, drain=True):
        """Refuse new work, flush (or with ``drain=False`` fail) the queue,
        join the dispatchers."""
        if self._closed:
            return
        self._closed = True
        _pipeline.remove_build_listener(self._build_listener)
        if not drain:
            self.batcher.abort(BatcherClosed("serving session shut down"))
        self.batcher.close()
        for w in self._workers:
            w.join(timeout=60)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# ---------------------------------------------------------------- HTTP
class _Handler(BaseHTTPRequestHandler):
    server_version = "mxtpu-torch-serving/1.0"

    def _json(self, code, payload):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _text(self, code, body, content_type):
        body = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):  # quiet; metrics carry the signal
        pass

    def do_GET(self):
        path, _, query = self.path.partition("?")
        session = self.server.session
        if path == "/v1/metrics":
            # the flat-JSON contract: this session's serving stats
            self._json(200, session.stats())
        elif path == "/metrics":
            # the full pane: the process-wide registry (engine, fit,
            # kvstore, io, spans) and the session's registry
            regs = (_tel.registry(), session.metrics)
            if "format=json" in query or "application/json" in \
                    self.headers.get("Accept", ""):
                self._json(200, _tel.json_snapshot(*regs))
            else:
                self._text(200, _tel.prometheus_text(*regs),
                           _tel.PROMETHEUS_CONTENT_TYPE)
        else:
            self._json(404, {"error": "unknown path %s" % self.path})

    def do_POST(self):
        if self.path.partition("?")[0] not in ("/v1/predict", "/predict"):
            self._json(404, {"error": "unknown path %s" % self.path})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
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
            outs = self.server.session.predict(inputs, timeout=timeout)
            self._json(200, {"outputs": [o.tolist() for o in outs]})
        except QueueFull as exc:
            self._json(429, {"error": str(exc)})
        except TimeoutError as exc:
            self._json(504, {"error": str(exc)})
        except BatcherClosed as exc:
            self._json(503, {"error": str(exc)})
        except MXNetError as exc:
            self._json(400, {"error": str(exc)})
        except Exception as exc:  # backend failure: JSON 500, not a reset
            self._json(500, {"error": "%s: %s" % (type(exc).__name__, exc)})


class ServingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer bound to a ServingSession. ``shutdown`` drains
    the session before the socket closes."""

    daemon_threads = True

    def __init__(self, session, host="127.0.0.1", port=0,
                 request_timeout=30.0):
        super().__init__((host, port), _Handler)
        self.session = session
        self.request_timeout = request_timeout

    @property
    def endpoint(self):
        return "http://%s:%d" % self.server_address[:2]

    def shutdown(self):
        self.session.close(drain=True)
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
