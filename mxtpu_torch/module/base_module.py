"""BaseModule: the training loop (parity: python/mxnet/module/
base_module.py — fit :376-525, score).

Counterpart of ``mxtpu/module/base_module.py:131-``: ``fit`` binds,
initializes, arms the optimizer and loops over the epochs with
``forward_backward`` + ``update``, the eval metric accumulating on the
device (``metric.DeviceMetricAccum``, one sum per context) and reaching
the host only at the metric-sync cadence, and at most ``max_in_flight``
steps queued on the device ahead of the host. ``device_prefetch`` stages
each next batch on the first context's device from a producer thread
(``io.DevicePrefetchIter``), as mxtpu's does; the executor group copies
each context's rows to its device. ``kvstore`` is what
``Module.init_optimizer`` takes: a name or a ``KVStore``. ``mesh``
(mxtpu/module/base_module.py:139-150, 256-281) trains data-parallel over
a device mesh with cross-replica weight-update sharding: it goes through
``sharding.resolve`` and stays active (``sharding.use``) for the whole
fit, where ``Module._arm_fused`` finds it; ``None`` defers to
``MXTPU_MESH`` and ``False`` turns the mesh off even with it set. The
pipeline knobs (``max_in_flight``, ``metric_sync``, ``device_metrics``,
``device_prefetch``) resolve through ``tune`` as mxtpu's do (:210-240):
default < ``tuned`` artifact < env < explicit argument, recorded in
``self._fit_knobs``. The knobs of mxtpu's fit that the port does not
have yet (``elastic``, ``resume``, ``health``) raise MXNetError when
set, rather than being ignored. Telemetry as mxtpu's (:425-444, :490,
:614): each step runs in a ``fit.step`` span (the correlation root of
the executor's and kvstore's spans) and observes ``fit_dispatch_ms``
(the host time to launch it) and ``fit_step_ms`` (that plus the pacing
wait, ``fit_sync_wait_ms``); ``fit_metric_sync_ms`` times the cadence
sync; ``fit_samples``, ``fit_samples_per_sec`` and ``fit_epochs`` count
the epochs, and ``fit.eval`` / ``fit_eval_ms`` the validation pass. No
site waits for the card: the only waits are the pacer's event (which
crosses the ``executor.device_wait`` fault point) and the metric sync.
``monitor`` is installed after ``bind`` and armed with ``tic``/
``toc_print`` around each batch (mxtpu :317, :485, :563),
its per-op path taking the host metric. ``iter_predict`` and ``predict``
(mxtpu :91-129) run the inference forward batch by batch, each batch's
outputs trimmed of its pad; a module with no device views of its step
(``_step_views`` None: a ``SequentialModule``) takes the host metric in
``fit``.
"""
from __future__ import annotations

import logging
import time
from collections import deque
from functools import reduce
from math import gcd

import torch

from .. import callback as _cb
from .. import io as _io
from .. import metric as _metric
from .. import model as _model
from .. import ndarray as nd
from .. import sharding as _sharding
from .. import telemetry as _tel
from .. import tune as _tune
from ..base import MXNetError
from ..faults import injection as _faults
from ..initializer import Uniform
from ..model import BatchEndParam

__all__ = ["BaseModule", "BatchEndParam"]


def _as_list(obj):
    if obj is None:
        return []
    return list(obj) if isinstance(obj, (list, tuple)) else [obj]


_UNPORTED_FIT = ("elastic", "resume", "health")


def refuse_unported(**knobs):
    """Raise MXNetError for a knob of mxtpu's fit the port lacks."""
    for name in _UNPORTED_FIT:
        if knobs.get(name) not in (None, False):
            raise MXNetError("fit(%s=...) is not ported yet" % name)


def _metric_sync(callbacks, tuned=None):
    """The metric-sync cadence in batches: the gcd of the Speedometers'
    ``frequent`` (every window boundary is a sync); 1 when another batch
    callback may read live values; 0 (epoch end only) with none. A
    ``tuned`` cadence (the artifact's, mxtpu's :385-410) is reconciled by
    gcd with the Speedometers', so no meter boundary misses a sync, and
    applies as it is when there are no callbacks."""
    if any(not isinstance(c, _cb.Speedometer) for c in callbacks):
        return 1
    freqs = [c.frequent for c in callbacks]
    if freqs:
        cadence = reduce(gcd, freqs)
        return gcd(cadence, int(tuned)) if tuned else cadence
    return int(tuned) if tuned is not None else 0


class _Pacer:
    """Keeps at most ``limit`` training steps queued on the device: one
    CUDA event per step, waiting on the oldest when the window is full.
    On the CPU a step is done when it returns: the window still counts
    its steps and "waits" on the oldest (a wait that returns at once), so
    the waits, the ``executor.device_wait`` fault point and
    ``fit_sync_wait_ms`` see what mxtpu's window sees on any device
    (mxtpu/module/base_module.py:519-530)."""

    def __init__(self, limit, device, wait_ms=None):
        self.limit = max(1, int(limit))
        self.cuda = device.type == "cuda"
        self._events = deque()
        self._wait_ms = wait_ms

    def step_done(self):
        """Record the step's event; wait for the oldest while more than
        ``limit`` are queued. Returns the ms spent waiting, each wait
        observed into ``fit_sync_wait_ms``."""
        ev = None
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record()
        self._events.append(ev)
        waited = 0.0
        while len(self._events) > self.limit:
            t0 = time.perf_counter()
            _faults.point("executor.device_wait")
            oldest = self._events.popleft()
            if oldest is not None:
                oldest.synchronize()
            w = (time.perf_counter() - t0) * 1e3
            if self._wait_ms is not None:
                self._wait_ms.observe(w)
            waited += w
        return waited

    def clear(self):
        self._events.clear()


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    @property
    def symbol(self):
        return self._symbol

    def check(self, passes=None, pipeline=None):
        """Run the analysis verifier passes with everything this module
        knows — the bound data/label shapes, the provided parameter names
        (unused-arg detection), and the live fused train step (the
        in-place update audit) — and return a
        :class:`~mxtpu_torch.analysis.Report` (mxtpu :640-654).
        ``pipeline`` (a transform-name list, comma string, or True for
        the configured pipeline) additionally dry-runs the compile
        pipeline's transforms and merges what each did."""
        from ..analysis import check_module
        return check_module(self, passes=passes, pipeline=pipeline)

    def _host_round_trip(self):
        return False

    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def save_params(self, fname):
        """The live params as one ``.params`` file (arg:/aux: names)."""
        arg_params, aux_params = self.get_params()
        save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
        save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
        nd.save(fname, save_dict)

    def load_params(self, fname):
        self.set_params(*_model.split_params(nd.load(fname), fname))

    @property
    def output_shapes(self):
        raise NotImplementedError

    def install_monitor(self, mon):
        raise NotImplementedError

    def prepare(self, data_batch):
        """Get ready for ``data_batch`` before its forward (a bucket's
        module bound); nothing to do for a plain module."""

    def _step_views(self):
        """[(labels, outputs)] of the last step on the device, or None
        when this module has none (fit then takes the host metric)."""
        return None

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Yield (outputs, batch index, batch) of each batch's inference
        forward, the outputs without the batch's pad rows."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            outputs = [out[0:out.shape[0] - pad]
                       for out in self.get_outputs()]
            yield (outputs, nbatch, eval_batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """The inference outputs of ``eval_data``, each batch's pad
        trimmed: per output, the batches concatenated (one NDArray for a
        single output unless ``always_output_list``), or with
        ``merge_batches=False`` a list of each batch's outputs."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            output_list.append([out[0:out.shape[0] - pad].copy()
                                for out in self.get_outputs()])
        if not output_list:
            return output_list
        if not merge_batches:
            return output_list
        num_outputs = len(output_list[0])
        if any(len(out) != num_outputs for out in output_list):
            raise ValueError("Cannot merge batches: different outputs")
        merged = [nd.concatenate([out[i] for out in output_list])
                  for i in range(num_outputs)]
        if num_outputs == 1 and not always_output_list:
            return merged[0]
        return merged

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, reset=True, epoch=0):
        """Evaluate over ``eval_data``; returns the metric's name/value
        pairs."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        eval_metric = _metric.create(eval_metric)
        eval_metric.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            for callback in _as_list(batch_end_callback):
                callback(BatchEndParam(epoch, nbatch, eval_metric, locals()))
        return eval_metric.get_name_value()

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, max_in_flight=None, metric_sync=None,
            device_metrics=None, device_prefetch=None, mesh=None,
            elastic=None, resume=None, tuned=None, health=None):
        """Train for ``num_epoch`` epochs (parity base_module.py:376-525).

        ``max_in_flight``: at most this many steps queued on the device
        ahead of the host. ``metric_sync``: device->host metric sync every
        this many batches (None derives it from the batch callbacks:
        the Speedometers' ``frequent``, 1 with any other callback, else
        epoch end only). ``device_metrics``: accumulate the eval metric on
        the device (metrics without a device kernel stay on the numpy
        path). ``device_prefetch``: wrap ``train_data`` (unless it is one
        already) in a ``DevicePrefetchIter`` onto the module's context,
        closed when fit ends (mxtpu/module/base_module.py:242-256).
        ``mesh``: anything ``sharding.resolve`` takes (an int, ``"all"``,
        ``"data:4"``, a ``Mesh`` or ``MeshContext``; ``None`` reads
        ``MXTPU_MESH``, ``False`` disables), active for the whole fit.
        ``tuned``: a ``tune.TunedConfig`` (or a path to one) the four
        knobs above take their defaults from, with precedence default <
        artifact < env (``MXTPU_FIT_INFLIGHT``, ``MXTPU_FIT_METRIC_SYNC``,
        ``MXTPU_FIT_DEVICE_METRICS``, ``MXTPU_FIT_DEVICE_PREFETCH``) <
        explicit argument; ``None`` defers to the process-active artifact
        (``tune.use`` / ``MXTPU_TUNED``), ``False`` ignores it. A stale
        artifact is refused."""
        refuse_unported(elastic=elastic, resume=resume, health=health)
        tuned = _tune.artifact(tuned)
        max_in_flight = _tune.resolve_int(
            "fit.max_in_flight", explicit=max_in_flight, artifact=tuned,
            floor=1)
        # an explicit or env cadence wins outright; the artifact's is a
        # preference _metric_sync reconciles with the callbacks (mxtpu's
        # :217-226)
        metric_sync = _tune.resolve("fit.metric_sync", explicit=metric_sync,
                                    artifact=False)
        tuned_metric_sync = _tune.resolve("fit.metric_sync",
                                          artifact=tuned) \
            if metric_sync is None else None
        device_metrics = _tune.resolve(
            "fit.device_metrics", explicit=device_metrics, artifact=tuned)
        device_prefetch = _tune.resolve(
            "fit.device_prefetch", explicit=device_prefetch, artifact=tuned)
        self._fit_knobs = {"fit.max_in_flight": max_in_flight,
                           "fit.metric_sync": metric_sync,
                           "fit.device_metrics": device_metrics,
                           "fit.device_prefetch": device_prefetch}
        with _sharding.use(_sharding.resolve(mesh)):
            self._fit(train_data, eval_data, eval_metric,
                      epoch_end_callback, batch_end_callback, kvstore,
                      optimizer, optimizer_params, eval_end_callback,
                      eval_batch_end_callback, initializer, arg_params,
                      aux_params, allow_missing, force_rebind, force_init,
                      begin_epoch, num_epoch, validation_metric, monitor,
                      max_in_flight, metric_sync, device_metrics,
                      device_prefetch, tuned_metric_sync)

    def _fit(self, train_data, eval_data, eval_metric, epoch_end_callback,
             batch_end_callback, kvstore, optimizer, optimizer_params,
             eval_end_callback, eval_batch_end_callback, initializer,
             arg_params, aux_params, allow_missing, force_rebind,
             force_init, begin_epoch, num_epoch, validation_metric, monitor,
             max_in_flight, metric_sync, device_metrics, device_prefetch,
             tuned_metric_sync=None):
        if num_epoch is None:
            raise MXNetError("fit: please specify num_epoch")
        initializer = initializer or Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
            device_metrics = False  # toc reads the batch's host stats
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        eval_metric = _metric.create(eval_metric)
        accum = _metric.DeviceMetricAccum.wrap(eval_metric) \
            if device_metrics else None
        eval_metric._device_accum = accum
        callbacks = _as_list(batch_end_callback)
        if metric_sync is None:
            metric_sync = _metric_sync(callbacks, tuned_metric_sync)
        metric_sync = max(0, int(metric_sync))
        if hasattr(self, "_fit_knobs"):
            self._fit_knobs["fit.metric_sync"] = metric_sync
        # one pipeline for training and serving: fit emits into the same
        # process-wide registry the serving /metrics endpoint scrapes
        step_ms = _tel.histogram(
            "fit_step_ms",
            help="wall time per step: dispatch + pipeline pacing wait")
        dispatch_ms = _tel.histogram(
            "fit_dispatch_ms",
            help="host time to issue one step (async dispatch, no device "
                 "wait) — fit_step_ms minus this is pacing/back-pressure")
        sync_wait_ms = _tel.histogram(
            "fit_sync_wait_ms",
            help="pacing: wall time blocked on the oldest in-flight step")
        msync_ms = _tel.histogram(
            "fit_metric_sync_ms",
            help="device->host metric snapshot wall time (cadence sync)")
        samples_total = _tel.counter("fit_samples",
                                     help="training examples consumed")
        sps_gauge = _tel.gauge("fit_samples_per_sec",
                               help="epoch-level training throughput")
        eval_ms = _tel.histogram("fit_eval_ms",
                                 help="validation pass wall time")
        epochs_done = _tel.counter("fit_epochs", help="epochs completed")
        pacer = _Pacer(max_in_flight, getattr(self, "_device",
                                              torch.device("cpu")),
                       wait_ms=sync_wait_ms)
        owned = None
        if device_prefetch and not isinstance(train_data,
                                              _io.DevicePrefetchIter):
            train_data = owned = _io.DevicePrefetchIter(
                train_data, device=self._context[0])
        try:
            for epoch in range(begin_epoch, num_epoch):
                tic = time.time()
                eval_metric.reset()
                if accum is not None:
                    accum.reset()
                data_iter = iter(train_data)
                nbatch = 0
                epoch_samples = 0
                data_batch = next(data_iter, None)
                while data_batch is not None:
                    if monitor is not None:
                        monitor.tic()
                    # fit.step is the correlation root of everything one
                    # batch triggers (executor forward/backward, kvstore
                    # push/pull inside update)
                    with _tel.span("fit.step", category="module") as sp:
                        self.forward_backward(data_batch)
                        self.update()
                    dispatch_ms.observe(sp.duration_ms)
                    if data_batch.data:
                        epoch_samples += data_batch.data[0].shape[0] - \
                            (data_batch.pad or 0)
                    next_batch = next(data_iter, None)
                    views = self._step_views() if accum is not None \
                        else None
                    pacing = 0.0
                    if views is not None:
                        for labels, outs in views:
                            accum.update(labels, outs)
                        pacing = pacer.step_done()
                    else:
                        self.update_metric(eval_metric, data_batch.label)
                    step_ms.observe(sp.duration_ms + pacing)
                    last = next_batch is None
                    if views is not None and (
                            last or metric_sync == 1 or
                            (metric_sync and nbatch and
                             nbatch % metric_sync == 0)):
                        t0 = time.perf_counter()
                        accum.sync()
                        msync_ms.observe((time.perf_counter() - t0) * 1e3)
                        if last:
                            pacer.clear()
                    if monitor is not None:
                        monitor.toc_print()
                    for callback in callbacks:
                        callback(BatchEndParam(epoch, nbatch, eval_metric,
                                               locals()))
                    nbatch += 1
                    data_batch = next_batch
                for name, val in eval_metric.get_name_value():
                    self.logger.info("Epoch[%d] Train-%s=%f", epoch, name,
                                     val)
                toc = time.time()
                self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                                 toc - tic)
                samples_total.inc(epoch_samples)
                epochs_done.inc()
                if toc > tic:
                    sps_gauge.set(epoch_samples / (toc - tic))
                epoch_cbs = _as_list(epoch_end_callback)
                if epoch_cbs or self._host_round_trip():
                    arg_params, aux_params = self.get_params()
                    if self._host_round_trip():
                        self.set_params(arg_params, aux_params)
                    for callback in epoch_cbs:
                        callback(epoch, self.symbol, arg_params, aux_params)
                if eval_data:
                    if accum is not None:
                        accum.last_snapshot = None
                    with _tel.span("fit.eval", category="module") as sp:
                        res = self.score(eval_data, validation_metric,
                                         batch_end_callback=(
                                             eval_batch_end_callback),
                                         epoch=epoch)
                    eval_ms.observe(sp.duration_ms)
                    for callback in _as_list(eval_end_callback):
                        callback(BatchEndParam(epoch, 0, validation_metric,
                                               locals()))
                    for name, val in res:
                        self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                         name, val)
                train_data.reset()
        finally:
            eval_metric._device_accum = None
            if owned is not None:
                owned.close()
