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
``self._fit_knobs``; an active ``tune.online`` controller may move the
in-flight window inside its certified range while the fit runs.
``elastic`` and ``resume`` (mxtpu :259-289, 338-352, 449-502, 560-570,
624-628; ``elastic/``) arm the async snapshots of an ``ElasticSession``
and restore a generation after bind/init: a mid-epoch resume keeps the
restored metric sums and iterator cursor through the epoch top, or
replays and discards the epoch head where the iterator has no cursor;
the session's ``pre_lookahead`` runs before the lookahead fetch and its
``on_step`` after the step's cadence work and before the batch
callbacks (where a supervisor's wedge or SIGTERM surfaces), its
``on_epoch`` after ``train_data.reset()``; a fit that returns leaves
every snapshot and async checkpoint durable. Epoch-end callbacks that
read the device state themselves (``_needs_host_params`` False:
``callback.module_checkpoint``) get no host copy of the params.
``health`` (mxtpu :360-380, 534-560) arms the training-health
rows of the fused step (``obs/health.py``): they ride the metric
accumulator's cadence transfer, and the detectors run on each cadence;
without a fused step it is disarmed with a log line. Diagnostics as
mxtpu's (:258-291): ``fit`` arms the hang watchdog and, while it runs,
the ``SIGUSR2`` handler; the pacer's wait is a registered device wait
with the ``executor.device_wait`` fault point inside it; an exception
other than an MXNetError that escapes the fit leaves a postmortem; and
with ``MXTPU_CORPUS_DIR`` set each step appends a ``fit_step`` service
row. Telemetry as mxtpu's (:425-444, :490,
:614): each step runs in a ``fit.step`` span (the correlation root of
the executor's and kvstore's spans) and observes ``fit_dispatch_ms``
(the host time to launch it) and ``fit_step_ms`` (that plus the pacing
wait, ``fit_sync_wait_ms``); ``fit_metric_sync_ms`` times the cadence
sync; ``fit_samples``, ``fit_samples_per_sec`` and ``fit_epochs`` count
the epochs, and ``fit.eval`` / ``fit_eval_ms`` the validation pass. No
site waits for the card: the only waits are the pacer's event (which
crosses the ``executor.device_wait`` fault point) and the metric sync.
``monitor`` is installed after ``bind`` and armed with ``tic``/
``toc_print`` around each batch (mxtpu :317, :485, :563): in adapter
mode (the default statistic over a fused step) its taps ride the
health session's cadence and a sampled batch forces one; on its per-op
path it takes the host metric. ``iter_predict`` and ``predict``
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
from .. import diagnostics as _diag
from .. import io as _io
from .. import metric as _metric
from .. import model as _model
from .. import ndarray as nd
from .. import sharding as _sharding
from .. import telemetry as _tel
from .. import tune as _tune
from ..base import MXNetError
from ..faults import injection as _faults
from ..obs import corpus as _obs_corpus
from ..initializer import Uniform
from ..model import BatchEndParam

__all__ = ["BaseModule", "BatchEndParam"]


def _as_list(obj):
    if obj is None:
        return []
    return list(obj) if isinstance(obj, (list, tuple)) else [obj]


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
    (mxtpu/module/base_module.py:519-530). ``limit`` is a one-slot holder
    ``{"v": K}`` read at each step (the online controller moves it), or
    an int. Each wait registers with the watchdog (``wait_begin``, mxtpu
    executor.py:55-74), the fault point inside it, so an injected latency
    looks to the watchdog exactly like a wedged card."""

    def __init__(self, limit, device, wait_ms=None):
        self._limit = limit if isinstance(limit, dict) else \
            {"v": max(1, int(limit))}
        self.cuda = device.type == "cuda"
        self._events = deque()
        self._wait_ms = wait_ms

    @property
    def limit(self):
        return max(1, int(self._limit["v"]))

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
            oldest = self._events.popleft()
            _diag.wait_begin("device_wait")
            try:
                _faults.point("executor.device_wait")
                if oldest is not None:
                    oldest.synchronize()
            finally:
                _diag.wait_end()
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
        artifact is refused. ``health``: arm the device-resident
        training-health rows and the detector suite (``obs/health.py``);
        ``None`` defers to ``MXTPU_HEALTH``; they ride the metric-sync
        cadence, adding no host round trip. ``elastic``: a prefix string,
        an ``elastic.ElasticConfig`` or its kwargs dict (``None`` reads
        ``MXTPU_ELASTIC``, ``False`` disables): snapshot the train state
        asynchronously at its cadence. ``resume``: ``True`` resumes the
        elastic prefix's newest durable generation (a fresh start when
        there is none), or a prefix / manifest path; the resumed fit is
        bit-exact on weights against an uninterrupted run."""
        from .. import elastic as _elastic
        el_cfg = _elastic.ElasticConfig.resolve(elastic)
        resume_state = None
        if resume:
            spec = resume
            if resume is True:
                if el_cfg is None:
                    raise MXNetError(
                        "fit(resume=True) needs elastic= (or MXTPU_ELASTIC)"
                        " to name the checkpoint prefix")
                spec = el_cfg.prefix
            resume_state = _elastic.load_resume(spec)
            if resume_state is None:
                self.logger.info(
                    "fit(resume): no durable generation at %r — starting "
                    "fresh", spec)
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
        mesh_ctx = _sharding.resolve(mesh)
        # the hang watchdog (MXTPU_WATCHDOG=0 opts out) and the SIGUSR2
        # postmortem handler (mxtpu :258-262)
        _diag.on_session_start()
        try:
            with _sharding.use(mesh_ctx):
                self._fit(train_data, eval_data, eval_metric,
                          epoch_end_callback, batch_end_callback, kvstore,
                          optimizer, optimizer_params, eval_end_callback,
                          eval_batch_end_callback, initializer, arg_params,
                          aux_params, allow_missing, force_rebind,
                          force_init, begin_epoch, num_epoch,
                          validation_metric, monitor, max_in_flight,
                          metric_sync, device_metrics, device_prefetch,
                          tuned_metric_sync, health, el_cfg, resume_state)
        except Exception as exc:
            # a fatal training exception: capture the flight ring, the
            # ledger and the engine state before the stack unwinds. An
            # MXNetError is a usage error, not a backend failure (mxtpu
            # :276-291; the port's native failures are MXNetErrors too)
            if not isinstance(exc, MXNetError):
                _diag.postmortem("fit_exception", exc=exc, source="fit")
            raise
        finally:
            _diag.on_session_end()

    def _fit(self, train_data, eval_data, eval_metric, epoch_end_callback,
             batch_end_callback, kvstore, optimizer, optimizer_params,
             eval_end_callback, eval_batch_end_callback, initializer,
             arg_params, aux_params, allow_missing, force_rebind,
             force_init, begin_epoch, num_epoch, validation_metric, monitor,
             max_in_flight, metric_sync, device_metrics, device_prefetch,
             tuned_metric_sync=None, health=None, el_cfg=None,
             resume_state=None):
        if num_epoch is None:
            raise MXNetError("fit: please specify num_epoch")
        initializer = initializer or Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        # only now is the monitor's path settled: install_monitor may have
        # gone adapter mode, and init_optimizer walked it back when the
        # fused step declined (mxtpu :311-318); the per-op path reads the
        # batch's host stats, which the device accumulator would miss
        monitor_adapter = monitor is not None and \
            getattr(self, "_monitor_adapter", None) is monitor
        if monitor is not None and not monitor_adapter:
            device_metrics = False
        if validation_metric is None:
            validation_metric = eval_metric
        eval_metric = _metric.create(eval_metric)
        # elastic resume: applied AFTER bind/init, so set_params writes
        # the restored values into the bound arrays and the restored RNG
        # streams are not consumed by the (overwritten) initializer draws
        from .. import elastic as _elastic
        el_session = None
        restored_iter = False
        if resume_state is not None:
            restored_iter = _elastic.apply_resume(
                self, resume_state, eval_metric=eval_metric,
                train_data=train_data)
            begin_epoch = max(begin_epoch, resume_state.begin_epoch)
        if el_cfg is not None:
            el_session = _elastic.ElasticSession(
                self, el_cfg, logger=self.logger,
                resume_state=resume_state)
        accum = _metric.DeviceMetricAccum.wrap(eval_metric) \
            if device_metrics else None
        eval_metric._device_accum = accum
        # training health: the fused step's rows and the detectors, on
        # the metric-sync cadence; the Monitor adapter rides the same
        # session with its detectors off (mxtpu :360-380)
        from ..obs import health as _health
        if health is None:
            health = _health.armed_by_env()
        health_session = None
        fused = getattr(self, "_fused", None)
        if fused is not None and (health or monitor_adapter):
            health_session = _health.HealthSession(
                fused, monitor=monitor if monitor_adapter else None,
                detect=bool(health), logger=self.logger)
            if accum is not None:
                accum.add_rider(health_session)
        elif health:
            self.logger.info(
                "fit(health): the fused train step is not armed — "
                "training-health stats are computed inside it; disarmed "
                "for this fit")
        self._health_session = health_session
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
        # the live in-flight window: an active online controller
        # (tune.online) may move it inside the certified range
        from ..tune import online as _online
        inflight_limit = _online.attach_fit(
            {"v": max(1, int(max_in_flight))})
        pacer = _Pacer(inflight_limit, getattr(self, "_device",
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
                # a mid-epoch resume continues THIS epoch: the restored
                # metric sums and iterator cursor survive its top once
                resumed_here = (resume_state is not None
                                and not resume_state.epoch_boundary
                                and epoch == resume_state.epoch)
                if not resumed_here:
                    eval_metric.reset()
                    if accum is not None:
                        accum.reset()
                data_iter = iter(train_data)
                nbatch = 0
                if resumed_here:
                    nbatch = resume_state.start_nbatch
                    if not restored_iter:
                        # an iterator without a cursor: replay the epoch
                        # head and discard it (same order, no training,
                        # no RNG draws)
                        for _ in range(nbatch):
                            if next(data_iter, None) is None:
                                break
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
                    if health_session is not None:
                        # fold the step's device rows (no transfer)
                        health_session.on_step()
                    if el_session is not None:
                        # BEFORE the lookahead fetch below: the only
                        # point where the iterator's cursor still reads
                        # "batches 0..nbatch consumed"
                        el_session.pre_lookahead(train_data, epoch, nbatch)
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
                    if _obs_corpus.enabled():
                        # the corpus's service row: the step's wall time,
                        # keyed by batch rows (mxtpu :534-538)
                        _obs_corpus.record_service(
                            "fit_step", sp.duration_ms + pacing,
                            rows=data_batch.data[0].shape[0]
                            if data_batch.data else None)
                    last = next_batch is None
                    cadence_now = (last or metric_sync == 1 or
                                   (metric_sync and nbatch and
                                    nbatch % metric_sync == 0))
                    if health_session is not None and monitor is not None \
                            and monitor.activated:
                        # a sampled batch forces a cadence so its taps
                        # land before toc_print below
                        cadence_now = True
                    if views is not None and cadence_now:
                        t0 = time.perf_counter()
                        accum.sync()
                        msync_ms.observe((time.perf_counter() - t0) * 1e3)
                        if last:
                            pacer.clear()
                    elif health_session is not None and cadence_now:
                        health_session.sync_direct()
                    if health_session is not None and cadence_now:
                        # the detectors run BEFORE el_session.on_step
                        # below, so a rollback aborts before a snapshot
                        # of the diverged state
                        health_session.on_cadence(eval_metric)
                    if monitor is not None:
                        monitor.toc_print()
                    if el_session is not None:
                        # the cadence snapshot point, and where the
                        # supervisor's wedge or SIGTERM surfaces
                        el_session.on_step(eval_metric, accum, train_data)
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
                # a callback that reads the device state itself
                # (module_checkpoint) needs no host copy of the params
                epoch_cbs = _as_list(epoch_end_callback)
                need_host = any(getattr(cb, "_needs_host_params", True)
                                for cb in epoch_cbs)
                arg_params = aux_params = None
                if need_host or self._host_round_trip():
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
                if el_session is not None:
                    el_session.on_epoch(epoch, eval_metric, train_data)
            # fit returning implies its snapshots and async checkpoints
            # are durable
            from ..elastic import snapshot as _snapshot
            _snapshot.flush_pending()
        finally:
            eval_metric._device_accum = None
            if health_session is not None:
                if accum is not None:
                    accum.remove_rider(health_session)
                health_session.close()
            _online.release(inflight_limit)
            if owned is not None:
                owned.close()
