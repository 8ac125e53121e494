"""Training callbacks (parity: python/mxnet/callback.py — do_checkpoint
:55, log_train_metric, Speedometer :120, ProgressBar,
LogValidationMetricsCallback).

The port's own copy of the callbacks of ``mxtpu/callback.py`` that a
Module fit uses. Speedometer reads the metric snapshot that ``fit`` takes
at its metric-sync cadence when the metric accumulates on the device, so
it forces no device sync of its own, and sets mxtpu's series (:96-104):
the ``train_samples_per_sec`` gauge, the
``train_window_samples_per_sec`` histogram and a ``train_metric{metric}``
gauge of each scalar metric value. ``module_checkpoint`` and
``do_checkpoint`` write through the elastic snapshot writer, as mxtpu's
do (:14-45): ``module_checkpoint`` captures the live Module's device
state itself, so ``fit`` hands it no host copy of the params.
"""
from __future__ import annotations

import logging
import math
import numbers
import sys
import time

from . import telemetry as _tel

__all__ = ["module_checkpoint", "do_checkpoint", "Speedometer",
           "log_train_metric", "ProgressBar", "LogValidationMetricsCallback"]


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback: ``mod.save_checkpoint(..., async_write=True)``
    every ``period`` epochs. It reads the live Module's state on the card
    itself (the fused step's clones), so it needs no host params from
    ``fit`` (``_needs_host_params`` False)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states,
                                async_write=True)
    _callback._needs_host_params = False
    return _callback


def do_checkpoint(prefix, period=1):
    """Epoch-end callback: ``model.save_checkpoint`` of the symbol and
    params ``fit`` hands it, every ``period`` epochs, written on the
    snapshot writer's thread while the next epoch runs."""
    from .model import save_checkpoint
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux,
                            async_write=True)
    return _callback


def log_train_metric(period, auto_reset=False):
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()
    return _callback


class Speedometer:
    """Windowed samples/sec over ``frequent`` batches, logged with the
    metric's values."""

    def __init__(self, batch_size, frequent=50, auto_reset=True, log=True):
        self.batch_size = batch_size
        self.frequent = max(1, int(frequent))
        self.auto_reset = auto_reset
        self.log = log
        self._window_start = None  # wall time at the start of the window
        self._prev_nbatch = -1

    def _emit(self, param, speed):
        metric = getattr(param, "eval_metric", None)
        accum = getattr(metric, "_device_accum", None) \
            if metric is not None else None
        if accum is not None and accum.last_snapshot is not None:
            pairs = accum.last_snapshot
        elif metric is not None:
            pairs = metric.get_name_value()
        else:
            pairs = []
        _tel.gauge("train_samples_per_sec",
                   help="Speedometer window throughput").set(speed)
        _tel.histogram(
            "train_window_samples_per_sec",
            bounds=(1, 10, 100, 1e3, 1e4, 1e5, 1e6, 1e7, float("inf")),
            help="distribution of window throughput").observe(speed)
        for k, v in pairs:
            if isinstance(v, numbers.Real):  # the registry stays numeric
                _tel.gauge("train_metric", labels={"metric": k}).set(
                    float(v))
        if self.log:
            extra = "".join("\t%s=%g" % (k, v) for k, v in pairs)
            logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec%s",
                         param.epoch, param.nbatch, speed, extra)
        if pairs and self.auto_reset:
            metric.reset()

    def __call__(self, param):
        n = param.nbatch
        if n < self._prev_nbatch:          # new epoch: restart the window
            self._window_start = None
        self._prev_nbatch = n
        if self._window_start is None:
            self._window_start = time.time()
            return
        if n % self.frequent:
            return
        elapsed = time.time() - self._window_start
        if elapsed > 0:
            self._emit(param, self.frequent * self.batch_size / elapsed)
        self._window_start = time.time()


class ProgressBar:
    """Textual progress bar over the epoch's ``total`` batches, written
    to standard output."""

    def __init__(self, total, length=80):
        self.bar_len = int(length)
        self.total = max(1, int(total))

    def __call__(self, param):
        frac = min(1.0, param.nbatch / float(self.total))
        done = int(round(self.bar_len * frac))
        bar = "=" * done + "-" * (self.bar_len - done)
        sys.stdout.write("[%s] %s%%\r" % (bar, math.ceil(100.0 * frac)))


class LogValidationMetricsCallback:
    """Logs each validation metric at an evaluation's end."""

    def __call__(self, param):
        if not param.eval_metric:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name,
                         value)
