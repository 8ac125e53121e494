"""Training callbacks (parity: python/mxnet/callback.py — do_checkpoint
:55, log_train_metric, Speedometer :120).

The port's own copy of the callbacks of ``mxtpu/callback.py`` that a
Module fit uses, without the telemetry registry (not ported). Speedometer
reads the metric snapshot that ``fit`` takes at its metric-sync cadence
when the metric accumulates on the device, so it forces no device sync
of its own. ``do_checkpoint`` writes synchronously, where mxtpu's goes
through its asynchronous snapshot writer (not ported); the files are
the same either way.
"""
from __future__ import annotations

import logging
import time

__all__ = ["do_checkpoint", "Speedometer", "log_train_metric"]


def do_checkpoint(prefix, period=1):
    """Epoch-end callback: ``model.save_checkpoint`` of the symbol and
    params ``fit`` hands it, every ``period`` epochs."""
    from .model import save_checkpoint
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
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
