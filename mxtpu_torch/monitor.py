"""Monitor: per-batch statistics of a graph's intermediate tensors.

Counterpart of ``mxtpu/monitor.py``'s per-op ("legacy") path: ``install``
puts ``stat_helper`` on an executor as its monitor callback, ``tic``
arms every ``interval``-th batch, and on an armed batch the executor
hands the callback every op's visible outputs by name (unfused: the
BatchNorm outputs an inference walk would fold into the epilogue are
seen), ``stat_func`` runs on each name that ``pattern`` matches, and
``toc`` collects them with the executors' graph outputs. Unarmed batches
keep the fused walk. ``toc`` also sets mxtpu's ``monitor_stat{name}``
gauge (:122) of each numeric statistic (``k[i]`` for the elements of a
list-valued one). mxtpu's device adapter over its training-health tap
kernels is not ported: the default statistic gives the same numbers on
the per-op path, which ``Module.install_monitor`` always takes.
"""
from __future__ import annotations

import logging
import numbers
import re

from . import telemetry as _tel

__all__ = ["Monitor"]


def _scalar(v):
    """``v`` as a float when it is one number (a Python or numpy scalar,
    or a one-element array), else None."""
    if isinstance(v, numbers.Real):
        return float(v)
    if getattr(v, "size", None) == 1 and hasattr(v, "__float__"):
        return float(v)
    return None


class Monitor:
    """Statistics of the tensors whose names match ``pattern``, every
    ``interval`` batches; ``stat_func(NDArray)`` defaults to the mean
    absolute value (on the host); ``sort`` orders ``toc``'s entries by
    name."""

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        self.stat_func = stat_func or (lambda x: abs(x.asnumpy()).mean())
        self.interval, self.sort = interval, sort
        self.re_prog = re.compile(pattern)
        self.activated, self.step = False, 0
        self.queue, self.exes = [], []

        def stat_helper(name, arr):
            if not self.activated or not self.re_prog.match(name):
                return
            self.queue.append((self.step, name, self.stat_func(arr)))
        # the executors ask this, so only armed batches walk per op
        stat_helper.is_active = lambda: self.activated
        self.stat_helper = stat_helper

    def install(self, exe):
        exe.set_monitor_callback(self.stat_helper)
        self.exes.append(exe)

    def tic(self):
        """Arm this batch when it is the ``interval``-th."""
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """The armed batch's stats, as (step, name, stat string) tuples
        (sorted by name with ``sort``), with each installed executor's
        matching graph outputs after the ops'. Leaves the monitor
        disarmed with an empty queue, also when ``stat_func`` raises."""
        if not self.activated:
            return []
        try:
            for exe in self.exes:
                self.queue.extend(
                    (self.step, n, self.stat_func(arr))
                    for n, arr in zip(exe.output_names, exe.outputs)
                    if self.re_prog.match(n))
            entries = sorted(self.queue, key=lambda e: e[1]) if self.sort \
                else list(self.queue)
        finally:
            self.activated = False
            self.queue = []
        res = []
        for n, k, value in entries:
            values = value if isinstance(value, list) else [value]
            # monitored stats double as telemetry series, so a scrape sees
            # what the log line prints; non-numeric stats only print
            for i, v in enumerate(values):
                num = _scalar(v)
                if num is not None:
                    _tel.gauge("monitor_stat", labels={
                        "name": k if len(values) == 1 else "%s[%d]" % (k, i)},
                        help="latest Monitor stat per tensor "
                             "(stat_func output)").set(num)
            res.append((n, k, "".join("%s\t" % v for v in values)))
        return res

    def toc_print(self):
        for n, k, v in self.toc():
            logging.info("Batch: %7d %30s %s", n, k, v)
