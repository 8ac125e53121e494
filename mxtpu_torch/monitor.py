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
list-valued one).

The device adapter (mxtpu :52-80): with the default abs-mean statistic
and a fused step, ``Module.install_monitor`` calls ``bind_adapter``;
the fused step's training walk then reduces each matching output of a
sampled batch to its f32 abs-mean on the device (``Executor``'s tap
hook), the taps ride the health session's cadence transfer inside
``fit`` (``_deliver_taps``), or one ``.cpu()`` of them all at ``toc``
outside it (``_pull_adapter_taps``). The sampled batch keeps the fused
step and pays no per-tensor host copy. A custom ``stat_func`` keeps the
per-op path.
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
        # default-stat monitors may ride the device taps (the tap is
        # exactly the default stat: f32 abs-mean)
        self._default_stat = stat_func is None
        self._adapter = None   # the Module when riding device taps
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

    def bind_adapter(self, module):
        """Enter adapter mode: stats come from the module's fused-step
        device taps (``Module.install_monitor`` decides eligibility)."""
        self._adapter = module

    def _deliver_taps(self, host_taps):
        """Cadence delivery from the health session: the sampled batch's
        tap scalars, already on the host (they rode the metric-sync
        transfer). Ignored when the batch was not sampled."""
        if not self.activated or not host_taps:
            return
        for name in sorted(host_taps):
            self.queue.append((self.step, name, float(host_taps[name])))

    def _pull_adapter_taps(self):
        """Adapter ``toc`` outside a fit loop: the latest step's taps in
        one transfer (the per-op path pays one a tensor)."""
        fused = getattr(self._adapter, "_fused", None)
        h = getattr(fused, "last_health", None)
        taps = h.get("taps") if isinstance(h, dict) else None
        if not taps:
            return
        from .obs.health import tree_to_host
        host = tree_to_host(taps)
        for name in sorted(host):
            self.queue.append((self.step, name, float(host[name])))

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
            if self._adapter is not None and not self.queue:
                self._pull_adapter_taps()
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
