"""Legacy executor-manager API (parity: python/mxnet/executor_manager.py —
the pre-Module data-parallel helper FeedForward used: split a batch across
devices by work load, run one executor per slice).

The port's own copy of ``mxtpu/executor_manager.py`` (which uses no
JAX): the modern path is ``module/executor_group.py``
(``DataParallelExecutorGroup``); this module keeps the reference's public
helpers for code that imports them directly.
"""
from __future__ import annotations

from .base import MXNetError

__all__ = ["DataParallelExecutorManager"]


def _split_input_slice(batch_size, work_load_list):
    """Slice a batch across devices proportionally to ``work_load_list``
    (parity executor_manager.py:31); the last device takes the rest."""
    total = sum(work_load_list)
    if batch_size < len(work_load_list):
        raise MXNetError("batch size cannot be smaller than the device count")
    slices = []
    start = 0
    for i, load in enumerate(work_load_list):
        if i == len(work_load_list) - 1:
            end = batch_size
        else:
            end = start + int(round(batch_size * load / total))
        slices.append(slice(start, end))
        start = end
    return slices


def _check_arguments(symbol):
    """Duplicate-name check (parity executor_manager.py _check_arguments);
    returns the argument and aux-state names."""
    names = symbol.list_arguments()
    dups = {n for n in names if names.count(n) > 1}
    if dups:
        raise MXNetError("duplicate arguments: %s" % sorted(dups))
    aux = symbol.list_auxiliary_states()
    dups = {n for n in aux if aux.count(n) > 1}
    if dups:
        raise MXNetError("duplicate aux states: %s" % sorted(dups))
    return names, aux


class DataParallelExecutorManager:
    """Thin legacy facade over DataParallelExecutorGroup (parity
    executor_manager.py:295 — load data/labels per slice, forward,
    backward, update_metric)."""

    def __init__(self, symbol, ctx, train_data, arg_names=None,
                 param_names=None, aux_names=None, work_load_list=None,
                 logger=None, sym_gen=None):
        del logger, sym_gen
        from .module.executor_group import DataParallelExecutorGroup

        self._ctx = list(ctx)
        if work_load_list is None:
            work_load_list = [1] * len(self._ctx)
        self.slices = _split_input_slice(train_data.batch_size,
                                         work_load_list)
        _check_arguments(symbol)
        input_names = [d[0] for d in train_data.provide_data] + \
            [l[0] for l in train_data.provide_label]
        self._group = DataParallelExecutorGroup(
            symbol, self._ctx, work_load_list,
            train_data.provide_data, train_data.provide_label,
            param_names or [n for n in symbol.list_arguments()
                            if n not in input_names],
            for_training=True, inputs_need_grad=False)

    @property
    def param_names(self):
        return self._group.param_names

    def set_params(self, arg_params, aux_params):
        self._group.set_params(arg_params, aux_params)

    def install_monitor(self, monitor):
        self._group.install_monitor(monitor)

    def load_data_batch(self, data_batch):
        self._batch = data_batch

    def forward(self, is_train=False):
        self._group.forward(self._batch, is_train=is_train)

    def backward(self):
        self._group.backward()

    def update_metric(self, metric, labels):
        self._group.update_metric(metric, labels)

    @property
    def param_arrays(self):
        return self._group.param_arrays

    @property
    def grad_arrays(self):
        return self._group.grad_arrays

    @property
    def aux_arrays(self):
        return self._group.aux_arrays
