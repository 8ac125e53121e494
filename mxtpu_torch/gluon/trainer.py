"""Gluon Trainer over one context or several.

Counterpart of ``mxtpu/gluon/trainer.py:12-110``: ``rescale_grad =
scale / batch_size`` at each ``step`` (:95), the KVStore made at the
first step through ``model._create_kvstore`` (``kvstore="device"`` by
default; none for one context unless ``dist``), with each parameter
initialized in it (and pulled, when the store updates). Over several
contexts ``step`` pushes each parameter's ``list_grad()`` (summed on the
first context) and pulls into ``list_data()`` (the optimizer runs on the
store) or into ``list_grad()`` (then one Updater per context updates its
copy). With one context and no KVStore the fused sweep runs (:122-172):
every parameter's update rule of ``module/fused.py`` ``_RULES`` in one
pass, in place under ``no_grad``, so each Parameter stays the same
autograd leaf (mxtpu rebinds its buffers instead, :164). An optimizer
without a rule takes the per-parameter Updater. The first Updater holds
a view of the sweep's state, so ``save_states``/``load_states`` read and
write one format on either path; they go through the KVStore when it
updates.
"""
from __future__ import annotations

import torch

from .. import optimizer as opt
from ..base import MXNetError
from ..model import _create_kvstore
from ..module import fused as _fused
from ..ndarray import NDArray
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


def _as_ndarrays(state):
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_as_ndarrays(s) for s in state)
    return NDArray(state)


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device"):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError(
                "First argument must be a list or dict of Parameters, "
                "got %s." % (type(params)))
        self._params = []
        for param in params:
            if not isinstance(param, Parameter):
                raise ValueError(
                    "First argument must be a list or dict of Parameters, "
                    "got list of %s." % (type(param)))
            if param.grad_req != "null":
                self._params.append(param)
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._contexts = self._check_contexts()
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore = kvstore
        self._kv_initialized = False
        self._kvstore_obj = None
        self._update_on_kvstore = False
        self._fused_rule = None
        self._fused_state = {}

    def _check_contexts(self):
        contexts = None
        for param in self._params:
            ctx = param.list_ctx()
            if contexts is not None and contexts != ctx:
                raise MXNetError("All Parameters must be initialized on "
                                 "the same set of contexts")
            contexts = ctx
        return contexts or []

    def _init_optimizer(self, optimizer, optimizer_params):
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise MXNetError("optimizer_params must be None if "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
        else:
            self._optimizer = opt.create(
                optimizer, param_idx2name={i: p.name for i, p in
                                           enumerate(self._params)},
                **optimizer_params)
        self._updaters = [opt.get_updater(self._optimizer)
                          for _ in self._contexts or [None]]

    def _init_kvstore(self):
        arg_arrays = {p.name: p.list_data()[0] for p in self._params}
        kv, self._update_on_kvstore = _create_kvstore(
            self._kvstore, len(self._contexts), arg_arrays)
        self._kvstore_obj = kv
        if kv is not None:
            for i, param in enumerate(self._params):
                kv.init(i, param.list_data()[0])
                if self._update_on_kvstore:
                    kv.pull(i, param.list_data(), priority=-i)
            if self._update_on_kvstore:
                kv.set_optimizer(self._optimizer)
        self._kv_initialized = True

    @property
    def learning_rate(self):
        return self._optimizer.lr

    def set_learning_rate(self, lr):
        self._optimizer.lr = lr

    def step(self, batch_size, ignore_stale_grad=False):
        """One update of every trainable Parameter from its gradients,
        scaled by ``rescale_grad / batch_size``: through the KVStore over
        several contexts, by the fused sweep on one."""
        del ignore_stale_grad
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        kv = self._kvstore_obj
        if kv is None and len(self._contexts) == 1 and \
                self._fused_sweep_ok():
            self._fused_sweep()
            return
        for i, param in enumerate(self._params):
            if kv is not None:
                kv.push(i, param.list_grad(), priority=-i)
                if self._update_on_kvstore:
                    kv.pull(i, param.list_data(), priority=-i)
                    continue
                kv.pull(i, param.list_grad(), priority=-i)
            for upd, arr, grad in zip(self._updaters, param.list_data(),
                                      param.list_grad()):
                upd(i, grad, arr)

    # ------------------------------------------------ fused update sweep
    def _fused_sweep_ok(self):
        return _fused.supports(self._optimizer)

    def _state(self, i, weight):
        """The sweep's f32 state of parameter ``i``, made at its first
        step: from the Updater's state where one was loaded or kept, else
        zeros; the Updater then holds a view of it."""
        if i not in self._fused_state:
            st = self._fused_state[i] = self._fused_rule[0](weight)
            held = self._updaters[0].states.get(i)
            if held is not None:
                _fused._copy_state(st, held, i)
            self._updaters[0].states[i] = _as_ndarrays(st)
        return self._fused_state[i]

    def _fused_sweep(self):
        o = self._optimizer
        if self._fused_rule is None:
            init, apply, lr_scale = _fused._RULES[type(o).__name__](o)
            self._fused_rule = (init, apply, lr_scale)
        _, apply, lr_scale = self._fused_rule
        with torch.no_grad():
            for i, param in enumerate(self._params):
                w = param.list_data()[0]._data
                st = self._state(i, w)
                o._update_count(i)
                lr = o._get_lr(i)
                if lr_scale is not None:
                    lr *= lr_scale(o._index_update_count[i])
                apply(w, param.list_grad()[0]._data, st, lr, o._get_wd(i))

    def save_states(self, fname):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore_obj.save_optimizer_states(fname)
            return
        with open(fname, "wb") as fout:
            fout.write(self._updaters[0].get_states())

    def load_states(self, fname):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore_obj.load_optimizer_states(fname)
            return
        with open(fname, "rb") as f:
            states = f.read()
        for upd in self._updaters:
            upd.set_states(states)
            upd.optimizer = self._optimizer
        upd = self._updaters[0]
        with torch.no_grad():
            for i, st in self._fused_state.items():
                if upd.states.get(i) is not None:
                    _fused._copy_state(st, upd.states[i], i)
                upd.states[i] = _as_ndarrays(st)
