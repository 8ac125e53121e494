"""Gluon Trainer on one context.

Counterpart of ``mxtpu/gluon/trainer.py``: ``rescale_grad = scale /
batch_size`` at each ``step`` (:95), then, with one context and no
KVStore (``model.py:31``, what mxtpu's single-context Trainer takes), the
fused sweep (:122-172): every parameter's update rule of
``module/fused.py`` ``_RULES`` in one pass, in place under ``no_grad``,
so each Parameter stays the same autograd leaf (mxtpu rebinds its
buffers instead, :164). An optimizer without a rule takes the
per-parameter Updater. The Updater
holds a view of the sweep's state, so ``save_states``/``load_states``
read and write one format on either path. Several contexts, or a KVStore
kind that needs one (``dist_*``, a KVStore object), need the KVStore
over NCCL (ROADMAP A.4) and raise.
"""
from __future__ import annotations

import torch

from .. import optimizer as opt
from ..base import MXNetError
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
        if kvstore is not None and (not isinstance(kvstore, str)
                                    or "dist" in kvstore):
            raise MXNetError(
                "Trainer(kvstore=%r) needs the KVStore over NCCL (ROADMAP "
                "A.4), not ported yet; one context needs no KVStore"
                % (kvstore,))
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._check_contexts()
        self._init_optimizer(optimizer, optimizer_params)
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
        if contexts and len(contexts) > 1:
            raise MXNetError("Trainer over %d contexts needs the KVStore "
                             "over NCCL (ROADMAP A.4), not ported yet"
                             % len(contexts))

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
        self._updaters = [opt.get_updater(self._optimizer)]

    @property
    def learning_rate(self):
        return self._optimizer.lr

    def set_learning_rate(self, lr):
        self._optimizer.lr = lr

    def step(self, batch_size, ignore_stale_grad=False):
        """One update of every trainable Parameter from its gradient
        buffer, the gradient scaled by ``rescale_grad / batch_size``."""
        del ignore_stale_grad
        self._optimizer.rescale_grad = self._scale / batch_size
        if self._fused_sweep_ok():
            self._fused_sweep()
            return
        upd = self._updaters[0]
        for i, param in enumerate(self._params):
            upd(i, param.grad(), param.data())

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
                w = param.data()._data
                st = self._state(i, w)
                o._update_count(i)
                lr = o._get_lr(i)
                if lr_scale is not None:
                    lr *= lr_scale(o._index_update_count[i])
                apply(w, param.grad()._data, st, lr, o._get_wd(i))

    def save_states(self, fname):
        with open(fname, "wb") as fout:
            fout.write(self._updaters[0].get_states())

    def load_states(self, fname):
        with open(fname, "rb") as f:
            states = f.read()
        upd = self._updaters[0]
        upd.set_states(states)
        upd.optimizer = self._optimizer
        with torch.no_grad():
            for i, st in self._fused_state.items():
                if upd.states.get(i) is not None:
                    _fused._copy_state(st, upd.states[i], i)
                upd.states[i] = _as_ndarrays(st)
