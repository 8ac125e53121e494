"""Optimizers and the Updater (parity: python/mxnet/optimizer.py).

Counterpart of ``mxtpu/optimizer.py:20-265, 430-467``: ``Optimizer``
(lr/wd multipliers from ``__lr_mult__``/``__wd_mult__`` attributes, per
index update counts, ``rescale_grad``, ``clip_gradient``, an optional
lr scheduler), ``SGD``, ``NAG``, ``Adam``, ``RMSProp``, ``AdaGrad``,
``create``/``register`` and the per-index ``Updater`` of the unfused
path. The update arithmetic is the plain torch functions below, the
counterparts of ``mxtpu/ops/optimizer_ops.py`` written as in-place
updates of the weight and state tensors (under ``no_grad``, never
recorded by autograd); the fused update (``module/fused.py``) calls the
same functions, so it rounds as the Updater does.
"""
from __future__ import annotations

import math
import pickle

import numpy as np
import torch

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "RMSProp", "AdaGrad",
           "register", "create", "Updater", "get_updater"]

_REG = {}


# ---------------------------------------------------------------- update math
def _prep(grad, weight, rescale, clip, wd):
    g = grad * rescale
    if clip and clip > 0:
        g = torch.clamp(g, -clip, clip)
    return g + wd * weight


@torch.no_grad()
def sgd_update_(w, g, lr, wd, rescale, clip):
    w.sub_(lr * _prep(g, w, rescale, clip, wd))


@torch.no_grad()
def sgd_mom_update_(w, g, mom, lr, wd, rescale, clip, momentum):
    mom.copy_(momentum * mom - lr * _prep(g, w, rescale, clip, wd))
    w.add_(mom)


@torch.no_grad()
def nag_update_(w, g, mom, lr, wd, rescale, clip, momentum):
    g = g * rescale
    if clip:
        g = torch.clamp(g, -clip, clip)
    if mom is None:
        w.sub_(lr * (g + wd * w))
        return
    gw = g + wd * w
    mom.copy_(momentum * mom + gw)
    w.sub_(lr * (gw + momentum * mom))


@torch.no_grad()
def adam_update_(w, g, mean, var, lr, wd, rescale, clip, beta1, beta2,
                 epsilon):
    g = _prep(g, w, rescale, clip, wd)
    mean.copy_(beta1 * mean + (1 - beta1) * g)
    var.copy_(beta2 * var + (1 - beta2) * torch.square(g))
    w.sub_(lr * mean / (torch.sqrt(var) + epsilon))


@torch.no_grad()
def rmsprop_update_(w, g, n, lr, wd, rescale, clip, gamma1, epsilon,
                    clip_weights):
    g = _prep(g, w, rescale, clip, wd)
    n.copy_((1 - gamma1) * torch.square(g) + gamma1 * n)
    w.sub_(lr * g / torch.sqrt(n + epsilon))
    if clip_weights and clip_weights > 0:
        w.clamp_(-clip_weights, clip_weights)


@torch.no_grad()
def rmspropalex_update_(w, g, n, g_avg, delta, lr, wd, rescale, clip,
                        gamma1, gamma2, epsilon, clip_weights):
    g = _prep(g, w, rescale, clip, wd)
    n.copy_((1 - gamma1) * torch.square(g) + gamma1 * n)
    g_avg.copy_((1 - gamma1) * g + gamma1 * g_avg)
    delta.copy_(gamma2 * delta - lr * g / torch.sqrt(
        n - torch.square(g_avg) + epsilon))
    w.add_(delta)
    if clip_weights and clip_weights > 0:
        w.clamp_(-clip_weights, clip_weights)


@torch.no_grad()
def adagrad_update_(w, g, hist, lr, wd, rescale, clip, eps):
    # the history accumulates the rescaled/clipped gradient; weight decay
    # applies outside the preconditioner
    g = g * rescale
    if clip:
        g = torch.clamp(g, -clip, clip)
    hist.add_(torch.square(g))
    w.sub_(lr * (g / torch.sqrt(hist + eps) + wd * w))


# ---------------------------------------------------------------- optimizers
def _zeros_like(weight):
    """f32 state for a weight (an NDArray): master-precision moments."""
    return NDArray(torch.zeros(weight.shape, dtype=torch.float32,
                               device=weight._data.device), weight.context)


def _raw(x):
    return None if x is None else x._data


class Optimizer:
    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, param_dict=None, **kwargs):
        if kwargs:
            raise MXNetError("optimizer %s: unknown arguments %s"
                             % (type(self).__name__, sorted(kwargs)))
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.idx2name = dict(param_idx2name or {})
        self.sym = sym
        if sym is not None:
            attrs = sym.attr_dict()
            for name in sym.list_arguments():
                if name in attrs:
                    if "__lr_mult__" in attrs[name]:
                        self.lr_mult[name] = float(attrs[name]["__lr_mult__"])
                    if "__wd_mult__" in attrs[name]:
                        self.wd_mult[name] = float(attrs[name]["__wd_mult__"])

    @staticmethod
    def register(klass):
        _REG[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        klass = _REG.get(str(name).lower())
        if klass is None:
            raise MXNetError("unknown optimizer %r (have %s)"
                             % (name, sorted(_REG)))
        return klass(**kwargs)

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        if index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def _clip(self):
        return self.clip_gradient or -1.0


register = Optimizer.register
create = Optimizer.create_optimizer


@register
class SGD(Optimizer):
    """SGD with optional momentum (parity optimizer.py:368)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros_like(weight) if self.momentum != 0.0 else None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if state is None:
            sgd_update_(weight._data, grad._data, lr, wd, self.rescale_grad,
                        self._clip())
        else:
            sgd_mom_update_(weight._data, grad._data, state._data, lr, wd,
                            self.rescale_grad, self._clip(), self.momentum)


@register
class NAG(Optimizer):
    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros_like(weight) if self.momentum != 0.0 else None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        nag_update_(weight._data, grad._data, _raw(state),
                    self._get_lr(index), self._get_wd(index),
                    self.rescale_grad, self.clip_gradient, self.momentum)


@register
class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def lr_scale(self, t):
        """Bias correction folded into the learning rate at update t."""
        return math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        lr *= self.lr_scale(self._index_update_count[index])
        adam_update_(weight._data, grad._data, state[0]._data,
                     state[1]._data, lr, wd, self.rescale_grad, self._clip(),
                     self.beta1, self.beta2, self.epsilon)


@register
class AdaGrad(Optimizer):
    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        adagrad_update_(weight._data, grad._data, state._data,
                        self._get_lr(index), self._get_wd(index),
                        self.rescale_grad, self.clip_gradient,
                        self.float_stable_eps)


@register
class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        n = 3 if self.centered else 1
        return tuple(_zeros_like(weight) for _ in range(n))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        clip_w = self.clip_weights or -1.0
        if self.centered:
            rmspropalex_update_(weight._data, grad._data, *map(_raw, state),
                                lr, wd, self.rescale_grad, self._clip(),
                                self.gamma1, self.gamma2, self.epsilon,
                                clip_w)
        else:
            rmsprop_update_(weight._data, grad._data, state[0]._data, lr, wd,
                            self.rescale_grad, self._clip(), self.gamma1,
                            self.epsilon, clip_w)


def states_to_numpy(state):
    """An optimizer state (None, a tensor or NDArray, or a tuple of them)
    as numpy arrays in the same structure: what a ``.states`` file
    pickles."""
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(states_to_numpy(s) for s in state)
    return getattr(state, "_data", state).detach().cpu().numpy()


class Updater:
    """Applies an optimizer per key (parity optimizer.py:1019
    get_updater); ``states`` holds each index's optimizer state.
    ``get_states``/``set_states`` carry them as a pickle of
    ``{index: numpy state}``, mxtpu's layout (mxtpu/optimizer.py:442-
    461); set states reach the weight's device at their first use."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        elif _is_host_state(self.states[index]):
            self.states[index] = _placed(self.states[index], weight)
        self.optimizer.update(index, weight, grad, self.states[index])

    def get_states(self):
        return pickle.dumps({k: states_to_numpy(v)
                             for k, v in self.states.items()})

    def set_states(self, states):
        self.states = dict(pickle.loads(states)
                           if isinstance(states, bytes) else states)


def _is_host_state(state):
    if isinstance(state, tuple):
        return any(_is_host_state(s) for s in state)
    return isinstance(state, np.ndarray)


def _placed(state, weight):
    """A numpy state as NDArrays on ``weight``'s device."""
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_placed(s, weight) for s in state)
    return NDArray(torch.from_numpy(np.ascontiguousarray(state)).to(
        weight._data.device), weight.context)


def get_updater(optimizer):
    return Updater(optimizer)
