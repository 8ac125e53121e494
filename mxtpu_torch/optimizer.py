"""Optimizers and the Updater (parity: python/mxnet/optimizer.py).

Counterpart of ``mxtpu/optimizer.py``: ``Optimizer`` (lr/wd
multipliers from ``__lr_mult__``/``__wd_mult__`` attributes, per index
update counts, ``rescale_grad``, ``clip_gradient``, an optional lr
scheduler), ``SGD`` (with ``multi_precision``: float16 weights updated
through float32 master copies), ``NAG``, ``Adam``, ``RMSProp``,
``AdaGrad``, ``AdaDelta``, ``Adamax``, ``Nadam``, ``Ftrl``, ``SGLD``,
``DCASGD``, ``Test`` and ``ccSGD``, ``create``/``register`` and the
per-index ``Updater`` of the unfused path. Only SGD, NAG, Adam, RMSProp
and AdaGrad have fused-step rules (``module/fused.py``); the others, and
multi-precision SGD, update through the Updater, as in mxtpu. The
update arithmetic is the plain torch functions below, the counterparts
of ``mxtpu/ops/optimizer_ops.py`` written as in-place
updates of the weight and state tensors (under ``no_grad``, never
recorded by autograd); the fused update (``module/fused.py``) calls the
same functions, so it rounds as the Updater does.
"""
from __future__ import annotations

import math
import pickle

import numpy as np
import torch

from . import random as _random
from .base import MXNetError
from .ndarray import NDArray

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "RMSProp", "AdaGrad",
           "AdaDelta", "Adamax", "Nadam", "Ftrl", "SGLD", "DCASGD", "Test",
           "ccSGD", "register", "create", "Updater", "get_updater"]

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
def mp_sgd_update_(w, g, w32, lr, wd, rescale, clip):
    """SGD on a low-precision weight through its float32 master copy
    ``w32`` (mxtpu's ``mp_sgd_update``): the f32 copy takes the step and
    the weight gets it rounded."""
    w32.sub_(lr * _prep(g.to(torch.float32), w32, rescale, clip, wd))
    w.copy_(w32)


@torch.no_grad()
def mp_sgd_mom_update_(w, g, mom, w32, lr, wd, rescale, clip, momentum):
    """``mp_sgd_update_`` with an f32 momentum (``mp_sgd_mom_update``)."""
    mom.copy_(momentum * mom - lr * _prep(g.to(torch.float32), w32, rescale,
                                          clip, wd))
    w32.add_(mom)
    w.copy_(w32)


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


def _rescaled(g, rescale, clip):
    """The gradient rescaled, then clipped when ``clip`` is set."""
    g = g * rescale
    return torch.clamp(g, -clip, clip) if clip else g


@torch.no_grad()
def adadelta_update_(w, g, acc_g, acc_delta, wd, rescale, clip, rho,
                     epsilon):
    g = _rescaled(g, rescale, clip)
    acc_g.copy_(rho * acc_g + (1 - rho) * g ** 2)
    delta = torch.sqrt(acc_delta + epsilon) / torch.sqrt(acc_g + epsilon) \
        * g
    acc_delta.copy_(rho * acc_delta + (1 - rho) * delta ** 2)
    w.copy_(w - delta - wd * w)


@torch.no_grad()
def adamax_update_(w, g, m, u, lr, wd, rescale, clip, beta1, beta2):
    g = _rescaled(g, rescale, clip) + wd * w
    m.copy_(beta1 * m + (1.0 - beta1) * g)
    u.copy_(torch.maximum(beta2 * u, torch.abs(g)))
    w.sub_(lr * m / (u + 1e-8))


@torch.no_grad()
def nadam_update_(w, g, m, v, lr, wd, rescale, clip, beta1, beta2, epsilon,
                  t, momentum_t, momentum_t_1, m_schedule, m_schedule_next):
    g = _rescaled(g, rescale, clip) + wd * w
    m.copy_(beta1 * m + (1.0 - beta1) * g)
    v.copy_(beta2 * v + (1.0 - beta2) * g * g)
    g_prime = g / (1.0 - m_schedule)
    m_prime = m / (1.0 - m_schedule_next)
    v_prime = v / (1.0 - beta2 ** t)
    m_bar = (1.0 - momentum_t) * g_prime + momentum_t_1 * m_prime
    w.sub_(lr * m_bar / (torch.sqrt(v_prime) + epsilon))


@torch.no_grad()
def ftrl_update_(w, g, z, n, lr, wd, rescale, clip, lamda1, beta):
    g = _rescaled(g, rescale, clip)
    new_n = n + torch.square(g)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    z.add_(g - sigma * w)
    n.copy_(new_n)
    w.copy_(torch.where(torch.abs(z) <= lamda1, torch.zeros_like(w),
                        -(z - torch.sign(z) * lamda1)
                        / ((beta + torch.sqrt(new_n)) / lr + wd)))


@torch.no_grad()
def sgld_update_(w, g, lr, wd, rescale, clip, generator):
    """Langevin dynamics: half an SGD step plus N(0, lr) noise drawn from
    ``generator`` on the weight's device."""
    g = _rescaled(g, rescale, clip)
    noise = torch.randn(w.shape, generator=generator, dtype=w.dtype,
                        device=w.device) * math.sqrt(lr)
    w.copy_(w - (lr / 2) * (g + wd * w) + noise)


@torch.no_grad()
def dcasgd_update_(w, g, mom, prev, lr, wd, rescale, clip, momentum, lamda):
    """Delay-compensated SGD: the gradient corrected by ``lamda·g²·(w -
    prev)``, ``prev`` the weight after the last update."""
    g = _rescaled(g, rescale, clip)
    comp = g + wd * w + lamda * g * g * (w - prev)
    if mom is not None:
        mom.copy_(momentum * mom - lr * comp)
        w.add_(mom)
    else:
        w.sub_(lr * comp)
    prev.copy_(w)


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
    """SGD with optional momentum (parity optimizer.py:368). With
    ``multi_precision`` a float16 weight keeps a float32 master copy and
    f32 momentum in its state, ``(momentum or None, master)``."""

    def __init__(self, momentum=0.0, multi_precision=False, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.multi_precision = multi_precision

    def create_state(self, index, weight):
        mom = _zeros_like(weight) if self.momentum != 0.0 else None
        if self.multi_precision and weight.dtype == np.float16:
            return (mom, weight.astype("float32"))
        return mom

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if isinstance(state, tuple):
            mom, w32 = state
            if mom is not None:
                mp_sgd_mom_update_(weight._data, grad._data, mom._data,
                                   w32._data, lr, wd, self.rescale_grad,
                                   self._clip(), self.momentum)
            else:
                mp_sgd_update_(weight._data, grad._data, w32._data, lr, wd,
                               self.rescale_grad, self._clip())
        elif state is None:
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


@register
class AdaDelta(Optimizer):
    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        adadelta_update_(weight._data, grad._data, *map(_raw, state),
                         self._get_wd(index), self.rescale_grad,
                         self.clip_gradient, self.rho, self.epsilon)


@register
class Adamax(Optimizer):
    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        lr /= (1.0 - self.beta1 ** self._index_update_count[index])
        adamax_update_(weight._data, grad._data, *map(_raw, state), lr, wd,
                       self.rescale_grad, self.clip_gradient, self.beta1,
                       self.beta2)


@register
class Nadam(Optimizer):
    """Adam with Nesterov momentum. ``m_schedule`` is one product on the
    optimizer, advanced by every parameter's update, as in mxtpu and the
    reference."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        momentum_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            (t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        nadam_update_(weight._data, grad._data, *map(_raw, state), lr, wd,
                      self.rescale_grad, self.clip_gradient, self.beta1,
                      self.beta2, self.epsilon, t, momentum_t, momentum_t_1,
                      self.m_schedule, self.m_schedule * momentum_t_1)


@register
class Ftrl(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        ftrl_update_(weight._data, grad._data, *map(_raw, state),
                     self._get_lr(index), self._get_wd(index),
                     self.rescale_grad, self.clip_gradient, self.lamda1,
                     self.beta)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics. The noise comes from the
    generator of the weight's device (``random.generator``)."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        sgld_update_(weight._data, grad._data, self._get_lr(index),
                     self._get_wd(index), self.rescale_grad,
                     self.clip_gradient,
                     _random.generator(weight._data.device))


@register
class DCASGD(Optimizer):
    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = _zeros_like(weight) if self.momentum != 0.0 else None
        return (mom, weight.copy())

    def update(self, index, weight, grad, state):
        self._update_count(index)
        dcasgd_update_(weight._data, grad._data, *map(_raw, state),
                       self._get_lr(index), self._get_wd(index),
                       self.rescale_grad, self.clip_gradient, self.momentum,
                       self.lamda)


@register
class Test(Optimizer):
    """Adds the rescaled gradient to the weight; the state mirrors it."""

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        with torch.no_grad():
            weight._data.add_(grad._data * self.rescale_grad)
            state._data.copy_(weight._data)


@register
class ccSGD(SGD):
    """Deprecated alias of SGD (parity optimizer.py ccSGD), so configs
    naming 'ccsgd' keep working."""


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
        weight._written()  # the rules update in place

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
