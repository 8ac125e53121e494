"""The fused optimizer update ops.

Counterpart of ``mxtpu/ops/optimizer_ops.py:26-129``: ``sgd_update``,
``sgd_mom_update``, ``mp_sgd_update``, ``mp_sgd_mom_update``,
``adam_update``, ``rmsprop_update``, ``rmspropalex_update`` and
``ftrl_update``, with mxtpu's arg names, attrs and outputs. Each returns
the new weight and then the new states, and is the port's update rule
of ``optimizer.py`` (the one the Updater and the fused step run, under
``no_grad``) applied to copies of the weight and states, so the inputs
are not changed and nothing is recorded for a gradient. As
in mxtpu, ``out=`` aliasing the weight writes the new weight into it;
the new states are outputs, written nowhere else.
"""
from __future__ import annotations

from .registry import Required, register

_COMMON = {"lr": Required(float), "wd": 0.0, "rescale_grad": 1.0,
           "clip_gradient": -1.0}


def _clip(a):
    """The clip bound the rules take: None unless ``clip_gradient`` > 0."""
    return a.clip_gradient if a.clip_gradient and a.clip_gradient > 0 \
        else None


def _run(rule, weight, grad, states, *hyper):
    """``optimizer.<rule>(w, grad, *states, *hyper)`` on detached copies
    of the weight and ``states``; returns the copies. (``optimizer`` is
    imported here: it imports ``ndarray``, which makes its ``nd.<op>``
    functions from this registry when it is first imported.)"""
    from .. import optimizer
    new = [s.detach().clone() for s in [weight] + list(states)]
    getattr(optimizer, rule)(new[0], grad.detach(), *new[1:], *hyper)
    return tuple(new) if states else new[0]


def _sgd_update(a, weight, grad):
    return _run("sgd_update_", weight, grad, [], a.lr, a.wd, a.rescale_grad,
                _clip(a))


register("sgd_update", _sgd_update, arg_names=["weight", "grad"],
         attrs=dict(_COMMON))


def _sgd_mom_update(a, weight, grad, mom):
    return _run("sgd_mom_update_", weight, grad, [mom], a.lr, a.wd,
                a.rescale_grad, _clip(a), a.momentum)


register("sgd_mom_update", _sgd_mom_update,
         arg_names=["weight", "grad", "mom"],
         attrs=dict(_COMMON, momentum=0.0), num_outputs=2)


def _mp_sgd_update(a, weight, grad, weight32):
    return _run("mp_sgd_update_", weight, grad, [weight32], a.lr, a.wd,
                a.rescale_grad, _clip(a))


register("mp_sgd_update", _mp_sgd_update,
         arg_names=["weight", "grad", "weight32"],
         attrs=dict(_COMMON), num_outputs=2)


def _mp_sgd_mom_update(a, weight, grad, mom, weight32):
    return _run("mp_sgd_mom_update_", weight, grad, [mom, weight32], a.lr,
                a.wd, a.rescale_grad, _clip(a), a.momentum)


register("mp_sgd_mom_update", _mp_sgd_mom_update,
         arg_names=["weight", "grad", "mom", "weight32"],
         attrs=dict(_COMMON, momentum=0.0), num_outputs=3)


def _adam_update(a, weight, grad, mean, var):
    return _run("adam_update_", weight, grad, [mean, var], a.lr, a.wd,
                a.rescale_grad, _clip(a), a.beta1, a.beta2, a.epsilon)


register("adam_update", _adam_update,
         arg_names=["weight", "grad", "mean", "var"],
         attrs=dict(_COMMON, beta1=0.9, beta2=0.999, epsilon=1e-8),
         num_outputs=3)


def _rmsprop_update(a, weight, grad, n):
    return _run("rmsprop_update_", weight, grad, [n], a.lr, a.wd,
                a.rescale_grad, _clip(a), a.gamma1, a.epsilon,
                a.clip_weights)


register("rmsprop_update", _rmsprop_update, arg_names=["weight", "grad", "n"],
         attrs=dict(_COMMON, gamma1=0.95, epsilon=1e-8, clip_weights=-1.0),
         num_outputs=2)


def _rmspropalex_update(a, weight, grad, n, g, delta):
    return _run("rmspropalex_update_", weight, grad, [n, g, delta], a.lr,
                a.wd, a.rescale_grad, _clip(a), a.gamma1, a.gamma2,
                a.epsilon, a.clip_weights)


register("rmspropalex_update", _rmspropalex_update,
         arg_names=["weight", "grad", "n", "g", "delta"],
         attrs=dict(_COMMON, gamma1=0.95, gamma2=0.9, epsilon=1e-8,
                    clip_weights=-1.0),
         num_outputs=4)


def _ftrl_update(a, weight, grad, z, n):
    return _run("ftrl_update_", weight, grad, [z, n], a.lr, a.wd,
                a.rescale_grad, _clip(a), a.lamda1, a.beta)


register("ftrl_update", _ftrl_update, arg_names=["weight", "grad", "z", "n"],
         attrs=dict(_COMMON, lamda1=0.01, beta=1.0), num_outputs=3)
