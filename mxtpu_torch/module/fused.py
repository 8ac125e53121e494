"""The fused update rules of Module's train step.

Counterpart of ``mxtpu/module/fused.py``: the update rules ``_rule_sgd``,
``_rule_nag``, ``_rule_adam``, ``_rule_rmsprop``, ``_rule_adagrad``
(:64-165) and ``FusedTrainStep``, without its sharding, health taps,
rematerialization or update groups. The JAX package traces forward,
backward and the update of every parameter into one donated XLA program
(``step`` :634-718, :794-864). Eagerly there is no program to fuse them
into: the forward and backward are the executor's, and what is left here
is the update, every parameter's rule in one call with f32 state. Over
several contexts the step first sums the replicas' gradients with one
collective, then updates every replica from that sum. The
rules call the optimizer's update functions, so they round as the
Updater does. Per-parameter lr and wd come from the optimizer's own
``_get_lr``/``_get_wd`` each step, with Adam's bias correction folded
into lr as its ``update`` folds it.
"""
from __future__ import annotations

import torch

from .. import optimizer as opt
from ..base import MXNetError
from ..ops.collective import sum_replicas

__all__ = ["FusedTrainStep", "supports"]


def _f32_zeros(w):
    return torch.zeros(w.shape, dtype=torch.float32, device=w.device)


def _rule_sgd(o):
    mom = float(getattr(o, "momentum", 0.0) or 0.0)
    clip = o.clip_gradient or -1.0

    def init(w):
        return _f32_zeros(w) if mom else None

    def apply(p, g, s, lr, wd):
        if mom:
            opt.sgd_mom_update_(p, g, s, lr, wd, o.rescale_grad, clip, mom)
        else:
            opt.sgd_update_(p, g, lr, wd, o.rescale_grad, clip)

    return init, apply, None


def _rule_nag(o):
    mom = float(getattr(o, "momentum", 0.0) or 0.0)

    def init(w):
        return _f32_zeros(w) if mom else None

    def apply(p, g, s, lr, wd):
        opt.nag_update_(p, g, s, lr, wd, o.rescale_grad, o.clip_gradient,
                        mom)

    return init, apply, None


def _rule_adam(o):
    clip = o.clip_gradient or -1.0

    def init(w):
        return (_f32_zeros(w), _f32_zeros(w))

    def apply(p, g, s, lr, wd):
        opt.adam_update_(p, g, s[0], s[1], lr, wd, o.rescale_grad, clip,
                         o.beta1, o.beta2, o.epsilon)

    return init, apply, o.lr_scale


def _rule_rmsprop(o):
    clip = o.clip_gradient or -1.0
    clip_w = getattr(o, "clip_weights", None) or -1.0
    centered = bool(getattr(o, "centered", False))

    def init(w):
        return tuple(_f32_zeros(w) for _ in range(3 if centered else 1))

    def apply(p, g, s, lr, wd):
        if centered:
            opt.rmspropalex_update_(p, g, *s, lr, wd, o.rescale_grad, clip,
                                    o.gamma1, o.gamma2, o.epsilon, clip_w)
        else:
            opt.rmsprop_update_(p, g, s[0], lr, wd, o.rescale_grad, clip,
                                o.gamma1, o.epsilon, clip_w)

    return init, apply, None


def _rule_adagrad(o):
    def init(w):
        return _f32_zeros(w)

    def apply(p, g, s, lr, wd):
        opt.adagrad_update_(p, g, s, lr, wd, o.rescale_grad,
                            o.clip_gradient, o.float_stable_eps)

    return init, apply, None


_RULES = {"SGD": _rule_sgd, "NAG": _rule_nag, "Adam": _rule_adam,
          "RMSProp": _rule_rmsprop, "AdaGrad": _rule_adagrad}


def supports(optimizer):
    """Whether a fused-step update rule exists for this optimizer."""
    return type(optimizer).__name__ in _RULES


class FusedTrainStep:
    """The optimizer update of every trainable parameter in one call, by
    the rules above, over the arrays of one bound executor per replica.

    ``executors`` have run a training forward and backward; ``update``
    sums each replica's gradients (views into one flat buffer per dtype,
    ``flat_grads``) with one collective (``sum_replicas``), then applies
    each trainable parameter's rule on every replica, in place under
    ``no_grad``, from that same sum, so the replicas stay bit-identical:
    mxtpu's replicated update under GSPMD. The trainable parameters are
    those of ``param_names`` that the executors give a gradient
    (grad_req not "null"). ``opt_state[r]`` holds replica r's f32 rule
    state in the structure of the optimizer's ``create_state``. The
    parameter and gradient tensors are held, so a reshaped executor that
    keeps its arrays (``Module.reshape``) is updated by the same step."""

    def __init__(self, executors, param_names, optimizer, flat_grads=None):
        if not isinstance(executors, (list, tuple)):
            executors = [executors]
        ex0 = executors[0]
        self.trainable = [n for n in param_names
                          if ex0.grad_req.get(n, "null") != "null"
                          and n in ex0.grad_dict]
        self.params = [{n: ex.arg_dict[n]._data for n in self.trainable}
                       for ex in executors]
        self.grads = [{n: ex.grad_dict[n]._data for n in self.trainable}
                      for ex in executors]
        self._flats = [list((f or {}).values())
                       for f in (flat_grads or [None] * len(executors))]
        if len(executors) > 1 and not all(self._flats):
            raise MXNetError("a fused step over replicas needs each "
                             "replica's gradients in flat buffers")
        self.optimizer = optimizer
        init, self._apply, self._lr_scale = \
            _RULES[type(optimizer).__name__](optimizer)
        self.opt_state = [{n: init(p[n]) for n in self.trainable}
                          for p in self.params]
        # the optimizer's index scheme (Module's idx2name), fresh indices
        # for names it has not seen
        name2idx = {}
        for idx in sorted(optimizer.idx2name):
            name2idx.setdefault(optimizer.idx2name[idx], idx)
        nxt = max(optimizer.idx2name, default=-1) + 1
        for n in self.trainable:
            if n not in name2idx:
                optimizer.idx2name[nxt] = n
                name2idx[n] = nxt
                nxt += 1
        self._name_idx = [name2idx[n] for n in self.trainable]

    def export_opt_state(self):
        """The optimizer state as ``{index: numpy state}`` under the
        optimizer's index scheme (``idx2name``), the Updater's, so a
        state file written by either path loads on the other; every
        index that names a parameter gets its state
        (mxtpu/module/fused.py:930). The replicas' states are identical;
        the first one's is written."""
        host = {n: opt.states_to_numpy(self.opt_state[0][n])
                for n in self.trainable}
        return {idx: host[n] for idx, n in self.optimizer.idx2name.items()
                if n in host}

    def import_opt_state(self, states):
        """Copy ``{index: state}`` (numpy, as ``export_opt_state`` gives
        it) into every replica's live state tensors in place; for a
        parameter named by several indices the lowest present wins
        (:949)."""
        idx2name = self.optimizer.idx2name
        with torch.no_grad():
            for n in self.trainable:
                found = [states[j] for j in sorted(states)
                         if idx2name.get(j) == n and states[j] is not None]
                if found:
                    for st in self.opt_state:
                        _copy_state(st[n], found[0], n)

    def update(self):
        """Sum the replicas' gradients, then apply one update to every
        trainable parameter of every replica."""
        o = self.optimizer
        with torch.no_grad():
            if len(self.params) > 1:
                for bufs in zip(*self._flats):
                    sum_replicas(list(bufs))
            for n, idx in zip(self.trainable, self._name_idx):
                o._update_count(idx)
                lr = o._get_lr(idx)
                if self._lr_scale is not None:
                    lr *= self._lr_scale(o._index_update_count[idx])
                wd = o._get_wd(idx)
                for p, g, st in zip(self.params, self.grads, self.opt_state):
                    self._apply(p[n], g[n], st[n], lr, wd)


def _copy_state(dst, src, name):
    if isinstance(dst, tuple):
        if not isinstance(src, tuple) or len(src) != len(dst):
            raise MXNetError("optimizer state of %s: expected %d arrays"
                             % (name, len(dst)))
        for d, s_ in zip(dst, src):
            _copy_state(d, s_, name)
        return
    if dst is None:
        return
    dst.copy_(torch.as_tensor(getattr(src, "_data", src)).reshape(
        dst.shape))
