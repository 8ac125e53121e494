"""The fused update rules of Module's train step.

Counterpart of ``mxtpu/module/fused.py``: the update rules ``_rule_sgd``,
``_rule_nag``, ``_rule_adam``, ``_rule_rmsprop``, ``_rule_adagrad``
(:64-165) and ``FusedTrainStep`` with its cross-replica weight-update
sharding (:242-260, 620-632, 708-710, 767-787) and the state shared by
the steps of a BucketingModule's buckets (``state=``, ``adopt_state``),
without its health taps,
rematerialization or update groups. The JAX package traces forward,
backward and the update of every parameter into one donated XLA program
(``step`` :634-718, :794-864). Eagerly there is no program to fuse them
into: the forward and backward are the executor's, and what is left here
is the update, every parameter's rule in one call with f32 state. Over
several contexts the step first sums the replicas' gradients with one
collective, then updates every replica from that sum. Under a
``ShardingPlan`` the parameters whose optimizer state shards over
``data`` take the sharded route instead: one reduce-scatter of their
gradients, each replica's rule on its 1/n of their rows, one all-gather
of the updated rows. The rules call the optimizer's update functions, so
they round as the Updater does. Per-parameter lr and wd come from the
optimizer's own ``_get_lr``/``_get_wd`` each step, with Adam's bias
correction folded into lr as its ``update`` folds it.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import optimizer as opt
from ..base import MXNetError
from ..ops.collective import (all_gather_replicas, reduce_scatter_replicas,
                              sum_replicas)

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


def _rule_trainer_adam(o):
    """``parallel.dp.TrainerAdam``: its own ``step_`` (mxtpu's
    ``DataParallelTrainer`` Adam), the rule its ``update`` applies."""
    def init(w):
        return (_f32_zeros(w), _f32_zeros(w))

    def apply(p, g, s, lr, wd):
        o.step_(p, g, s[0], s[1], lr, wd)

    return init, apply, None


_RULES = {"SGD": _rule_sgd, "NAG": _rule_nag, "Adam": _rule_adam,
          "RMSProp": _rule_rmsprop, "AdaGrad": _rule_adagrad,
          "TrainerAdam": _rule_trainer_adam}


def supports(optimizer):
    """Whether a fused-step update rule exists for this optimizer."""
    return type(optimizer).__name__ in _RULES


class _Bucket:
    """The flat buffers of one dtype's parameters updated by rows, on
    every replica.

    ``stage[r]`` holds replica r's gradients laid out shard-major, an (n,
    C) matrix whose row s is the s-th row block of every parameter in
    turn, so one reduce-scatter leaves replica r the summed gradients of
    its own rows in ``grad[r]`` (C); replica r's updated rows are packed
    into ``rows_in[r]`` (C) and one all-gather gives every replica all of
    them, shard-major, in ``gathered[r]`` (n, C), copied back into the
    parameters."""

    def __init__(self, names, params, grads, n):
        self.names = names
        dev = [p[names[0]].device for p in params]
        dtype = params[0][names[0]].dtype
        sizes = [params[0][k].numel() // n for k in names]
        offs = [sum(sizes[:i]) for i in range(len(sizes))]
        total = sum(sizes)

        def empty(count, r):
            return torch.empty(count, dtype=dtype, device=dev[r])

        reps = range(len(params))
        self.grad = [empty(total, r) for r in reps]
        # each replica's views of its summed row blocks in the buffers,
        # and of its rows of each parameter, which the rules update
        self.g_views = [{k: self.grad[r][o:o + m].view(
            (params[r][k].shape[0] // n,) + tuple(params[r][k].shape[1:]))
            for k, o, m in zip(names, offs, sizes)} for r in reps]
        self.stage = [empty(n * total, r) for r in reps]
        self.pack_src = [[g[k].view(n, -1) for k in names] for g in grads]
        self.rows_in = [empty(total, r) for r in reps]
        self.gathered = [empty(n * total, r) for r in reps]
        self.p_rows = [{k: _rows(params[r][k], n, r) for k in names}
                       for r in reps]
        self.rows_src = [[self.p_rows[r][k].reshape(-1) for k in names]
                         for r in reps]
        self.back_dst = [[params[r][k].view(n, -1) for k in names]
                         for r in reps]
        self.back_src = [[self.gathered[r].view(n, total)[:, o:o + m]
                          for o, m in zip(offs, sizes)] for r in reps]

    def reduce(self):
        """Every replica's gradients into the stage, shard-major, then one
        reduce-scatter."""
        n = len(self.stage)
        for r, src in enumerate(self.pack_src):
            torch.cat(src, dim=1, out=self.stage[r].view(n, -1))
        reduce_scatter_replicas(self.stage, self.grad)

    def gather(self):
        """Each replica's updated rows to every replica, one all-gather."""
        for r, src in enumerate(self.rows_src):
            torch.cat(src, out=self.rows_in[r])
        all_gather_replicas(self.rows_in, self.gathered)
        for dst, src in zip(self.back_dst, self.back_src):
            torch._foreach_copy_(dst, src)


def _rows(p, n, r):
    """Replica r's 1/n block of rows of ``p``."""
    k = p.shape[0] // n
    return p[r * k:(r + 1) * k]


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
    keeps its arrays (``Module.reshape``) is updated by the same step.

    With ``plan`` (a ``ShardingPlan`` over the executors' devices, in
    mesh order) the trainable parameters of ``plan.sharded_opt_names()``
    are updated by rows: per dtype, one reduce-scatter of their
    gradients, replica r's rule on its r-th block of rows of each with
    state of that block's size, one all-gather of the updated rows back
    into every replica's parameters. The other parameters' gradients
    must lead each flat buffer (``DataParallelExecutorGroup(flat_tail=
    ...)``): that segment is summed in place with one all-reduce per
    dtype and its parameters updated whole, as without a plan. The
    replicas end each step with the same bits either way."""

    def __init__(self, executors, param_names, optimizer, flat_grads=None,
                 plan=None, state=None):
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
        flats = [f or {} for f in (flat_grads or [None] * len(executors))]
        if len(executors) > 1 and not all(flats):
            raise MXNetError("a fused step over replicas needs each "
                             "replica's gradients in flat buffers")
        self._plan = plan if plan is not None and len(executors) > 1 \
            else None
        self.optimizer = optimizer
        init, self._apply, self._lr_scale = \
            _RULES[type(optimizer).__name__](optimizer)
        # what each replica's rule updates: the whole parameter and its
        # summed gradient, or under the plan its block of rows
        self._targets = [dict(p) for p in self.params]
        self._sums = [dict(g) for g in self.grads]
        self._buckets = []
        # the flat segments summed in place, one list of replicas each
        self._all_reduce = []
        if len(executors) > 1:
            self._all_reduce = self._replicated_segments(flats)
        if self._plan is not None:
            self._buckets = self._make_buckets()
            for b in self._buckets:
                for r in range(len(self.params)):
                    self._sums[r].update(b.g_views[r])
                    self._targets[r].update(b.p_rows[r])
        if state is None:
            self.opt_state = [{n: init(t[n]) for n in self.trainable}
                              for t in self._targets]
        else:
            self.adopt_state(state, init)
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

    def adopt_state(self, other, init):
        """Advance ``other``'s optimizer state (the same dicts, so both
        steps update one set of moments; mxtpu's ``state=`` and
        ``adopt_state``, module/fused.py) for the parameters that both
        update, which must be the same tensors in both (a module bound
        with ``shared_module``); a parameter only this step updates gets
        fresh state, added to the shared dicts."""
        if other.optimizer is not self.optimizer or \
                len(other.params) != len(self.params):
            raise MXNetError("a fused step adopts the state of a step over "
                             "the same optimizer and replicas")
        for mine, theirs in zip(self.params, other.params):
            for n in set(mine) & set(theirs):
                if mine[n].data_ptr() != theirs[n].data_ptr():
                    raise MXNetError(
                        "adopt_state: parameter %s is not the shared "
                        "module's tensor (bind with shared_module)" % n)
        self.opt_state = other.opt_state
        for st, t in zip(self.opt_state, self._targets):
            for n in self.trainable:
                if n not in st:
                    st[n] = init(t[n])

    def _sharded(self):
        if self._plan is None:
            return set()
        return set(self._plan.sharded_opt_names()) & set(self.trainable)

    def _replicated_segments(self, flats):
        """Per dtype, every replica's view of the leading segment of its
        flat buffer that holds the gradients of the parameters updated
        whole (the whole buffer without a plan)."""
        sharded = self._sharded()
        segs = []
        for dtype in flats[0]:
            names = [k for k in self.trainable if k not in sharded
                     and self.grads[0][k].dtype == dtype]
            size = sum(self.grads[0][k].numel() for k in names)
            if not size:
                continue
            views = [f[dtype][:size] for f in flats]
            for f, g in zip(flats, self.grads):
                lo = f[dtype].data_ptr()
                hi = lo + size * f[dtype].element_size()
                if not all(lo <= g[k].data_ptr() < hi for k in names):
                    raise MXNetError(
                        "the gradients of the parameters updated whole "
                        "must lead each flat buffer (the executor group's "
                        "flat_tail)")
            segs.append(views)
        return segs

    def _make_buckets(self):
        """The buckets of the parameters updated by rows, one per dtype,
        in trainable order."""
        sharded = self._sharded()
        groups = {}
        for k in self.trainable:
            if k in sharded:
                groups.setdefault(self.params[0][k].dtype, []).append(k)
        return [_Bucket(names, self.params, self.grads, len(self.params))
                for names in groups.values()]

    @property
    def sharded_names(self):
        """The parameters updated by rows (none without a plan)."""
        return [k for b in self._buckets for k in b.names]

    def opt_state_bytes(self):
        """Each replica's optimizer-state bytes."""
        def nbytes(s):
            if s is None:
                return 0
            if isinstance(s, tuple):
                return sum(nbytes(x) for x in s)
            return s.numel() * s.element_size()
        return [sum(nbytes(s) for s in st.values()) for st in self.opt_state]

    def _full_state(self, n):
        """Parameter ``n``'s state as numpy, its replicas' row blocks
        concatenated where it is updated by rows."""
        if n not in self.sharded_names:
            return opt.states_to_numpy(self.opt_state[0][n])

        def cat(parts):
            if parts[0] is None:
                return None
            if isinstance(parts[0], tuple):
                return tuple(cat(list(p)) for p in zip(*parts))
            return np.concatenate([opt.states_to_numpy(p) for p in parts])
        return cat([st[n] for st in self.opt_state])

    def export_opt_state(self):
        """The optimizer state as ``{index: numpy state}`` under the
        optimizer's index scheme (``idx2name``), the Updater's, so a
        state file written by either path loads on the other; every
        index that names a parameter gets its state
        (mxtpu/module/fused.py:930). The replicas' states are identical,
        and the first one's is written; a state kept by rows is gathered
        from every replica into its full size."""
        host = {n: self._full_state(n) for n in self.trainable}
        return {idx: host[n] for idx, n in self.optimizer.idx2name.items()
                if n in host}

    def import_opt_state(self, states):
        """Copy ``{index: state}`` (numpy, as ``export_opt_state`` gives
        it) into every replica's live state tensors in place, each
        replica's block of rows where the state is kept by rows; for a
        parameter named by several indices the lowest present wins
        (:949)."""
        idx2name = self.optimizer.idx2name
        sharded = set(self.sharded_names)
        n_rep = len(self.opt_state)
        with torch.no_grad():
            for n in self.trainable:
                found = [states[j] for j in sorted(states)
                         if idx2name.get(j) == n and states[j] is not None]
                if not found:
                    continue
                for r, st in enumerate(self.opt_state):
                    src = found[0]
                    if n in sharded:
                        src = _state_rows(src, n_rep, r)
                    _copy_state(st[n], src, n)

    def update(self):
        """Sum the replicas' gradients (reduce-scatter the sharded ones),
        apply one update to every trainable parameter (or row block) of
        every replica, then gather the updated rows."""
        o = self.optimizer
        with torch.no_grad():
            for b in self._buckets:
                b.reduce()
            for bufs in self._all_reduce:
                sum_replicas(bufs)
            for n, idx in zip(self.trainable, self._name_idx):
                o._update_count(idx)
                lr = o._get_lr(idx)
                if self._lr_scale is not None:
                    lr *= self._lr_scale(o._index_update_count[idx])
                wd = o._get_wd(idx)
                for p, g, st in zip(self._targets, self._sums,
                                    self.opt_state):
                    self._apply(p[n], g[n], st[n], lr, wd)
            for b in self._buckets:
                b.gather()


def _state_rows(state, n, r):
    """Replica r's 1/n block of rows of a host state (numpy, or a tuple
    of them)."""
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_state_rows(s, n, r) for s in state)
    arr = np.asarray(getattr(state, "_data", state))
    k = arr.shape[0] // n
    return arr[r * k:(r + 1) * k]


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
