"""The fused update rules of Module's train step.

Counterpart of ``mxtpu/module/fused.py``: the update rules ``_rule_sgd``,
``_rule_nag``, ``_rule_adam``, ``_rule_rmsprop``, ``_rule_adagrad``
(:64-165) and ``FusedTrainStep`` with its cross-replica weight-update
sharding (:242-260, 620-632, 708-710, 767-787), the state shared by
the steps of a BucketingModule's buckets (``state=``, ``adopt_state``),
the compile pipeline's one transform of the training graph at
construction (:281-295, with the drift warning), rematerialization
(``fit.remat``, :327-406), the fuse_opt update classes (:408,
:514-560) and the training-health rows with the Monitor adapter's taps
(``arm_health``, :566-599, 717-751, 847-861). The JAX package traces forward,
backward and the update of every parameter into one donated XLA program
(``step`` :634-718, :794-864). Eagerly there is no program to fuse them
into: the forward and backward are the executor's, and what is left here
is the update, every parameter's rule in one call with f32 state. Over
several contexts the step first sums the replicas' gradients with one
collective, then updates every replica from that sum. Under a
``ShardingPlan`` the parameters whose optimizer state shards over
``data`` take the sharded route instead: one reduce-scatter of their
gradients, each replica's rule on its 1/n of their rows, one all-gather
of the updated rows. SGD and Adam update a list of parameters in one
foreach call an op (each fuse_opt update class, then the rest), the
optimizer's single-tensor op chain in its order, so every parameter
rounds as on the Updater; the other rules call the optimizer's update
functions a parameter at a time. Per-parameter lr and wd come from the
optimizer's own ``_get_lr``/``_get_wd`` each step, with Adam's bias
correction folded into lr as its ``update`` folds it.

Training health: once ``arm_health`` ran, ``update`` also leaves in
``last_health`` each parameter class's f32 ``[grad_sq, weight_sq,
update_sq, nonfinite]`` sums and its grad max-abs, on the device, from
the summed gradients and the weights before and after the step (the
first replica's: the replicas are identical). The weights before the
step are copied into one flat f32 scratch (``torch._foreach_copy_``)
before the rules run, so the update keeps its ops and their order; the
rows come from library reductions over lists (``torch._foreach_norm``
per parameter, its squares summed over each class in float64 by one
``cumsum``), and the nonfinite counts from ``torch.isfinite`` over the
scratch holding the gradients, then the fresh weights: a constant
~30 launches a step, whatever the parameter count. The scratch and the
optimizer state are the ledger's ``fused_step`` slot.
"""
from __future__ import annotations

import logging
import os

import numpy as np
import torch

from .. import optimizer as opt
from ..base import MXNetError
from ..compile import pipeline as _pipeline
from ..executor import _block_boundaries
from ..ops.collective import (all_gather_replicas, group_positions,
                              reduce_scatter_replicas, sum_replicas)

__all__ = ["FusedTrainStep", "supports"]


def _f32_zeros(w):
    return torch.zeros(w.shape, dtype=torch.float32, device=w.device)


def _f32(x):
    """A scalar hyperparameter rounded to float32 on the host, ±inf past
    the range, as mxtpu's f32 arithmetic gives: a CUDA foreach kernel
    raises on a scalar that overflows its f32 operand."""
    with np.errstate(over="ignore"):
        return float(np.float32(x))


def _f32s(xs):
    return [_f32(x) for x in xs]


def _prep_each(o, ws, gs, wds):
    """``optimizer._prep`` over lists: each gradient rescaled, clipped
    (when set), plus its parameter's wd times its weight."""
    clip = _f32(o.clip_gradient or -1.0)
    g = torch._foreach_mul(gs, _f32(o.rescale_grad))
    if clip > 0:
        torch._foreach_clamp_min_(g, -clip)
        torch._foreach_clamp_max_(g, clip)
    torch._foreach_add_(g, torch._foreach_mul(ws, _f32s(wds)))
    return g


def _one_at_a_time(over_lists):
    """``apply(p, g, s, lr, wd)`` of a rule written over lists, keeping
    the list form as its ``over_lists``."""
    def apply(p, g, s, lr, wd):
        over_lists([p], [g], [s], [lr], [wd])
    apply.over_lists = over_lists
    return apply


def _rule_sgd(o):
    """``sgd_update_``/``sgd_mom_update_`` over a list of parameters, one
    foreach call an op: the single-tensor chain's ops in its order, so
    every parameter rounds as it would alone."""
    mom = float(getattr(o, "momentum", 0.0) or 0.0)

    def init(w):
        return _f32_zeros(w) if mom else None

    def over_lists(ps, gs, ss, lrs, wds):
        g = _prep_each(o, ps, gs, wds)
        torch._foreach_mul_(g, _f32s(lrs))
        if not mom:
            torch._foreach_sub_(ps, g)
            return
        torch._foreach_mul_(ss, _f32(mom))
        torch._foreach_sub_(ss, g)
        torch._foreach_add_(ps, ss)

    return init, _one_at_a_time(over_lists), None


def _rule_nag(o):
    mom = float(getattr(o, "momentum", 0.0) or 0.0)

    def init(w):
        return _f32_zeros(w) if mom else None

    def apply(p, g, s, lr, wd):
        opt.nag_update_(p, g, s, lr, wd, o.rescale_grad, o.clip_gradient,
                        mom)

    return init, apply, None


def _rule_adam(o):
    """``adam_update_`` over a list of parameters in foreach calls, as
    ``_rule_sgd``."""
    def init(w):
        return (_f32_zeros(w), _f32_zeros(w))

    def over_lists(ps, gs, ss, lrs, wds):
        g = _prep_each(o, ps, gs, wds)
        means = [s[0] for s in ss]
        varis = [s[1] for s in ss]
        torch._foreach_mul_(means, _f32(o.beta1))
        torch._foreach_add_(means, torch._foreach_mul(g, _f32(1 - o.beta1)))
        torch._foreach_mul_(g, g)
        torch._foreach_mul_(g, _f32(1 - o.beta2))
        torch._foreach_mul_(varis, _f32(o.beta2))
        torch._foreach_add_(varis, g)
        denom = torch._foreach_sqrt(varis)
        torch._foreach_add_(denom, _f32(o.epsilon))
        step = torch._foreach_mul(means, _f32s(lrs))
        torch._foreach_div_(step, denom)
        torch._foreach_sub_(ps, step)

    return init, _one_at_a_time(over_lists), o.lr_scale


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


def _over_lists(apply):
    """A rule's ``apply(p, g, s, lr, wd)`` as ``apply(ps, gs, ss, lrs,
    wds)``: the foreach form of a rule that has one, else the rule a
    parameter at a time."""
    many = getattr(apply, "over_lists", None)
    if many is not None:
        return many

    def each(ps, gs, ss, lrs, wds):
        for p, g, s, lr, wd in zip(ps, gs, ss, lrs, wds):
            apply(p, g, s, lr, wd)
    return each


def supports(optimizer):
    """Whether a fused-step update rule exists for this optimizer (not for
    multi-precision SGD, whose master weights stay on the Updater, as in
    mxtpu)."""
    name = type(optimizer).__name__
    if name == "SGD" and getattr(optimizer, "multi_precision", False):
        return False
    return name in _RULES


class _Bucket:
    """The flat buffers of one dtype's parameters updated by rows, on
    every replica; ``groups`` are the replicas that share those rows (the
    data groups: every replica when there is no other axis), each
    reduced on its own.

    ``stage[r]`` holds replica r's gradients laid out shard-major, an (n,
    C) matrix whose row s is the s-th row block of every parameter in
    turn, so one reduce-scatter leaves replica r the summed gradients of
    its own rows in ``grad[r]`` (C); replica r's updated rows are packed
    into ``rows_in[r]`` (C) and one all-gather gives every replica of its
    group all of them, shard-major, in ``gathered[r]`` (n, C), copied
    back into the parameters. ``pre`` (groups, or None) are summed over
    first, in place on the stage: the other row axes that a gradient has
    not been summed over yet (fsdp, for a parameter it does not split)."""

    def __init__(self, names, params, grads, groups, pre=None):
        self.names = names
        self.groups, self.pre = groups, pre
        n = len(groups[0])
        pos = group_positions(groups, len(params))
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
        self.p_rows = [{k: _rows(params[r][k], n, pos[r]) for k in names}
                       for r in reps]
        self.rows_src = [[self.p_rows[r][k].reshape(-1) for k in names]
                         for r in reps]
        self.back_dst = [[params[r][k].view(n, -1) for k in names]
                         for r in reps]
        self.back_src = [[self.gathered[r].view(n, total)[:, o:o + m]
                          for o, m in zip(offs, sizes)] for r in reps]

    def reduce(self):
        """Every replica's gradients into the stage, shard-major, then one
        reduce-scatter a group."""
        n = len(self.groups[0])
        for r, src in enumerate(self.pack_src):
            torch.cat(src, dim=1, out=self.stage[r].view(n, -1))
        for g in self.pre or ():
            sum_replicas([self.stage[r] for r in g])
        for g in self.groups:
            reduce_scatter_replicas([self.stage[r] for r in g],
                                    [self.grad[r] for r in g])

    def gather(self):
        """Each replica's updated rows to every replica of its group, one
        all-gather a group."""
        for r, src in enumerate(self.rows_src):
            torch.cat(src, out=self.rows_in[r])
        for g in self.groups:
            all_gather_replicas([self.rows_in[r] for r in g],
                                [self.gathered[r] for r in g])
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
    replicas end each step with the same bits either way.

    When the plan splits parameters over other axes (``tp``, ``fsdp``:
    its ``replica_layout()``), each replica holds blocks of them, and its
    gradients are block-sized. Every collective then runs over groups of
    replicas: a gradient is summed over the row axes its backward has
    not summed it over (``layout.reduce_axes``: the data group, and the
    fsdp group where fsdp does not split the parameter; never over tp,
    whose peers hold the same rows), the leading segments one run of
    such axes each; a parameter updated by rows is reduce-scattered and
    all-gathered within its data group, on its own block, so it stays
    split over tp and fsdp between steps."""

    def __init__(self, executors, param_names, optimizer, flat_grads=None,
                 plan=None, state=None, module=None, graph_shapes=None,
                 graph_types=None, logger=None):
        if not isinstance(executors, (list, tuple)):
            executors = [executors]
        ex0 = executors[0]
        self._logger = logger or logging
        self.optimizer = optimizer
        self.trainable = [n for n in param_names
                          if ex0.grad_req.get(n, "null") != "null"
                          and n in ex0.grad_dict]
        self._executors = list(executors)
        self._install_program(executors, module, graph_shapes, graph_types)
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
        self._layout = self._plan.replica_layout() \
            if self._plan is not None else None
        reps = list(range(len(executors)))
        self._data_groups = self._layout.groups(
            (self._plan.layout.data_axis,)) if self._layout is not None \
            and self._plan.layout.data_axis in self._layout.sizes \
            else [reps]
        self._data_pos = group_positions(self._data_groups, len(executors))
        init, apply, self._lr_scale = \
            _RULES[type(optimizer).__name__](optimizer)
        self._apply = _over_lists(apply)
        # what each replica's rule updates: the whole parameter and its
        # summed gradient, or under the plan its block of rows
        self._targets = [dict(p) for p in self.params]
        self._sums = [dict(g) for g in self.grads]
        self._buckets = []
        # the flat segments summed in place, one list of replicas each
        self._all_reduce, self._all_reduce_groups = [], []
        if len(executors) > 1:
            segs = self._replicated_segments(flats)
            self._all_reduce = [views for _, views in segs]
            self._all_reduce_groups = [groups for groups, _ in segs]
        if self._plan is not None:
            self._buckets = self._make_buckets()
        if self._plan is not None:
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
        self._health_classes = None
        self._health_taps = None
        self.last_health = None
        self._h = None   # the armed health plan (see arm_health)
        self._tap_sink = {}
        self._mem_slot = None
        if state is None:
            self._account_memory()

    def _install_program(self, executors, module, shapes, types):
        """The training graph, transformed ONCE here by the compile
        pipeline (``kind="fused_step"``), and its rematerialization, set
        as every executor's training program (mxtpu :268-406).
        ``self.symbol`` stays the caller's graph; ``pipeline_report``
        says what the pipeline did. ``update`` warns once if the
        pipeline's config drifts afterwards (re-arm via
        ``init_optimizer(force_init=True)``)."""
        self.symbol = executors[0]._symbol
        self._graph_symbol = self.symbol
        self.pipeline_report = None
        self._pipeline_config = _pipeline.configured()
        self._drift_warned = False
        if self._pipeline_config:
            self._graph_symbol, self.pipeline_report = \
                _pipeline.transform_graph(
                    self.symbol, kind="fused_step", shapes=shapes,
                    types=types, module=module)
            if self.pipeline_report.rejected:
                self._logger.warning(
                    "fused step: compile pipeline rejected transform(s) "
                    "%s — training on the unrewritten graph",
                    ",".join(self.pipeline_report.rejected))
            elif self.pipeline_report.applied:
                self._logger.info(
                    "fused step: compile pipeline applied %s",
                    ",".join(self.pipeline_report.applied))
        self._remat_mode, remat = self._remat_policy()
        for ex in executors:
            ex.set_train_program("fused_step", self._graph_symbol,
                                 self.pipeline_report, remat)
        self._update_groups = self._derive_update_groups()

    def _remat_policy(self):
        """(mode, the executors' ``remat``) from ``MXTPU_REMAT`` /
        ``fit.remat`` (mxtpu :327-403). The walk runs in segments that end
        at the block boundaries (the graph's cut vertices,
        ``executor._block_boundaries``); a checkpointed segment keeps only
        its inputs and is recomputed in the backward. ``none`` keeps every
        activation; ``all``, ``block`` and ``conv`` checkpoint every
        segment; ``auto`` (and an unset knob) checkpoints the segments
        that hold a node the remat_reuse pass annotated ``__remat__``. A
        SET ``none``/``0`` pins no rematerialization, annotations
        included. mxtpu's ``all`` recomputes the whole forward at once,
        and its ``conv`` and ``auto`` keep the chosen outputs inside a
        block; here each is the block's segment whole (the segments cost
        less memory and time than a selective policy on ResNet-50: PERF.md,
        PR 24)."""
        from ..tune import registry as _knobs
        raw = os.environ.get("MXTPU_REMAT")
        env_set = raw is not None
        if raw is None:
            raw = _knobs.resolve("fit.remat")
        mode = str(raw or "none").lower()
        pinned_off = False
        if mode in ("0", "none", "", "false"):
            mode, pinned_off = "none", env_set
        elif mode in ("1", "all", "true"):
            mode = "all"
        elif mode not in ("auto", "block", "conv"):
            raise ValueError(
                "fit.remat / MXTPU_REMAT = %r not recognized (use "
                "none/auto/block/conv/all)" % mode)
        graph = self._graph_symbol
        cuts = _block_boundaries(graph)
        if mode in ("all", "block", "conv"):
            return mode, (cuts, None)
        if not pinned_off:
            hot = {id(n) for n in graph._topo() if not n.is_variable
                   and n._extra_attrs.get("__remat__")}
            if hot:
                return "annotated", (cuts, hot)
        return mode, None

    def _derive_update_groups(self):
        """(class key, member names) pairs from the fuse_opt pass's
        ``__update_class__`` annotations on the transformed graph,
        intersected with this step's trainables, in trainable order
        (mxtpu :512-531); a class left with one member is dropped.
        ``_update_lists`` are the name lists ``update`` applies the rule
        to, one call each: every class, then the trainables in none."""
        groups = {}
        for n in self._graph_symbol._topo():
            if n.is_variable:
                key = n._extra_attrs.get("__update_class__")
                if key:
                    groups.setdefault(key, []).append(n.name)
        tidx = {n: i for i, n in enumerate(self.trainable)}
        out = []
        for key in sorted(groups):
            names = sorted((nm for nm in groups[key] if nm in tidx),
                           key=tidx.get)
            if len(names) >= 2:
                out.append((key, names))
        classed = {n for _, names in out for n in names}
        rest = [n for n in self.trainable if n not in classed]
        self._update_lists = [names for _, names in out] + \
            ([rest] if rest else [])
        return out

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
        """The parameters updated by rows: the plan's, unless the data
        axis already splits the parameter itself."""
        if self._plan is None:
            return set()
        data = self._plan.layout.data_axis
        return {k for k in self._plan.sharded_opt_names()
                if k in self.trainable
                and data not in self._layout.split_axes(k)}

    def _reduce_groups(self, name):
        """The groups over which ``name``'s gradient is summed (None: its
        backward has summed it already)."""
        if self._layout is None:
            return [list(range(len(self.params)))]
        axes = self._layout.reduce_axes(name)
        return self._layout.groups(axes) if axes else None

    def _replicated_segments(self, flats):
        """Per dtype and groups, every replica's view of the run of its
        flat buffer that holds the gradients of the parameters updated
        whole and summed over those groups: [(groups, views)]. The runs
        lead the buffer (the whole buffer without a plan)."""
        sharded = self._sharded()
        segs = []
        for dtype in flats[0]:
            runs = {}
            for k in self.trainable:
                if k not in sharded and self.grads[0][k].dtype == dtype:
                    axes = self._layout.reduce_axes(k) \
                        if self._layout is not None else ()
                    runs.setdefault(axes, []).append(k)
            end = 0
            for names in runs.values():
                groups = self._reduce_groups(names[0])
                size = sum(self.grads[0][k].numel() for k in names)
                if not size or groups is None:
                    continue
                views = []
                for f, g in zip(flats, self.grads):
                    base = f[dtype]
                    lo = min(g[k].data_ptr() for k in names)
                    hi = lo + size * base.element_size()
                    if not all(lo <= g[k].data_ptr() < hi for k in names):
                        raise MXNetError(
                            "the gradients of the parameters updated whole "
                            "must lead each flat buffer (the executor "
                            "group's flat_tail)")
                    off = (lo - base.data_ptr()) // base.element_size()
                    views.append(base[off:off + size])
                    end = max(end, off + size)
                segs.append((groups, views))
            tail = [k for k in self.trainable if k in sharded
                    and self.grads[0][k].dtype == dtype]
            base = flats[0][dtype]
            if any((self.grads[0][k].data_ptr() - base.data_ptr())
                   // base.element_size() < end for k in tail):
                raise MXNetError(
                    "the gradients of the parameters updated whole must "
                    "lead each flat buffer (the executor group's "
                    "flat_tail)")
        return segs

    def _make_buckets(self):
        """The buckets of the parameters updated by rows, one per dtype
        and row axes still to sum over first, in trainable order."""
        sharded = self._sharded()
        data = self._plan.layout.data_axis
        groups = {}
        for k in self.trainable:
            if k in sharded:
                pre = tuple(a for a in self._layout.reduce_axes(k)
                            if a != data)
                groups.setdefault((self.params[0][k].dtype, pre),
                                  []).append(k)
        return [_Bucket(names, self.params, self.grads, self._data_groups,
                        self._layout.groups(pre) if pre else None)
                for (_, pre), names in groups.items()]

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
        """Parameter ``n``'s state as numpy: the row blocks of each data
        group concatenated where it is updated by rows, then each
        replica's block of a split parameter put in place."""
        per = [st[n] for st in self.opt_state]
        lay = self._layout
        split = lay is not None and n in lay.specs
        if n not in self.sharded_names:
            if not split:
                return opt.states_to_numpy(per[0])
            local = [opt.states_to_numpy(p) for p in per]
        else:
            local = [None] * len(per)
            for g in self._data_groups:
                whole = _map_state(lambda *p: np.concatenate(
                    [opt.states_to_numpy(x) for x in p]),
                    *[per[r] for r in g])
                for r in g:
                    local[r] = whole
            if not split:
                return local[0]
        return _map_state(lambda *p: lay.assemble(n, list(p)), *local)

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
        lay = self._layout
        n_rows = len(self._data_groups[0])
        with torch.no_grad():
            for n in self.trainable:
                found = [states[j] for j in sorted(states)
                         if idx2name.get(j) == n and states[j] is not None]
                if not found:
                    continue
                for r, st in enumerate(self.opt_state):
                    src = found[0]
                    if lay is not None and n in lay.specs:
                        src = _map_state(lambda x, r=r: lay.piece(
                            n, np.asarray(getattr(x, "_data", x)), r), src)
                    if n in sharded:
                        src = _state_rows(src, n_rows, self._data_pos[r])
                    _copy_state(st[n], src, n)

    def _account_memory(self):
        """The ledger's ``fused_step`` slot of the first replica's device:
        this step's optimizer state and health scratch (the parameters
        are the executors' bound arrays, counted under ``executor``;
        mxtpu's slot holds its own copy of the parameters and aux too).
        A step that adopted another's state leaves it to that step."""
        from .. import diagnostics as _diag
        if not _diag.mem_enabled():
            return
        nbytes = self.opt_state_bytes()[0] + self._health_bytes()
        if self._mem_slot is None:
            dev = next(iter(self.params[0].values())).device \
                if self.params[0] else None
            ctx = _diag.device_label(dev) if dev is not None else "cpu(0)"
            self._mem_slot = _diag.ledger().slot(self, nbytes, "fused_step",
                                                 ctx=ctx)
        else:
            self._mem_slot.set(nbytes)

    def _health_bytes(self):
        """Device bytes of the armed health plan: the scratch and the
        class index tensors."""
        if self._h is None:
            return 0
        return sum(self._h[k].numel() * self._h[k].element_size()
                   for k in ("scratch", "ends", "class_of"))

    # ------------------------------------------------ training health
    def arm_health(self, taps=None, tap_active=None):
        """Arm the training-health rows (obs/health.py; mxtpu
        :566-599): classes are the fuse_opt update classes, each
        ungrouped trainable its own. ``taps``: a Monitor pattern whose
        matching outputs the training walk reduces to device abs-means
        while ``tap_active()`` (the Monitor adapter). Returns the
        ``(label, member names)`` class list; idempotent."""
        from ..obs.health import class_label
        if self._plan is not None:
            raise MXNetError(
                "training health under a sharding plan (fit(mesh=...)) "
                "is not ported: the step updates row blocks per replica")
        classes, seen = [], set()
        for _key, names in self._update_groups:
            classes.append((class_label(names), tuple(names)))
            seen.update(names)
        for n in self.trainable:
            if n not in seen:
                classes.append((n, (n,)))
        classes = tuple(classes)
        if taps != self._health_taps or tap_active is not None:
            self._health_taps = taps
            for ex in self._executors:
                ex.set_tap_filter(taps, tap_active, self._tap_sink)
        if classes == self._health_classes:
            return classes
        self._health_classes = classes
        names = [n for _, members in classes for n in members]
        params = self.params[0]
        sizes = [params[n].numel() for n in names]
        dev = params[names[0]].device if names else torch.device("cpu")
        scratch = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
        views, o = [], 0
        for n, k in zip(names, sizes):
            views.append(scratch[o:o + k].view(params[n].shape))
            o += k
        ends = np.cumsum([len(m) for _, m in classes]) - 1
        self._h = {"names": names, "scratch": scratch, "views": views,
                   "ends": torch.as_tensor(ends, device=dev),
                   "class_of": torch.as_tensor(np.repeat(
                       np.arange(len(classes)),
                       [len(m) for _, m in classes]), device=dev)}
        self.last_health = None
        self._account_memory()
        return classes

    def _health_rows(self):
        """The step's per-class rows from the scratch (holding the
        weights before the step) and the first replica's weights and
        summed gradients after it."""
        h = self._h
        f32 = torch.float32
        ps = [self._targets[0][n] for n in h["names"]]
        gs = [self._sums[0][n] for n in h["names"]]
        ps32 = [p if p.dtype == f32 else p.float() for p in ps]
        gs32 = [g if g.dtype == f32 else g.float() for g in gs]
        views, scratch = h["views"], h["scratch"]
        torch._foreach_sub_(views, ps32)           # old - new
        cols = [torch._foreach_norm(gs32), torch._foreach_norm(ps32),
                torch._foreach_norm(views)]
        gmax = torch.stack(torch._foreach_norm(gs32, float("inf")))
        nonfinite = None
        for src in (gs32, ps32):
            torch._foreach_copy_(views, src)
            scratch.copy_(torch.isfinite(scratch).logical_not_())
            n = torch.stack(torch._foreach_norm(views, 1))
            nonfinite = n if nonfinite is None else nonfinite + n
        rows = torch.stack([torch.stack(c) for c in cols], dim=1)
        rows = torch.cat([rows * rows, nonfinite[:, None]], dim=1)
        cs = torch.cumsum(rows.double(), dim=0)[h["ends"]]
        sums = torch.cat([cs[:1], cs[1:] - cs[:-1]]).to(f32)
        mx = torch.full((len(self._health_classes),), float("-inf"),
                        dtype=f32, device=gmax.device)
        mx.scatter_reduce_(0, h["class_of"], gmax, "amax")
        return {"sums": sums, "max": mx}

    def update(self):
        """Sum the replicas' gradients (reduce-scatter the sharded ones),
        apply one update to every trainable parameter (or row block) of
        every replica (SGD and Adam in one foreach call an op over each
        fuse_opt update class, and over the trainables in none), then
        gather the updated rows."""
        if not self._drift_warned and \
                _pipeline.configured() != self._pipeline_config:
            self._drift_warned = True
            self._logger.warning(
                "fused step: the compile pipeline changed to %s after this "
                "step was built with %s; it keeps training the graph it "
                "was built with (re-arm with init_optimizer("
                "force_init=True))", list(_pipeline.configured()),
                list(self._pipeline_config))
        o = self.optimizer
        with torch.no_grad():
            if self._h is not None:
                # the weights before the step, for update_sq
                torch._foreach_copy_(self._h["views"], [
                    self._targets[0][n] for n in self._h["names"]])
            for b in self._buckets:
                b.reduce()
            for groups, bufs in zip(self._all_reduce_groups,
                                    self._all_reduce):
                for g in groups:
                    sum_replicas([bufs[r] for r in g])
            rates = {}
            for n, idx in zip(self.trainable, self._name_idx):
                o._update_count(idx)
                lr = o._get_lr(idx)
                if self._lr_scale is not None:
                    lr *= self._lr_scale(o._index_update_count[idx])
                rates[n] = (lr, o._get_wd(idx))
            for names in self._update_lists:
                lrs = [rates[n][0] for n in names]
                wds = [rates[n][1] for n in names]
                for p, g, st in zip(self._targets, self._sums,
                                    self.opt_state):
                    self._apply([p[n] for n in names],
                                [g[n] for n in names],
                                [st[n] for n in names], lrs, wds)
            for b in self._buckets:
                b.gather()
            if self._h is not None:
                self.last_health = self._health_rows()
                taps = self._tap_sink.pop("taps", None)
                if taps is not None:
                    self.last_health["taps"] = taps


def _map_state(fn, *states):
    """``fn`` over the arrays of parallel states (None, an array, or a
    tuple of them)."""
    if states[0] is None:
        return None
    if isinstance(states[0], tuple):
        return tuple(_map_state(fn, *p) for p in zip(*states))
    return fn(*states)


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
