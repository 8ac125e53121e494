"""Executor: runs a bound Symbol as an eager walk of torch ops.

Counterpart of ``mxtpu/executor.py``: the topo walk of ``_trace_graph``
(:120-209), the constructor's ``args_grad``/``grad_req`` (:258-345),
``forward`` (:670) and ``backward`` (:731-800). The JAX package traces
the walk into jitted XLA programs and takes the gradient with
``jax.vjp``; here the walk runs eagerly, and each op's kernels launch
asynchronously on the device's current stream. Inference runs under
``torch.inference_mode()``. Training (``forward(is_train=True)``) runs
under grad mode with the bound arguments that receive a gradient as
autograd leaves, and ``backward`` takes ``torch.autograd.grad`` of the
outputs (head gradients: the caller's, else ones, which a loss head
ignores) and writes or adds each gradient into its bound array in place.
A training forward also writes each op's updated aux values (BatchNorm's
moving statistics) into ``aux_dict`` in place, as ``mxtpu/executor.py``
does (:196-203, :727-728); an inference forward writes nothing.
Where XLA fuses an inference BatchNorm with its ReLU, the inference plan
runs the pair as one pass of the epilogue kernel (``ops/epilogue.py``),
on every device, reading the moving statistics at every forward; the
training plan does not fuse.

``set_monitor_callback`` (mxtpu :829) installs a per-op callback: on a
forward whose callback is active (a ``Monitor``'s sampled batch) the walk
hands it every op's visible outputs by name, as mxtpu's node-at-a-time
walk does (:628-661, :685-689); such an inference forward runs the
unfused plan, so the BatchNorm outputs that the epilogue would fold away
exist and are seen. An unsampled forward keeps the fused plan.
``reshape`` (:834), ``copy_params_from``, ``arg_arrays``/``aux_arrays``
and the ``simple_bind`` method follow mxtpu's. ``eager_run_range`` walks
a range of the graph's nodes one at a time (mxtpu :212), for
``Predictor.partial_forward``.

Telemetry and the profiler (mxtpu :674, :732, :628-661): ``forward``
and ``backward`` (and their replica forms) run in ``executor.forward`` /
``executor.backward`` spans. While the profiler runs in an operator mode
(``profiler.ops_enabled()``) the walk records one chrome-trace span per
op node, the device synchronized at each so the span covers its
kernels, and the backward as one ``backward`` span.

The plans are built through the compile pipeline's seam
(``compile/pipeline.py``; mxtpu :349-445): the inference plan
(``fwd_eval``) from the pipeline's ``executor_infer`` rewrite of the
graph, with quant's int8 copies of the weights streamed in
(``_inject_prepared``), the training plan (``fwd_bwd``, or the
``fused_step`` a ``FusedTrainStep`` installs with its one transform and
its rematerialization), each built once per pipeline config and
calibration state and counted by ``executor_program_builds{kind=}``;
a hit counts ``executor_program_cache_hits``. Under the bf16 rewrite the
epilogue fuses a BatchNorm -> ReLU pair through the casts around it.
A walk drops each value after its last reader, so only what autograd
saves outlives its use.

Diagnostics (mxtpu :317-326, 610-621, :189-195): the bound arrays count
in the memory ledger under ``executor`` (once per storage), the outputs
in an ``executor_outputs`` slot; with a tap filter set by a fused step's
``arm_health`` (the Monitor adapter), a training forward of a sampled
batch reduces each matching output to its device abs-mean.

``forward_replicas`` and ``backward_replicas`` run several executors of
one symbol, each bound on its slice of a batch on its own device, as one
function of the whole batch: the plan is walked over the replicas in
lockstep (each step issued once per device; launches are asynchronous,
so the devices overlap), an op that couples rows of the batch runs once
over all replicas (``OpDef.group_fn``: BatchNorm's statistics, a
normalized loss), and one ``torch.autograd.grad`` over every replica's
heads carries the cross-replica terms back. This is the port's form of
mxtpu's multi-context fused step, which is the single-device function
of the whole batch under GSPMD (mxtpu/module/fused.py:235-255).
"""
from __future__ import annotations

import collections
import time

import torch

from . import diagnostics as _diag
from . import profiler as _prof
from . import telemetry as _tel
from .base import MXNetError
from .compile import pipeline as _pipeline
from .context import as_context, current_context
from .ndarray import NDArray
from .ops.collective import gather_split
from .ops.nn import bn_relu_inference
from .ops.registry import torch_dtype, write_aux

__all__ = ["Executor", "simple_bind", "forward_replicas",
           "backward_replicas", "eager_run_range"]

# standing series: registry-direct so it exists for /metrics even when
# MXTPU_TELEMETRY=0 was set at import (mxtpu/executor.py:81)
_M_CACHE_HITS = _tel.registry().counter(
    "executor_program_cache_hits",
    help="per-executor program-table hits (no rebuild)")


def _version(t):
    """A tensor's in-place version counter (None for an inference tensor,
    which keeps none)."""
    try:
        return t._version
    except RuntimeError:
        return None


def _amp_cast(node, dtype):
    """Whether ``node`` is one of the bf16 rewrite's boundary casts to
    ``dtype`` ("float32" up, "bfloat16" down: ``analysis.rewrite``'s
    ``*_f32_amp``/``*_bf16_amp`` Cast nodes; mxtpu's
    ``equiv._is_amp_cast``)."""
    if node.is_variable or node.op.name != "Cast":
        return False
    suffix = "_f32_amp" if dtype == "float32" else "_bf16_amp"
    return node.name.endswith(suffix) and \
        str(node.attrs.get("dtype")) == dtype


def _fusable_bn(node, consumers, graph_outputs):
    """The Activation(relu) node that an inference BatchNorm ``node``
    fuses with, or None. It qualifies when it has no mean/var outputs, is
    not a graph output, and its one consumer is a ReLU."""
    if node.op.name != "BatchNorm":
        return None
    a = node.parsed_attrs()
    if a.output_mean_var or (id(node), 0) in graph_outputs:
        return None
    users = consumers.get(id(node), [])
    if len(users) != 1 or users[0].op.name != "Activation" or \
            users[0].parsed_attrs().act_type != "relu":
        return None
    return users[0]


def _epilogue_site(node, consumers, graph_outputs):
    """One fused BatchNorm -> ReLU step of an inference plan, or None:
    ``(relu, source entry, cast in, out node, out dtype)``. Under the
    bf16 rewrite the BatchNorm is an f32 island between casts (mxtpu's
    ``Cast(f32) -> BatchNorm -> ReLU [-> Cast(bf16)]``): the step reads
    the up-cast's bf16 input (the up-cast is exact), and where the ReLU's
    one consumer is a down-cast it writes that cast's bf16 output (one
    rounding of the f32 result, as the cast rounds). ``cast in`` is the
    up-cast when the BatchNorm is its only consumer (its step is then
    dropped), else None; ``out node`` is the node whose output slot the
    step writes (the ReLU or its down-cast)."""
    relu = _fusable_bn(node, consumers, graph_outputs)
    if relu is None:
        return None
    src, idx = node.inputs[0]
    cast_in, dtype = None, None
    if _amp_cast(src, "float32"):
        if len(consumers.get(id(src), [])) == 1:
            cast_in = src
        src, idx = src.inputs[0]
        dtype = torch.float32   # the island's f32, whatever x's type
    out = relu
    users = consumers.get(id(relu), [])
    if (id(relu), 0) not in graph_outputs and len(users) == 1 and \
            _amp_cast(users[0], "bfloat16"):
        out, dtype = users[0], torch.bfloat16
    return relu, (id(src), idx), cast_in, out, dtype


def _aux_sources(node, attrs):
    """[(position among the op's aux values, name of the aux variable
    that feeds it)] of an op node with aux_names."""
    names = node.op.input_names(attrs)
    out = []
    for j, an in enumerate(node.op.aux_names):
        src = node.inputs[names.index(an)][0]
        if src.is_variable:
            out.append((j, src.name))
    return out


def _trace_graph(symbol, is_train, fuse=True, placements=None,
                 default_device=None, remat=None):
    """Return ``run(arg_vals, aux_vals) -> (outputs, aux_updates)`` for
    ``symbol``; ``aux_updates`` maps an aux variable's name to the value
    the op it feeds computed for it in a training run (later writers
    win), and is empty at inference.

    The plan (topo order, parsed attrs, input slots) is built once here,
    so a forward only walks a list. At inference each fusable
    ``BatchNorm -> Activation(relu)`` pair (``_epilogue_site``, through
    the bf16 rewrite's casts around the BatchNorm) becomes one step,
    ``nn.bn_relu_inference``, that writes the ReLU's (or its down-cast's)
    output slot: the executor's counterpart of the fusion XLA builds for
    the JAX package. ``run.fused_sites`` counts those pairs;
    ``run.replicas`` walks the plan over several replicas in lockstep
    (``forward_replicas``). ``fuse=False`` keeps an inference plan
    unfused, for a caller that differentiates it (the epilogue kernel has
    no gradient); training plans never fuse.

    ``remat`` (training): ``(cuts, hot)`` walks the plan in segments
    that end at the nodes of ``cuts`` (the graph's block boundaries,
    ``_block_boundaries``); each segment that holds a node of ``hot``
    (every segment, where ``hot`` is None) runs under ``torch.utils.
    checkpoint``, which keeps only its inputs, so the backward recomputes
    one segment at a time: the port's form of mxtpu's ``jax.checkpoint``
    policies (module/fused.py:640-675).

    ``placements`` (group2ctx: a ``__ctx_group__`` name -> torch.device)
    puts each node on its group's device, and every other op node on
    ``default_device``: an input on another device crosses with
    ``.to(device)``, which torch's autograd carries back in the backward
    (the reference's ``_CrossDeviceCopy``; mxtpu/executor.py:120-179).
    ``run.copies`` counts the crossings of the last run. An op with no
    tensor inputs (``_zeros``) makes its output on its node's device, or
    on the ``device`` given to ``run`` (default: the first argument's)."""
    fuse = fuse and not is_train
    topo = symbol._topo()
    aux_nodes = symbol._aux_node_set()
    graph_outputs = {(id(n), i) for n, i in symbol._outputs}
    consumers = {}
    for node in topo:
        for n, _ in node.inputs:
            consumers.setdefault(id(n), []).append(node)
    sites = {}
    skipped = set()  # ids of the nodes folded into an epilogue step
    if fuse:
        for node in topo:
            if node.is_variable:
                continue
            site = _epilogue_site(node, consumers, graph_outputs)
            if site is not None:
                sites[id(node)] = site
                relu, _src, cast_in, out, _dt = site
                skipped.update(id(n) for n in (relu, cast_in, out)
                               if n is not None)
    # a step: (node, attrs, input entries, visible outputs, the fused
    # epilogue's output entry, its out dtype, aux outputs, device)
    plan = []
    placements = placements or {}
    for node in topo:
        if node.is_variable:
            plan.append((node, None, None, None, None, None, (), None))
            continue
        if id(node) in skipped:
            continue
        attrs = node.parsed_attrs()
        if "__is_train__" in node.op.attrs_spec:
            attrs = type(attrs)(attrs)
            attrs["__is_train__"] = is_train
        ins = [(id(n), i) for n, i in node.inputs]
        dev = placements.get(node._extra_attrs.get("__ctx_group__"),
                             default_device) if placements else None
        site = sites.get(id(node))
        if site is not None:
            _relu, src, _cast_in, out, dtype = site
            plan.append((node, attrs, [src] + ins[1:], 0, (id(out), 0),
                         dtype, (), dev))
        else:
            aux = _aux_sources(node, attrs) \
                if is_train and node.op.aux_names else ()
            plan.append((node, attrs, ins, node.op.n_out(attrs), None, None,
                         aux, dev))
    out_entries = [(id(n), i) for n, i in symbol._outputs]
    # each entry's last reader: the walk drops it from its env after that
    # step, so a value lives only as long as the graph needs it (or as
    # autograd keeps it) and not to the end of the walk
    last = {}
    for i, entry in enumerate(plan):
        for k in entry[2] or ():
            last[k] = i
    for k in out_entries:
        last[k] = len(plan)
    free_after = [[] for _ in plan]
    for k, i in last.items():
        if i < len(plan):
            free_after[i].append(k)
    segments, checkpointed = [(0, len(plan))], set()
    if remat is not None:
        (cuts, hot), segments, lo = remat, [], 0
        for i, entry in enumerate(plan):
            if id(entry[0]) in cuts:
                segments.append((lo, i + 1))
                lo = i + 1
        if lo < len(plan):
            segments.append((lo, len(plan)))
        checkpointed = {seg for seg in segments if hot is None or any(
            id(plan[i][0]) in hot for i in range(*seg))}
    # the values each segment reads (those made before it are handed in
    # as a snapshot: its recompute in the backward reads them again after
    # the walk has dropped them)
    reads = {seg: {k for i in range(*seg) for k in plan[i][2] or ()}
             for seg in segments}

    def steps(lo, hi, envs, updates, bound, hook, layout):
        """Run plan entries ``[lo, hi)`` into ``envs`` (one per replica),
        each value dropped after its last reader; ``bound`` is (each
        replica's device, its argument values, its aux values). Returns
        the cross-device copies made."""
        devices, arg_list, aux_list = bound
        copies = 0
        for step in range(lo, hi):
            (node, attrs, ins, n_vis, fused_out, out_dtype, aux,
             dev) = plan[step]
            _drop(envs, free_after[step - 1] if step > lo else ())
            if attrs is None:
                for env, args, auxs in zip(envs, arg_list, aux_list):
                    src = auxs if id(node) in aux_nodes else args
                    env[(id(node), 0)] = src[node.name]
                continue
            inputs = [[env[k] for k in ins] for env in envs]
            if dev is not None:
                x = inputs[0]
                for j, t in enumerate(x):
                    if t.device != dev:
                        x[j] = t.to(dev)
                        copies += 1
            outs = None
            if layout is not None and layout.specs:
                outs, inputs = _split_inputs(node, attrs, inputs, layout,
                                             fused_out is None)
            if fused_out is not None:
                for env, x in zip(envs, inputs):
                    env[fused_out] = bn_relu_inference(
                        attrs, *x, out_dtype=out_dtype)
                continue
            if outs is None:
                outs = _replica_outputs(node, attrs, inputs, devices,
                                        dev, layout)
            for env, upd, o in zip(envs, updates, outs):
                for i in range(n_vis):
                    env[(id(node), i)] = o[i]
                for j, name in aux:
                    upd[name] = o[n_vis + j]
            if hook is not None:
                hook(node, n_vis, outs[0])
        if hi > lo:
            _drop(envs, free_after[hi - 1])
        return copies

    def segment(lo, hi, envs, bound, layout):
        """One checkpointed segment: the entries it makes that later
        steps read, and its aux updates, written apart from ``envs`` (a
        recompute in the backward runs it again and must leave the walk's
        values alone)."""
        views = [collections.ChainMap({}, env) for env in envs]
        updates = [{} for _ in envs]
        copies = steps(lo, hi, views, updates, bound, None, layout)
        return [v.maps[0] for v in views], updates, copies

    def walk(arg_list, aux_list, devices, hook, layout):
        envs = [{} for _ in arg_list]
        updates = [{} for _ in arg_list]
        bound = (devices, arg_list, aux_list)
        if remat is None or hook is not None or \
                not torch.is_grad_enabled():
            copies = steps(0, len(plan), envs, updates, bound, hook,
                           layout)
        else:
            from torch.utils.checkpoint import checkpoint
            copies = 0
            for lo, hi in segments:
                if (lo, hi) not in checkpointed:
                    copies += steps(lo, hi, envs, updates, bound, None,
                                    layout)
                    continue
                snap = [{k: env[k] for k in reads[(lo, hi)] if k in env}
                        for env in envs]
                new, upd, c = checkpoint(segment, lo, hi, snap, bound,
                                         layout, use_reentrant=False)
                for env, n in zip(envs, new):
                    env.update(n)
                # the outer values this segment read last
                _drop(envs, [k for i in range(lo, hi)
                             for k in free_after[i]])
                for u, n in zip(updates, upd):
                    u.update(n)
                copies += c
        run.copies = copies
        return [[env[e] for e in out_entries] for env in envs], updates

    def run_replicas(arg_list, aux_list, devices=None, hook=None,
                     layout=None):
        """The plan over replicas in lockstep, one value set per replica
        (one: the plain walk): ([outputs of each], [aux_updates of
        each]). Over several, each op runs by its ``replica_mode``.
        ``devices``: each replica's device, for the ops with no tensor
        inputs (default: each replica's first argument's). ``hook(node,
        n_vis, outputs)`` sees each unfused op step's outputs (the first
        replica's). ``layout`` (a ``parallel.mesh.ReplicaLayout``): the
        replicas hold blocks of the parameters it splits, and tp peers
        the same rows; an op that such a parameter reaches runs by its
        ``tp_fn``, or on the parameter gathered right before it
        (``_split_inputs``), and a ``group`` op runs once per row group
        (the replicas that share a tp index). A rematerialized plan
        (``remat``) runs in checkpointed segments unless a hook watches
        it (a hook would see the backward's recompute too)."""
        if placements and len(arg_list) > 1:
            raise MXNetError("group2ctx placement runs one replica")
        if devices is None:
            devices = [next((t.device for t in args.values()),
                            torch.device("cpu")) for args in arg_list]
        return walk(arg_list, aux_list, devices, hook, layout)

    def run(arg_vals, aux_vals, device=None, hook=None):
        outs, updates = run.replicas([arg_vals], [aux_vals],
                                     None if device is None else [device],
                                     hook=hook)
        return outs[0], updates[0]

    run.fused_sites = len(sites)
    run.replicas = run_replicas
    run.copies = 0
    return run


def _drop(envs, keys):
    """Forget ``keys`` in every env (a segment's view drops only what it
    made itself)."""
    for env in envs:
        own = env.maps[0] if isinstance(env, collections.ChainMap) else env
        for k in keys:
            own.pop(k, None)


def _block_boundaries(symbol):
    """Node ids of the graph's dataflow cut vertices (mxtpu
    executor.py:84-117): op nodes past which no earlier intermediate is
    live; a run of directly chained cuts collapsed to its most
    downstream node; graph outputs left out. In ResNet these are the
    activations after each residual join."""
    topo = symbol._topo()
    idx = {id(n): i for i, n in enumerate(topo)}
    last_use = {}
    for n in topo:
        for src, _ in n.inputs:
            if not src.is_variable:
                last_use[id(src)] = max(last_use.get(id(src), -1),
                                        idx[id(n)])
    cuts = []
    live_horizon = -1
    for i, n in enumerate(topo):
        if not n.is_variable and live_horizon <= i:
            cuts.append(n)
        live_horizon = max(live_horizon, last_use.get(id(n), -1))
    cut_ids = {id(n) for n in cuts}
    for n in cuts:
        srcs = [s_ for s_, _ in n.inputs if not s_.is_variable]
        if len(srcs) == 1 and id(srcs[0]) in cut_ids:
            cut_ids.discard(id(srcs[0]))
    for n, _ in symbol._outputs:
        cut_ids.discard(id(n))
    return cut_ids


def _replica_outputs(node, attrs, inputs, devices, dev, layout):
    """Each replica's outputs of an op by its ``replica_mode``: on its
    rows alone, or by ``group_fn`` over the replicas that hold distinct
    rows (each tp index's on its own under a layout with a tp axis)."""
    mode = "rows" if len(inputs) == 1 else node.op.replica_mode(
        attrs, inputs[0][0].ndim if inputs[0] else 0)
    if mode == "rows":
        return [node.op.apply(attrs, x, dev or d)
                for x, d in zip(inputs, devices)]
    if mode is None:
        raise MXNetError(
            "%s '%s' couples rows of the batch and has no form over "
            "replicas: this graph cannot train on several contexts as one "
            "batch" % (node.op.name, node.name))
    if layout is None or layout.tp_axis is None:
        return node.op.group_fn(attrs, inputs)
    outs = [None] * len(inputs)
    for g in layout.groups(layout.row_axes):
        for i, o in zip(g, node.op.group_fn(attrs, [inputs[i] for i in g])):
            outs[i] = o
    return outs


def _split_inputs(node, attrs, inputs, layout, tp_form=True):
    """(outputs or None, inputs) of an op over replicas that hold blocks
    of the parameters ``layout`` splits: the op's ``tp_fn`` where it has
    a form for the split (``tp_form``), else the inputs with every split
    parameter gathered whole on each replica (``gather_split``)."""
    split = {j: n.name for j, (n, _) in enumerate(node.inputs)
             if n.is_variable and n.name in layout.specs}
    if not split:
        return None, inputs
    if tp_form and node.op.tp_fn is not None:
        outs = node.op.tp_fn(attrs, inputs, split, layout)
        if outs is not None:
            return outs, inputs
    inputs = [list(x) for x in inputs]
    for j, name in split.items():
        whole = gather_split([x[j] for x in inputs], name, layout)
        for x, w in zip(inputs, whole):
            x[j] = w
    return None, inputs


def eager_run_range(symbol, env, start, stop, arg_vals, aux_vals, device,
                    topo=None):
    """Run the nodes ``[start, stop)`` of ``symbol``'s topological order
    one at a time, at inference and unfused, into ``env`` (entry key ->
    tensor), reading variables from ``arg_vals``/``aux_vals`` and making
    the outputs of ops with no tensor inputs on ``device`` (mxtpu
    :212-255; the predict API's partial forward)."""
    topo = topo if topo is not None else symbol._topo()
    aux_nodes = symbol._aux_node_set()
    for node in topo[start:stop]:
        if node.is_variable:
            src = aux_vals if id(node) in aux_nodes else arg_vals
            env[(id(node), 0)] = src[node.name]
            continue
        attrs = node.parsed_attrs()
        if "__is_train__" in node.op.attrs_spec:
            attrs = type(attrs)(attrs)
            attrs["__is_train__"] = False
        outs = node.op.apply(attrs, [env[(id(n), i)] for n, i in
                                     node.inputs], device)
        for i in range(node.op.n_out(attrs)):
            env[(id(node), i)] = outs[i]


class Executor:
    """Bound computation on one device context; with ``group2ctx`` (a
    ``__ctx_group__`` name -> Context) each tagged node computes on its
    group's context and every other op node on ``ctx``."""

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None, group2ctx=None):
        self._symbol = symbol
        self._ctx = as_context(ctx) if ctx is not None else current_context()
        self._device = self._ctx.torch_device
        self._group2ctx = group2ctx
        self._placements = {g: as_context(c).torch_device
                            for g, c in (group2ctx or {}).items()} or None
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()
        self.arg_dict = self._as_dict(args, self.arg_names, "args")
        self.aux_dict = self._as_dict(aux_states or {}, self.aux_names,
                                      "aux_states")
        if isinstance(grad_req, str):
            self.grad_req = {n: grad_req for n in self.arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self.grad_req = dict(zip(self.arg_names, grad_req))
        else:
            self.grad_req = {n: grad_req.get(n, "null")
                             for n in self.arg_names}
        for n, req in self.grad_req.items():
            if req not in ("write", "add", "null"):
                raise MXNetError("grad_req %r of '%s': use write, add or "
                                 "null" % (req, n))
        self.grad_dict = {} if args_grad is None else self._as_dict(
            args_grad, self.arg_names, "args_grad", allow_missing=True)
        self.outputs = []
        self.cross_device_copies = 0  # inputs moved in the last forward
        self._runs = {}     # (is_train, fuse) -> the plan's run function
        self._runs_config = None  # the pipeline config the table is for
        self._xform = {}    # (config, infer) -> (symbol, PipelineReport)
        self.pipeline_report = None
        self._prepared_args = {}  # quant's {new arg: {src, scale, axis}}
        # src name -> (source tensor, its version, int8 copy)
        self._prep_cache = {}
        # src name -> (the tensor the scales came from, its version)
        self._prep_src = {}
        # the training program a FusedTrainStep installed: (kind, symbol,
        # PipelineReport or None, remat policy or None)
        self._train_program = None
        self._tape = None   # (outputs with their graph, {name: leaf})
        self._monitor_callback = None
        self._profiled = False  # the last training forward was profiled
        # monitor-adapter taps: (compiled pattern, is_active, sink) set
        # by a fused step armed with taps; a tapped forward leaves its
        # {name: device abs-mean} in sink["taps"]
        self._tap_filter = None
        self._out_slot = None
        # memory ledger (mxtpu :317-326): every bound array (args, grads,
        # aux) counts once per storage under 'executor' (the outermost
        # origin wins: 'serving_pool' inside a pool bind); a gradient
        # that is a view into a flat buffer counts the buffer once
        if _diag.mem_enabled():
            led = _diag.ledger()
            with _diag.alloc_origin("executor"):
                for d in (self.arg_dict, self.grad_dict, self.aux_dict):
                    for v in d.values():
                        led.track(v._data, ctx=str(v.context))

    @staticmethod
    def _as_dict(vals, names, what, allow_missing=False):
        out = dict(vals) if isinstance(vals, dict) else dict(zip(names, vals))
        out = {k: v for k, v in out.items() if v is not None}
        if not allow_missing:
            for n in names:
                if n not in out:
                    raise MXNetError("%s: missing array for '%s'" % (what, n))
        return out

    # -------------------------------------------------- program table
    def _program_symbol(self, names, infer=False):
        """The graph the plans are built from: the bind symbol run through
        the compile pipeline (mxtpu :349-400). With the pipeline empty —
        the default — this IS ``self._symbol``. The transform result is
        cached per (pipeline config, inference flag): ``infer`` builds tag
        the pipeline ``kind="executor_infer"`` and expose the bound
        parameter values, which licenses inference-only rewrites (the
        quant pass scales weights off them); training builds keep
        ``kind="executor"`` and the f32 masters."""
        key = (names, bool(infer))
        hit = self._xform.get(key)
        if hit is not None:
            sym, report = hit
            self.pipeline_report = report
            if infer:
                self._prepared_args = report.prepared_args \
                    if report is not None else {}
            return sym
        values = None
        if not names:
            sym, report = self._symbol, None
        else:
            shapes = {n: tuple(v.shape)
                      for d in (self.arg_dict, self.aux_dict)
                      for n, v in d.items() if v is not None}
            types = {n: v.dtype
                     for d in (self.arg_dict, self.aux_dict)
                     for n, v in d.items() if v is not None}
            if infer:
                values = {n: v._data for n, v in self.arg_dict.items()
                          if v is not None}
            sym, report = _pipeline.transform_graph(
                self._symbol,
                kind="executor_infer" if infer else "executor",
                shapes=shapes, types=types, values=values)
        self._xform[key] = (sym, report)
        self.pipeline_report = report
        if infer:
            self._prepared_args = report.prepared_args \
                if report is not None else {}
            self._prep_cache = {}
            self._prep_src = {
                spec["src"]: (values[spec["src"]],
                              _version(values[spec["src"]]))
                for spec in self._prepared_args.values()
                if values and spec["src"] in values}
        return sym

    def set_train_program(self, kind, symbol, report=None, remat=None):
        """Build the training plan from ``symbol`` under ``kind`` (a
        FusedTrainStep's transformed graph, ``fused_step``) instead of
        the executor's own ``fwd_bwd`` graph, with ``remat`` (see
        ``_trace_graph``); ``None`` restores the executor's own."""
        self._train_program = None if kind is None else \
            (kind, symbol, report, remat)
        self._runs.pop((True, False), None)

    def _run(self, is_train, fuse=True):
        """The plan for a forward: the inference program (``fwd_eval``:
        fused, built from the pipeline's ``executor_infer`` graph), the
        training program (``fwd_bwd``, or the ``fused_step`` a fused step
        installed), or the monitor's unfused walk of the bind symbol. The
        program table is valid for one pipeline config and calibration
        state (mxtpu :403-445): a change drops it, and a quantized plan
        is rebuilt when a parameter it scaled was swapped for another
        tensor."""
        from .compile import quant as _quant
        names = _pipeline.configured()
        cfg = (names, _quant.calibrating())
        if self._runs_config != cfg:
            self._runs = {}
            self._runs_config = cfg
        key = (is_train, fuse and not is_train)
        if key == (False, True) and self._prepared_args:
            # a quantized plan bakes its weight scales into the graph: a
            # parameter swapped for another tensor, or written in place
            # (``copy_params_from``, ``set_params``: its version moves),
            # rebuilds and re-quantizes from the new weights
            for src, (built, version) in self._prep_src.items():
                nd = self.arg_dict.get(src)
                if nd is not None and (nd._data is not built or
                                       _version(nd._data) != version):
                    self._runs.pop(key, None)
                    self._xform.pop((names, True), None)
                    break
        run = self._runs.get(key)
        if run is not None:
            if key != (False, False):
                _M_CACHE_HITS.inc()
            return run
        if key == (False, False):
            # the monitor's per-op walk of the bind graph: not a program
            run = _trace_graph(self._symbol, False, fuse=False,
                               placements=self._placements,
                               default_device=self._device)
            self._runs[key] = run
            return run
        remat, calib_heads = None, None
        if is_train and self._train_program is not None:
            kind, symbol, report, remat = self._train_program
            self.pipeline_report = report
        else:
            kind = "fwd_bwd" if is_train else "fwd_eval"
            symbol = self._program_symbol(names, infer=not is_train)
        _pipeline.notify_build(kind, self)
        report = self.pipeline_report
        if not is_train and _quant.calibrating():
            entries = self._calib_entries(symbol)
            if entries:
                from .symbol.symbol import Symbol as _Sym
                calib_heads = tuple(nm for nm, _n, _i in entries)
                symbol = _Sym(list(symbol._outputs)
                              + [(n, i) for _nm, n, i in entries])
        run = _trace_graph(symbol, is_train, fuse=True,
                           placements=self._placements,
                           default_device=self._device, remat=remat)
        run.replicas = _pipeline.instrument_program(
            kind, run.replicas, owner=self,
            precision=report.precision if report is not None else None,
            transforms=report.transforms if report is not None else None,
            calib_heads=calib_heads,
            cert=report.cert if report is not None else None)
        self._runs[key] = run
        return run

    def _calib_entries(self, symbol):
        """Observation heads for int8 activation calibration: the entries
        ``quant_plan`` wants watched, planned on the bind symbol (stable
        names) and located by producer name in the plan's ``symbol``
        (mxtpu :546-575). ``[(entry_name, node, idx)]`` in plan order."""
        from .analysis import dataflow as _df
        from .tune import registry as _knobs
        shapes = {n: tuple(v.shape)
                  for d in (self.arg_dict, self.aux_dict)
                  for n, v in d.items() if v is not None}
        types = {n: v.dtype
                 for d in (self.arg_dict, self.aux_dict)
                 for n, v in d.items() if v is not None}
        plan = _df.quant_plan(
            self._symbol, shapes=shapes, types=types,
            min_layer_elems=int(_knobs.resolve("quant.min_layer_elems")))
        if not plan.observe:
            return []
        byname = {}
        for n in symbol._topo():
            if not n.is_variable:
                byname.setdefault(n.name, n)
        out = []
        for name, node, idx in plan.observe:
            n2 = byname.get(node.name)
            if n2 is not None:
                out.append((name, n2, idx))
        return out

    def _inject_prepared(self, raw_args):
        """Swap quant's prepared arguments into the inference feed: each
        quantized weight's f32 master is replaced by its int8 copy
        (quantized once per source tensor) under the rewrite's new
        argument name (mxtpu :577-598). No-op without an applied quant
        rewrite."""
        prep = self._prepared_args
        if not prep:
            return raw_args
        from .compile import quant as _quant
        out = dict(raw_args)
        for new, spec in prep.items():
            cur = out.pop(spec["src"], None)
            if cur is None:
                continue
            cached = self._prep_cache.get(spec["src"])
            if cached is None or cached[0] is not cur or \
                    cached[1] != _version(cur):
                cached = (cur, _version(cur), _quant.quantize_array(
                    cur, spec["scale"], spec["axis"]))
                self._prep_cache[spec["src"]] = cached
            out[new] = cached[2]
        return out

    def _monitor_hook(self):
        """The walk's hook that hands the monitor callback each op's
        visible outputs by name, or None when no callback is active (an
        unsampled batch)."""
        cb = self._monitor_callback
        if cb is None or not getattr(cb, "is_active", lambda: True)():
            return None
        from .symbol.symbol import _output_names

        def hook(node, n_vis, outs):
            for name, o in zip(_output_names(node, n_vis), outs):
                cb(name, self._wrap(o.detach()))
        return hook

    def _profile_hook(self):
        """The walk's hook that records each op node as a profiler span,
        the device synchronized at each node; None unless the profiler
        runs in an operator mode."""
        if not _prof.ops_enabled():
            return None
        device = self._device
        last = [time.time() * 1e6]

        def hook(node, n_vis, outs):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            now = time.time() * 1e6
            _prof.record_span(node.name, last[0], now,
                              category=node.op.name)
            last[0] = now
        return hook

    def _tap_hook(self):
        """The training walk's hook that reduces each output whose name
        the tap pattern matches to its f32 abs-mean on the device (the
        Monitor adapter's taps, mxtpu :189-195), into a fresh dict at the
        filter's ``sink["taps"]``; None unless a tap filter is set and
        active (the monitor's sampled batch)."""
        tf = self._tap_filter
        if tf is None or not tf[1]():
            return None
        prog, _, sink = tf
        taps = sink["taps"] = {}
        from .symbol.symbol import _output_names

        def hook(node, n_vis, outs):
            for name, o in zip(_output_names(node, n_vis), outs):
                if prog.match(name) and o.is_floating_point():
                    taps[name] = o.detach().float().abs().mean()
        return hook

    def set_tap_filter(self, pattern, is_active, sink):
        """Tap the outputs ``pattern`` matches on training forwards while
        ``is_active()``, into ``sink["taps"]`` (None: no taps). A reshaped
        executor keeps the filter and its sink."""
        import re
        self._tap_filter = None if pattern is None else \
            (re.compile(pattern), is_active or (lambda: True), sink)

    def _account_outputs(self):
        """The outputs' bytes into the ledger's ``executor_outputs`` slot
        (mxtpu :610-621): they churn every forward at a bind-fixed size."""
        if not _diag.mem_enabled():
            return
        nbytes = sum(o._data.numel() * o._data.element_size()
                     for o in self.outputs)
        if self._out_slot is None:
            self._out_slot = _diag.ledger().slot(
                self, nbytes, "executor_outputs", ctx=str(self._ctx))
        else:
            self._out_slot.set(nbytes)

    def _hooks(self, train=False):
        hooks = [h for h in (self._monitor_hook(), self._profile_hook(),
                             self._tap_hook() if train else None)
                 if h is not None]
        if len(hooks) < 2:
            return hooks[0] if hooks else None

        def both(node, n_vis, outs):
            for h in hooks:
                h(node, n_vis, outs)
        return both

    def _wrap(self, t):
        """An output as an NDArray on its own device's context."""
        return NDArray(t, self._ctx if t.device == self._device else None)

    def _grad_names(self):
        return [n for n in self.arg_names
                if self.grad_req.get(n, "null") != "null"
                and n in self.grad_dict]

    def _train_inputs(self, kwargs):
        """(args, aux, leaves) of a training forward: the raw tensors, the
        arguments that receive a gradient as fresh autograd leaves."""
        raw_args, raw_aux = self._inputs(kwargs)
        leaves = {}
        for n in self._grad_names():
            leaves[n] = raw_args[n] = raw_args[n].detach().requires_grad_()
        return raw_args, raw_aux, leaves

    def _inputs(self, kwargs):
        for k, v in kwargs.items():
            if k in self.arg_dict:
                self.arg_dict[k][:] = v
        self._tape = None
        return ({n: self.arg_dict[n]._data for n in self.arg_names},
                {n: self.aux_dict[n]._data for n in self.aux_names})

    def _trained(self, outs, aux_updates, leaves):
        """Finish a training forward: the aux writeback, the tape for
        ``backward``, the detached outputs."""
        write_aux({n: a._data for n, a in self.aux_dict.items()},
                  aux_updates)
        self._tape = (outs, leaves)
        self.outputs = [self._wrap(o.detach()) for o in outs]
        self._account_outputs()
        return self.outputs

    def forward(self, is_train=False, **kwargs):
        """Run the graph; returns the list of output NDArrays. With
        ``is_train`` the run keeps its autograd graph for ``backward``.
        With an active monitor callback every op's outputs reach it, the
        inference walk unfused."""
        with _tel.span("executor.forward", category="executor"):
            return self._forward_impl(is_train, kwargs)

    def _forward_impl(self, is_train, kwargs):
        hook = self._hooks(train=is_train)
        self._profiled = is_train and _prof.ops_enabled()
        if not is_train:
            raw_args, raw_aux = self._inputs(kwargs)
            run = self._run(False, fuse=hook is None)
            if hook is None:
                raw_args = self._inject_prepared(raw_args)
            with torch.inference_mode():
                outs, _ = run(raw_args, raw_aux, self._device, hook=hook)
            self.cross_device_copies = run.copies
            self.outputs = [self._wrap(o) for o in outs]
            self._account_outputs()
            return self.outputs
        raw_args, raw_aux, leaves = self._train_inputs(kwargs)
        run = self._run(True)
        with torch.enable_grad():
            outs, aux_updates = run(raw_args, raw_aux, self._device,
                                    hook=hook)
        self.cross_device_copies = run.copies
        return self._trained(outs, aux_updates, leaves)

    def _backward_terms(self, out_grads):
        """(outputs, head gradients, leaves, names) of the last training
        forward: the heads are ``out_grads`` (one per output) moved onto
        the outputs' device, or ones (a loss head ignores its own)."""
        names = self._grad_names()
        if not names:
            return [], [], [], []
        if self._tape is None:
            raise MXNetError("backward: call forward(is_train=True) first")
        outs, leaves = self._tape
        if out_grads is None:
            heads = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, (NDArray, torch.Tensor)):
                out_grads = [out_grads]
            heads = [getattr(g, "_data", g).to(o.device, o.dtype)
                     for g, o in zip(out_grads, outs)]
        pairs = [(o, g) for o, g in zip(outs, heads) if o.requires_grad]
        return ([o for o, _ in pairs], [g for _, g in pairs],
                [leaves[n] for n in names], names)

    def backward(self, out_grads=None):
        """Gradients of the last training forward into ``grad_dict``:
        written (``grad_req="write"``) or added (``"add"``) in place.
        ``out_grads`` are the head gradients, one per output; without
        them every head gets ones (a loss head ignores its own)."""
        with _tel.span("executor.backward", category="executor"):
            outs, heads, leaves, names = self._backward_terms(out_grads)
            if not names:
                return
            grads = [None] * len(names)
            if outs:
                if self._profiled:
                    # profiled forward ran node by node: the backward is
                    # one span that covers its device work
                    with _prof.scope("backward", category="backward"):
                        grads = torch.autograd.grad(outs, leaves, heads,
                                                    allow_unused=True)
                        if self._device.type == "cuda":
                            torch.cuda.synchronize(self._device)
                else:
                    grads = torch.autograd.grad(outs, leaves, heads,
                                                allow_unused=True)
            self._write_grads(names, grads)

    def _write_grads(self, names, grads):
        self._tape = None
        with torch.no_grad():
            for n, g in zip(names, grads):
                dst = self.grad_dict[n]._data
                if g is None:
                    if self.grad_req[n] == "write":
                        dst.zero_()
                elif self.grad_req[n] == "add":
                    dst.add_(g.to(dst.dtype))
                else:
                    dst.copy_(g)

    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self.arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self.arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self.aux_names]

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy ``arg_params`` (and ``aux_params``: NDArrays, tensors or
        numpy arrays) into the bound arrays of those names, in place on
        their devices. A name this executor does not bind raises unless
        ``allow_extra_params``."""
        for given, bound, what in ((arg_params, self.arg_dict, "arguments"),
                                   (aux_params or {}, self.aux_dict,
                                    "aux states")):
            for name, val in given.items():
                if name not in bound:
                    if not allow_extra_params:
                        raise MXNetError('Found name "%s" not in %s'
                                         % (name, what))
                    continue
                dst = bound[name]._data
                src = getattr(val, "_data", val)
                if not isinstance(src, torch.Tensor):
                    src = torch.as_tensor(src)
                with torch.no_grad():
                    dst.copy_(src.reshape(dst.shape))

    def set_monitor_callback(self, callback):
        """Install ``callback(name, NDArray)``, called with every op's
        visible outputs on each forward while it is active: one with an
        ``is_active`` attribute that returns False (a ``Monitor`` between
        its sampled batches) leaves that forward on the fused plan."""
        self._monitor_callback = callback

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new Executor at the input shapes ``kwargs``: each named input
        a new zero array (and a new gradient array where it has one),
        every other argument, gradient and aux array this one's, the same
        tensors. ``partial_shaping`` and ``allow_up_sizing`` are accepted
        as mxtpu accepts them."""
        del partial_shaping, allow_up_sizing
        args, grads = dict(self.arg_dict), dict(self.grad_dict)
        for name, shape in kwargs.items():
            if name not in args:
                continue
            old = args[name]
            args[name] = NDArray(torch.zeros(tuple(shape),
                                             dtype=old._data.dtype,
                                             device=old._data.device),
                                 old.context)
            if name in grads:
                grads[name] = NDArray(torch.zeros_like(args[name]._data),
                                      old.context)
        new = Executor(self._symbol, self._ctx, args, args_grad=grads,
                       grad_req=self.grad_req, aux_states=self.aux_dict,
                       group2ctx=self._group2ctx)
        new._train_program = self._train_program
        new._tap_filter = self._tap_filter
        return new

    @staticmethod
    def simple_bind(symbol, ctx=None, grad_req="write", type_dict=None,
                    shared_exec=None, shared_data_arrays=None, **kwargs):
        """``executor.simple_bind`` as mxtpu's static method."""
        del shared_data_arrays
        return simple_bind(symbol, ctx, grad_req=grad_req,
                           type_dict=type_dict, shared_exec=shared_exec,
                           **kwargs)

    @property
    def fused_sites(self):
        """How many BatchNorm -> ReLU pairs run as one epilogue launch."""
        return self._run(False).fused_sites


def forward_replicas(executors, layout=None, is_train=True):
    """A forward of ``executors`` (one symbol, each bound on its slice of
    the batch on its own device, its inputs loaded) as one function of
    the whole batch: the plan walked over the replicas in lockstep
    (``run.replicas``; ``layout``: the replicas hold blocks of split
    parameters). In training each executor keeps its tape for
    ``backward_replicas`` and its outputs, as its own ``forward``; at
    inference (``is_train=False``, the fused plan) only its outputs."""
    if len(executors) == 1 and layout is None:
        return [executors[0].forward(is_train)]
    with _tel.span("executor.forward", category="executor"):
        return _forward_replicas(executors, layout, is_train)


def _forward_replicas(executors, layout, is_train):
    devices = [ex._device for ex in executors]
    if not is_train:
        run = executors[0]._run(False)
        for ex in executors[1:]:
            ex._prepared_args = executors[0]._prepared_args
        ins = [ex._inputs({}) for ex in executors]
        with torch.inference_mode():
            outs, _ = run.replicas(
                [ex._inject_prepared(a) for ex, (a, _) in zip(executors, ins)],
                [x for _, x in ins], devices, layout=layout)
        for ex, o in zip(executors, outs):
            ex.outputs = [ex._wrap(t) for t in o]
            ex._account_outputs()
        return [ex.outputs for ex in executors]
    ins = [ex._train_inputs({}) for ex in executors]
    with torch.enable_grad():
        outs, updates = executors[0]._run(True).replicas(
            [a for a, _, _ in ins], [x for _, x, _ in ins], devices,
            hook=executors[0]._tap_hook(), layout=layout)
    return [ex._trained(o, u, leaves) for ex, o, u, (_, _, leaves)
            in zip(executors, outs, updates, ins)]


def backward_replicas(executors, out_grads=None):
    """The gradients of the last ``forward_replicas`` into every
    executor's ``grad_dict``: one ``torch.autograd.grad`` over every
    replica's heads and leaves, so the terms that cross replicas
    (BatchNorm's statistics) reach each replica's parameters.
    ``out_grads``: None, or one list of head gradients per executor."""
    if len(executors) == 1:
        executors[0].backward(None if out_grads is None else out_grads[0])
        return
    with _tel.span("executor.backward", category="executor"):
        _backward_replicas(executors, out_grads)


def _backward_replicas(executors, out_grads):
    terms = [ex._backward_terms(None if out_grads is None else out_grads[i])
             for i, ex in enumerate(executors)]
    outs = [o for t in terms for o in t[0]]
    heads = [h for t in terms for h in t[1]]
    leaves = [x for t in terms for x in t[2]]
    grads = [None] * len(leaves)
    if outs and leaves:
        grads = torch.autograd.grad(outs, leaves, heads, allow_unused=True)
    k = 0
    for ex, t in zip(executors, terms):
        names = t[3]
        if names:
            ex._write_grads(names, grads[k:k + len(names)])
        k += len(names)


def simple_bind(symbol, ctx=None, grad_req="write", type_dict=None,
                group2ctx=None, shared_exec=None, **shapes):
    """An Executor with zero arrays allocated from the shapes inferred
    from ``shapes`` (mxtpu/executor.py:857-906): each argument, gradient
    (where ``grad_req`` is not "null") and aux array is ``shared_exec``'s
    of that name and shape where it has one, else new, on the context of
    the variable's ``__ctx_group__`` under ``group2ctx``, else on ``ctx``.
    dtypes come from ``type_dict`` (default float32)."""
    ctx = as_context(ctx) if ctx is not None else current_context()
    arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
    type_dict = type_dict or {}
    arg_names = symbol.list_arguments()
    aux_names = symbol.list_auxiliary_states()
    if isinstance(grad_req, str):
        req_of = {n: grad_req for n in arg_names}
    elif isinstance(grad_req, (list, tuple)):
        req_of = dict(zip(arg_names, grad_req))
    else:
        req_of = {n: grad_req.get(n, "null") for n in arg_names}
    groups = {n.name: n._extra_attrs.get("__ctx_group__")
              for n in symbol._topo() if n.is_variable}
    home = {n: as_context((group2ctx or {}).get(groups.get(n), ctx))
            for n in arg_names + aux_names}

    def array(name, shape, shared):
        got = shared.get(name) if shared_exec is not None else None
        if got is not None and got.shape == tuple(shape):
            return got
        c = home[name]
        return NDArray(torch.zeros(tuple(shape), dtype=torch_dtype(
            type_dict.get(name, "float32")), device=c.torch_device), c)

    args = {n: array(n, s, getattr(shared_exec, "arg_dict", {}))
            for n, s in zip(arg_names, arg_shapes)}
    grads = {n: array(n, args[n].shape,
                      getattr(shared_exec, "grad_dict", {}))
             for n in arg_names if req_of.get(n, "null") != "null"}
    aux = {n: array(n, s, getattr(shared_exec, "aux_dict", {}))
           for n, s in zip(aux_names, aux_shapes)}
    return Executor(symbol, ctx, args, args_grad=grads, grad_req=req_of,
                    aux_states=aux, group2ctx=group2ctx)
