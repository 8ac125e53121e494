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

import torch

from .base import MXNetError
from .context import as_context, current_context
from .ndarray import NDArray
from .ops.nn import bn_relu_inference
from .ops.registry import torch_dtype, write_aux

__all__ = ["Executor", "simple_bind", "forward_replicas",
           "backward_replicas", "eager_run_range"]


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
                 default_device=None):
    """Return ``run(arg_vals, aux_vals) -> (outputs, aux_updates)`` for
    ``symbol``; ``aux_updates`` maps an aux variable's name to the value
    the op it feeds computed for it in a training run (later writers
    win), and is empty at inference.

    The plan (topo order, parsed attrs, input slots) is built once here,
    so a forward only walks a list. At inference each fusable
    ``BatchNorm -> Activation(relu)`` pair (``_fusable_bn``) becomes one
    step, ``nn.bn_relu_inference``, that writes the ReLU's output slot:
    the executor's counterpart of the fusion XLA builds for the JAX
    package. ``run.fused_sites`` counts those pairs; ``run.replicas``
    walks the plan over several replicas in lockstep
    (``forward_replicas``). ``fuse=False`` keeps
    an inference plan unfused, for a caller that differentiates it (the
    epilogue kernel has no gradient); training plans never fuse.

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
    fused_into = set()  # ids of the Activation nodes folded into a BN step
    plan = []
    placements = placements or {}
    for node in topo:
        if node.is_variable:
            plan.append((node, None, None, None, None, (), None))
            continue
        if id(node) in fused_into:
            continue
        attrs = node.parsed_attrs()
        if "__is_train__" in node.op.attrs_spec:
            attrs = type(attrs)(attrs)
            attrs["__is_train__"] = is_train
        ins = [(id(n), i) for n, i in node.inputs]
        dev = placements.get(node._extra_attrs.get("__ctx_group__"),
                             default_device) if placements else None
        relu = _fusable_bn(node, consumers, graph_outputs) \
            if fuse else None
        if relu is not None:
            fused_into.add(id(relu))
            plan.append((node, attrs, ins, 1, (id(relu), 0), (), dev))
        else:
            aux = _aux_sources(node, attrs) \
                if is_train and node.op.aux_names else ()
            plan.append((node, attrs, ins, node.op.n_out(attrs), None, aux,
                         dev))
    out_entries = [(id(n), i) for n, i in symbol._outputs]

    def run_replicas(arg_list, aux_list, devices=None, hook=None):
        """The plan over replicas in lockstep, one value set per replica
        (one: the plain walk): ([outputs of each], [aux_updates of
        each]). Over several, each op runs by its ``replica_mode``.
        ``devices``: each replica's device, for the ops with no tensor
        inputs (default: each replica's first argument's). ``hook(node,
        n_vis, outputs)`` sees each unfused op step's outputs (the first
        replica's)."""
        if placements and len(arg_list) > 1:
            raise MXNetError("group2ctx placement runs one replica")
        if devices is None:
            devices = [next((t.device for t in args.values()),
                            torch.device("cpu")) for args in arg_list]
        envs = [{} for _ in arg_list]
        updates = [{} for _ in arg_list]
        copies = 0
        for node, attrs, ins, n_vis, fused_out, aux, dev in plan:
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
            if fused_out is not None:
                for env, x in zip(envs, inputs):
                    env[fused_out] = bn_relu_inference(attrs, *x)
                continue
            mode = "rows" if len(envs) == 1 else node.op.replica_mode(
                attrs, inputs[0][0].ndim if inputs[0] else 0)
            if mode == "rows":
                outs = [node.op.apply(attrs, x, dev or d)
                        for x, d in zip(inputs, devices)]
            elif mode == "group":
                outs = node.op.group_fn(attrs, inputs)
            else:
                raise MXNetError(
                    "%s '%s' couples rows of the batch and has no form "
                    "over replicas: this graph cannot train on several "
                    "contexts as one batch" % (node.op.name, node.name))
            for env, upd, o in zip(envs, updates, outs):
                for i in range(n_vis):
                    env[(id(node), i)] = o[i]
                for j, name in aux:
                    upd[name] = o[n_vis + j]
            if hook is not None:
                hook(node, n_vis, outs[0])
        run.copies = copies
        return [[env[e] for e in out_entries] for env in envs], updates

    def run(arg_vals, aux_vals, device=None, hook=None):
        outs, updates = run_replicas([arg_vals], [aux_vals],
                                     None if device is None else [device],
                                     hook=hook)
        return outs[0], updates[0]

    run.fused_sites = len(fused_into)
    run.replicas = run_replicas
    run.copies = 0
    return run


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
        self._tape = None   # (outputs with their graph, {name: leaf})
        self._monitor_callback = None

    @staticmethod
    def _as_dict(vals, names, what, allow_missing=False):
        out = dict(vals) if isinstance(vals, dict) else dict(zip(names, vals))
        out = {k: v for k, v in out.items() if v is not None}
        if not allow_missing:
            for n in names:
                if n not in out:
                    raise MXNetError("%s: missing array for '%s'" % (what, n))
        return out

    def _run(self, is_train, fuse=True):
        key = (is_train, fuse and not is_train)
        run = self._runs.get(key)
        if run is None:
            run = self._runs[key] = _trace_graph(
                self._symbol, is_train, fuse=fuse,
                placements=self._placements, default_device=self._device)
        return run

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
        return self.outputs

    def forward(self, is_train=False, **kwargs):
        """Run the graph; returns the list of output NDArrays. With
        ``is_train`` the run keeps its autograd graph for ``backward``.
        With an active monitor callback every op's outputs reach it, the
        inference walk unfused."""
        hook = self._monitor_hook()
        if not is_train:
            raw_args, raw_aux = self._inputs(kwargs)
            run = self._run(False, fuse=hook is None)
            with torch.inference_mode():
                outs, _ = run(raw_args, raw_aux, self._device, hook=hook)
            self.cross_device_copies = run.copies
            self.outputs = [self._wrap(o) for o in outs]
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
        outs, heads, leaves, names = self._backward_terms(out_grads)
        if not names:
            return
        grads = [None] * len(names)
        if outs:
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
            args[name] = NDArray(torch.zeros(tuple(shape), dtype=old.dtype,
                                             device=old._data.device),
                                 old.context)
            if name in grads:
                grads[name] = NDArray(torch.zeros_like(args[name]._data),
                                      old.context)
        return Executor(self._symbol, self._ctx, args, args_grad=grads,
                        grad_req=self.grad_req, aux_states=self.aux_dict,
                        group2ctx=self._group2ctx)

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


def forward_replicas(executors):
    """A training forward of ``executors`` (one symbol, each bound on its
    slice of the batch on its own device, its inputs loaded) as one
    function of the whole batch: the plan walked over the replicas in
    lockstep (``run.replicas``). Each executor keeps its tape for
    ``backward_replicas`` and its outputs, as its own ``forward``."""
    if len(executors) == 1:
        return [executors[0].forward(True)]
    ins = [ex._train_inputs({}) for ex in executors]
    with torch.enable_grad():
        outs, updates = executors[0]._run(True).replicas(
            [a for a, _, _ in ins], [x for _, x, _ in ins],
            [ex._device for ex in executors])
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
