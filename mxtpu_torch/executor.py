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
"""
from __future__ import annotations

import torch

from .base import MXNetError
from .context import as_context, current_context
from .ndarray import NDArray
from .ops.nn import bn_relu_inference
from .ops.registry import write_aux

__all__ = ["Executor"]


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


def _trace_graph(symbol, is_train, fuse=True):
    """Return ``run(arg_vals, aux_vals) -> (outputs, aux_updates)`` for
    ``symbol``; ``aux_updates`` maps an aux variable's name to the value
    the op it feeds computed for it in a training run (later writers
    win), and is empty at inference.

    The plan (topo order, parsed attrs, input slots) is built once here,
    so a forward only walks a list. At inference each fusable
    ``BatchNorm -> Activation(relu)`` pair (``_fusable_bn``) becomes one
    step, ``nn.bn_relu_inference``, that writes the ReLU's output slot:
    the executor's counterpart of the fusion XLA builds for the JAX
    package. ``run.fused_sites`` counts those pairs. ``fuse=False`` keeps
    an inference plan unfused, for a caller that differentiates it (the
    epilogue kernel has no gradient); training plans never fuse."""
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
    for node in topo:
        if node.is_variable:
            plan.append((node, None, None, None, None, ()))
            continue
        if id(node) in fused_into:
            continue
        attrs = node.parsed_attrs()
        if "__is_train__" in node.op.attrs_spec:
            attrs = type(attrs)(attrs)
            attrs["__is_train__"] = is_train
        ins = [(id(n), i) for n, i in node.inputs]
        relu = _fusable_bn(node, consumers, graph_outputs) \
            if fuse else None
        if relu is not None:
            fused_into.add(id(relu))
            plan.append((node, attrs, ins, 1, (id(relu), 0), ()))
        else:
            aux = _aux_sources(node, attrs) \
                if is_train and node.op.aux_names else ()
            plan.append((node, attrs, ins, node.op.n_out(attrs), None, aux))
    out_entries = [(id(n), i) for n, i in symbol._outputs]

    def run(arg_vals, aux_vals):
        env = {}
        aux_updates = {}
        for node, attrs, ins, n_vis, fused_out, aux in plan:
            if attrs is None:
                src = aux_vals if id(node) in aux_nodes else arg_vals
                env[(id(node), 0)] = src[node.name]
            elif fused_out is not None:
                env[fused_out] = bn_relu_inference(
                    attrs, *[env[k] for k in ins])
            else:
                outs = node.op.apply(attrs, [env[k] for k in ins])
                for i in range(n_vis):
                    env[(id(node), i)] = outs[i]
                for j, name in aux:
                    aux_updates[name] = outs[n_vis + j]
        return [env[e] for e in out_entries], aux_updates

    run.fused_sites = len(fused_into)
    return run


class Executor:
    """Bound computation on one device context."""

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None):
        self._symbol = symbol
        self._ctx = as_context(ctx) if ctx is not None else current_context()
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
        self._runs = {}     # is_train -> the plan's run function
        self._tape = None   # (outputs with their graph, {name: leaf})

    @staticmethod
    def _as_dict(vals, names, what, allow_missing=False):
        out = dict(vals) if isinstance(vals, dict) else dict(zip(names, vals))
        out = {k: v for k, v in out.items() if v is not None}
        if not allow_missing:
            for n in names:
                if n not in out:
                    raise MXNetError("%s: missing array for '%s'" % (what, n))
        return out

    def _run(self, is_train):
        run = self._runs.get(is_train)
        if run is None:
            run = self._runs[is_train] = _trace_graph(self._symbol, is_train)
        return run

    def _grad_names(self):
        return [n for n in self.arg_names
                if self.grad_req.get(n, "null") != "null"
                and n in self.grad_dict]

    def forward(self, is_train=False, **kwargs):
        """Run the graph; returns the list of output NDArrays. With
        ``is_train`` the run keeps its autograd graph for ``backward``."""
        for k, v in kwargs.items():
            if k in self.arg_dict:
                self.arg_dict[k][:] = v
        raw_args = {n: self.arg_dict[n]._data for n in self.arg_names}
        raw_aux = {n: self.aux_dict[n]._data for n in self.aux_names}
        self._tape = None
        if not is_train:
            with torch.inference_mode():
                outs, _ = self._run(False)(raw_args, raw_aux)
            self.outputs = [NDArray(o, self._ctx) for o in outs]
            return self.outputs
        leaves = {}
        for n in self._grad_names():
            leaves[n] = raw_args[n] = raw_args[n].detach().requires_grad_()
        with torch.enable_grad():
            outs, aux_updates = self._run(True)(raw_args, raw_aux)
        write_aux({n: a._data for n, a in self.aux_dict.items()},
                  aux_updates)
        self._tape = (outs, leaves)
        self.outputs = [NDArray(o.detach(), self._ctx) for o in outs]
        return self.outputs

    def backward(self, out_grads=None):
        """Gradients of the last training forward into ``grad_dict``:
        written (``grad_req="write"``) or added (``"add"``) in place.
        ``out_grads`` are the head gradients, one per output; without
        them every head gets ones (a loss head ignores its own)."""
        names = self._grad_names()
        if not names:
            return
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
        grads = [None] * len(names)
        if pairs:
            grads = torch.autograd.grad(
                [o for o, _ in pairs], [leaves[n] for n in names],
                [g for _, g in pairs], allow_unused=True)
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
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self.arg_names]

    @property
    def fused_sites(self):
        """How many BatchNorm -> ReLU pairs run as one epilogue launch."""
        return self._run(False).fused_sites
