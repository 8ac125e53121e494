"""Executor: runs a bound Symbol as an eager walk of torch ops.

Counterpart of ``mxtpu/executor.py``: the topo walk of ``_trace_graph``
(:120-209) and ``Executor.forward(is_train=False)`` (:670). The JAX
package traces the walk into one jitted XLA program; here it runs
eagerly under ``torch.inference_mode()``, and each op's kernels launch
asynchronously on the device's current stream. Where XLA fuses an
inference BatchNorm with its ReLU, the plan runs the pair as one pass of
the epilogue kernel (``ops/epilogue.py``), on every device. Only
inference is ported: training (``is_train=True``, backward) arrives in a
later slice.
"""
from __future__ import annotations

import torch

from .base import MXNetError
from .context import as_context, current_context
from .ndarray import NDArray
from .ops.nn import bn_relu_inference

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


def _trace_graph(symbol, is_train):
    """Return ``run(arg_vals, aux_vals) -> outputs`` for ``symbol``.

    The plan (topo order, parsed attrs, input slots) is built once here,
    so a forward only walks a list. At inference each fusable
    ``BatchNorm -> Activation(relu)`` pair (``_fusable_bn``) becomes one
    step, ``nn.bn_relu_inference``, that writes the ReLU's output slot:
    the executor's counterpart of the fusion XLA builds for the JAX
    package. ``run.fused_sites`` counts those pairs."""
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
            plan.append((node, None, None, None, None))
            continue
        if id(node) in fused_into:
            continue
        attrs = node.parsed_attrs()
        if "__is_train__" in node.op.attrs_spec:
            attrs = type(attrs)(attrs)
            attrs["__is_train__"] = is_train
        ins = [(id(n), i) for n, i in node.inputs]
        relu = None if is_train else _fusable_bn(node, consumers,
                                                 graph_outputs)
        if relu is not None:
            fused_into.add(id(relu))
            plan.append((node, attrs, ins, 1, (id(relu), 0)))
        else:
            plan.append((node, attrs, ins, node.op.n_out(attrs), None))
    out_entries = [(id(n), i) for n, i in symbol._outputs]

    def run(arg_vals, aux_vals):
        env = {}
        for node, attrs, ins, n_vis, fused_out in plan:
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
        return [env[e] for e in out_entries]

    run.fused_sites = len(fused_into)
    return run


class Executor:
    """Bound computation on one device context."""

    def __init__(self, symbol, ctx, args, aux_states=None):
        self._symbol = symbol
        self._ctx = as_context(ctx) if ctx is not None else current_context()
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()
        self.arg_dict = self._as_dict(args, self.arg_names, "args")
        self.aux_dict = self._as_dict(aux_states or {}, self.aux_names,
                                      "aux_states")
        self.outputs = []
        self._run = None

    @staticmethod
    def _as_dict(vals, names, what):
        out = dict(vals) if isinstance(vals, dict) else dict(zip(names, vals))
        for n in names:
            if n not in out:
                raise MXNetError("%s: missing array for '%s'" % (what, n))
        return out

    def forward(self, is_train=False, **kwargs):
        """Run the graph; returns the list of output NDArrays."""
        if is_train:
            raise MXNetError("Executor.forward(is_train=True): training is "
                             "not ported yet")
        for k, v in kwargs.items():
            if k in self.arg_dict:
                self.arg_dict[k][:] = v
        if self._run is None:
            self._run = _trace_graph(self._symbol, is_train=False)
        raw_args = {n: self.arg_dict[n]._data for n in self.arg_names}
        raw_aux = {n: self.aux_dict[n]._data for n in self.aux_names}
        with torch.inference_mode():
            outs = self._run(raw_args, raw_aux)
        self.outputs = [NDArray(o, self._ctx) for o in outs]
        return self.outputs

    @property
    def fused_sites(self):
        """How many BatchNorm -> ReLU pairs run as one epilogue launch."""
        if self._run is None:
            self._run = _trace_graph(self._symbol, is_train=False)
        return self._run.fused_sites
