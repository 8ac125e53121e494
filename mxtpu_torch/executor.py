"""Executor: runs a bound Symbol as an eager walk of torch ops.

Counterpart of ``mxtpu/executor.py``: the topo walk of ``_trace_graph``
(:120-209) and ``Executor.forward(is_train=False)`` (:670). The JAX
package traces the walk into one jitted XLA program; here it runs
eagerly under ``torch.inference_mode()``, and each op's kernels launch
asynchronously on the device's current stream. Only inference is
ported: training (``is_train=True``, backward) arrives in a later slice.
"""
from __future__ import annotations

import torch

from .base import MXNetError
from .context import as_context, current_context
from .ndarray import NDArray

__all__ = ["Executor"]


def _trace_graph(symbol, is_train):
    """Return ``run(arg_vals, aux_vals) -> outputs`` for ``symbol``.

    The plan (topo order, parsed attrs, input slots) is built once here,
    so a forward only walks a list."""
    topo = symbol._topo()
    aux_nodes = symbol._aux_node_set()
    plan = []
    for node in topo:
        if node.is_variable:
            plan.append((node, None, None, None))
            continue
        attrs = node.parsed_attrs()
        if "__is_train__" in node.op.attrs_spec:
            attrs = type(attrs)(attrs)
            attrs["__is_train__"] = is_train
        ins = [(id(n), i) for n, i in node.inputs]
        plan.append((node, attrs, ins, node.op.n_out(attrs)))
    out_entries = [(id(n), i) for n, i in symbol._outputs]

    def run(arg_vals, aux_vals):
        env = {}
        for node, attrs, ins, n_vis in plan:
            if attrs is None:
                src = aux_vals if id(node) in aux_nodes else arg_vals
                env[(id(node), 0)] = src[node.name]
                continue
            outs = node.op.apply(attrs, [env[k] for k in ins])
            for i in range(n_vis):
                env[(id(node), i)] = outs[i]
        return [env[e] for e in out_entries]

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
