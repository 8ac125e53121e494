"""Gluon Block, HybridBlock and SymbolBlock.

Counterpart of ``mxtpu/gluon/block.py`` (``Block`` :95, ``HybridBlock``
:196, ``SymbolBlock`` :330) with its name scopes and prefixes.
``hybridize()`` traces ``hybrid_forward`` to a Symbol, as mxtpu does
(:220-233); where mxtpu wraps that trace into one jit-compiled OpDef
(:247-279), here a hybridized call runs the Symbol through the
executor's walk (``executor._trace_graph``), the plan ``Module`` runs.
The walk's inference plan fuses each BatchNorm->ReLU pair into the
epilogue kernel; its training plan (``autograd.is_training()``) fuses
nothing and returns the moving statistics, which are written back into
the aux Parameters in place. Under ``record()`` the walk runs under
torch's autograd, so gradients reach the Parameters (an inference plan
recorded in predict mode is left unfused: the epilogue kernel has no
gradient); outside it, under ``no_grad``.
"""
from __future__ import annotations

import threading

from .. import autograd
from .. import ndarray as nd
from .. import symbol as sym_mod
from ..base import MXNetError
from ..executor import _trace_graph
from ..ndarray import NDArray
from ..ops.registry import write_aux
from ..symbol import Symbol
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock"]


class _BlockScope:
    """Name scoping for blocks (parity block.py _BlockScope)."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = _name_counter(hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = "%s%d_" % (hint, count)
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        _BlockScope._current.value = self._old_scope


_global_counter = {}


def _name_counter(hint):
    count = _global_counter.get(hint, 0)
    _global_counter[hint] = count + 1
    return "%s%d" % (hint, count)


def _flatten(args):
    if isinstance(args, (NDArray, Symbol)):
        return [args], 0
    if not isinstance(args, (list, tuple)):
        raise MXNetError("HybridBlock input must be (nested) list of Symbol "
                         "or NDArray, got %s of type %s"
                         % (str(args), str(type(args))))
    flat, fmts = [], []
    for i in args:
        arg, fmt = _flatten(i)
        flat.extend(arg)
        fmts.append(fmt)
    return flat, fmts


def _regroup(args, fmt):
    if isinstance(fmt, int):
        if fmt == 0:
            return args[0], args[1:]
        return args[:fmt], args[fmt:]
    ret = []
    for i in fmt:
        res, args = _regroup(args, i)
        ret.append(res)
    return ret, args


class Block:
    """Base class for all layers and models (parity block.py:119)."""

    def __init__(self, prefix=None, params=None):
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = []

    def __repr__(self):
        s = "{name}(\n{modstr}\n)"
        modstr = "\n".join("  ({key}): {block}".format(
            key=key, block=repr(block).replace("\n", "\n  "))
            for key, block in self.__dict__.items()
            if isinstance(block, Block))
        return s.format(name=self.__class__.__name__, modstr=modstr)

    def __setattr__(self, name, value):
        if isinstance(value, Block):
            self.register_child(value)
        super().__setattr__(name, value)

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self):
        ret = ParameterDict(self._params.prefix)
        ret.update(self.params)
        for cld in self._children:
            ret.update(cld.collect_params())
        return ret

    def save_params(self, filename):
        self.collect_params().save(filename, strip_prefix=self.prefix)

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        self.collect_params().load(filename, ctx, allow_missing,
                                   ignore_extra, self.prefix)

    def register_child(self, block):
        self._children.append(block)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every Parameter on ``ctx`` (default: the current
        context, gpu(0) unless a ``with cpu():`` scope says otherwise)."""
        self.collect_params().initialize(init, ctx, verbose,
                                         force_reinit=force_reinit)

    def hybridize(self, active=True):
        for cld in self._children:
            cld.hybridize(active)

    def cast(self, dtype):
        for child in self._children:
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def __call__(self, *args):
        return self.forward(*args)

    def forward(self, *args):
        raise NotImplementedError


class HybridBlock(Block):
    """A Block that can be traced to a Symbol and run as one plan."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._reg_params = {}
        self._cached_graph = ()
        self._cached_plan = None
        self._active = False

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if isinstance(value, Parameter):
            self._reg_params[name] = value

    def register_child(self, block):
        if not isinstance(block, HybridBlock):
            raise ValueError(
                "Children of HybridBlock must also be HybridBlock, but %s has "
                "type %s." % (str(block), str(type(block))))
        super().register_child(block)
        self._cached_plan = None
        self._cached_graph = ()

    def hybridize(self, active=True, **kwargs):
        del kwargs  # mxtpu's CachedOp flags: the walk takes none
        self._active = active
        self._cached_plan = None
        super().hybridize(active)

    def cast(self, dtype):
        self._cached_plan = None
        super().cast(dtype)

    # ---------------------------------------- cached-graph machinery
    def _get_graph(self, *args):
        if not self._cached_graph:
            flat_args, self._in_format = _flatten(args)
            inputs = [sym_mod.var("data%d" % i) if len(flat_args) > 1
                      else sym_mod.var("data")
                      for i in range(len(flat_args))]
            grouped, _ = _regroup(inputs, self._in_format)
            params = {i: j.var() for i, j in self._reg_params.items()}
            with self.name_scope():
                out = self.hybrid_forward(sym_mod, grouped, **params) \
                    if not isinstance(grouped, list) else \
                    self.hybrid_forward(sym_mod, *grouped, **params)
            out_flat, self._out_format = _flatten(out)
            self._cached_graph = inputs, sym_mod.Group(out_flat)
        return self._cached_graph

    def infer_shape(self, *args):
        """Infer (deferred) parameter shapes from input shapes."""
        inputs, out = self._get_graph(*args)
        flat_args, _ = _flatten(args)
        shape_hints = {i.name: j.shape for i, j in zip(inputs, flat_args)}
        arg_shapes, _, aux_shapes = out.infer_shape(**shape_hints)
        sdict = dict(zip(out.list_arguments(), arg_shapes))
        sdict.update(zip(out.list_auxiliary_states(), aux_shapes))
        for _, param in self.collect_params().items():
            if param.name in sdict:
                param.shape = tuple(sdict[param.name])

    def _build_plan(self, args):
        """Where each argument of the traced Symbol comes from: an input
        of the call or a Parameter; the walk's plans are made lazily:
        training, inference, and inference unfused (recorded)."""
        inputs, out = self._get_graph(*args)
        input_names = [i.name for i in inputs]
        params = {p.name: p for _, p in self.collect_params().items()}
        sources = []
        for name in out.list_arguments() + out.list_auxiliary_states():
            if name in input_names:
                sources.append((name, "input", input_names.index(name)))
            elif name in params:
                sources.append((name, "param", params[name]))
            else:
                raise MXNetError("hybridized %s: argument '%s' is neither an "
                                 "input nor a Parameter" % (self.name, name))
        self._cached_plan = {"symbol": out, "sources": sources,
                             "aux": set(out.list_auxiliary_states()),
                             "runs": {}}

    def _plan_run(self, is_train, fuse):
        runs = self._cached_plan["runs"]
        key = (is_train, fuse and not is_train)
        if key not in runs:
            runs[key] = _trace_graph(self._cached_plan["symbol"], *key)
        return runs[key]

    @property
    def fused_sites(self):
        """BatchNorm->ReLU pairs the hybridized inference plan runs as one
        epilogue launch each (0 before the first hybridized call)."""
        if self._cached_plan is None:
            return 0
        return self._plan_run(False, True).fused_sites

    def _call_cached_op(self, *args):
        if self._cached_plan is None:
            self._build_plan(args)
        plan = self._cached_plan
        flat_args, _ = _flatten(args)
        arrays, arg_vals, aux_vals = [], {}, {}
        for name, kind, src in plan["sources"]:
            arr = flat_args[src] if kind == "input" else src.data()
            arrays.append(arr)
            (aux_vals if name in plan["aux"] else arg_vals)[name] = arr._data
        is_train = autograd.is_training()
        run = self._plan_run(is_train, not autograd.is_recording())
        with autograd.grad_mode():
            outs, aux_updates = run(arg_vals, aux_vals)
        write_aux(aux_vals, aux_updates)
        ctx = flat_args[0].context
        out_arrays = [NDArray(o, ctx) for o in outs]
        if autograd.is_recording():
            autograd.record_arrays(arrays, out_arrays)
        ret, _ = _regroup(out_arrays, self._out_format)
        return ret

    def _deferred(self, call, x, *args):
        try:
            return call()
        except DeferredInitializationError:
            self.infer_shape(x, *args)
            for _, p in self.collect_params().items():
                p._finish_deferred_init()
            return call()

    def forward(self, x, *args):
        """Dispatch: NDArray -> imperative or the cached plan; Symbol ->
        compose."""
        if isinstance(x, NDArray):
            if self._active:
                return self._deferred(
                    lambda: self._call_cached_op(x, *args), x, *args)

            def imperative():
                params = {i: j.data(x.context)
                          for i, j in self._reg_params.items()}
                return self.hybrid_forward(nd, x, *args, **params)

            return self._deferred(imperative, x, *args)
        if not isinstance(x, Symbol):
            raise MXNetError("HybridBlock requires the first argument to "
                             "forward be either Symbol or NDArray, but got "
                             "%s" % type(x))
        params = {i: j.var() for i, j in self._reg_params.items()}
        with self.name_scope():
            return self.hybrid_forward(sym_mod, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class SymbolBlock(HybridBlock):
    """Wrap a Symbol and its input variables as a block (parity
    block.py:452): every other argument and aux state becomes a
    Parameter named as the variable."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix=None, params=params)
        self._prefix = ""
        self._params = ParameterDict("", params)
        if isinstance(inputs, Symbol) and len(inputs.list_outputs()) == 1:
            inputs = [inputs]
        if isinstance(outputs, (list, tuple)) and len(outputs) == 1 and \
                isinstance(outputs[0], list):
            outputs = outputs[0]
        out = sym_mod.Group(outputs) if isinstance(outputs, (list, tuple)) \
            else outputs
        input_names = set()
        for i in inputs:
            if len(i.list_outputs()) != 1:
                raise MXNetError("Input symbols must be variable, but %s is "
                                 "an output of operators" % str(i))
            input_names.add(i.name)
        for i in out.list_arguments():
            if i not in input_names:
                self.params.get(i, allow_deferred_init=True)
        for i in out.list_auxiliary_states():
            if i not in input_names:
                self.params.get(i, allow_deferred_init=True,
                                grad_req="null")
        self._cached_graph = list(inputs), out
        self._in_format = [0] * len(inputs) if len(inputs) > 1 else 0
        n_out = len(out.list_outputs())
        self._out_format = [0] * n_out if n_out > 1 else 0
        self._reg_params = {}

    def forward(self, x, *args):
        if isinstance(x, NDArray):
            return self._deferred(lambda: self._call_cached_op(x, *args),
                                  x, *args)
        raise MXNetError("SymbolBlock symbolic forward not supported")

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
