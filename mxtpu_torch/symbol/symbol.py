"""Symbol: the declarative graph IR.

Counterpart of ``mxtpu/symbol/symbol.py``: ``Symbol`` (:95) with its
output access (:161-176) and ``attr`` (:196), ``bind`` and
``simple_bind`` (:373-386, with ``group2ctx``), shape inference (:496),
``Variable`` (:622, with the scoped attrs of ``attribute.AttrScope``),
``Group`` (:648) and ``load_json`` (:705). The JSON schema is the same, so a graph serialized
by either package loads in the other. Shape inference runs each op on
meta tensors (``OpDef.infer``) instead of ``jax.eval_shape``. The
inspection surface: ``get_internals`` (:178, aux-update outputs hidden),
``get_children``, ``list_inputs``, ``list_attr``, ``infer_shape_partial``
(:327), ``infer_type`` (:356, numpy dtypes, propagated forward as
mxtpu's types-only walk does), ``eval`` (:388), ``grad`` (:392, raises)
and ``debug_str`` (:450). ``lint`` runs mxtpu's analysis passes, which
are not ported.
"""
from __future__ import annotations

import ast
import json
import threading

import numpy as _np
import torch

from ..attribute import AttrScope
from ..base import MXNetError, attr_repr
from ..ops.registry import get_op, op_exists, torch_dtype

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "NameManager"]


class NameManager:
    """Auto-names composed ops per thread: fullyconnected0,
    fullyconnected1, ... (an explicit name wins). Instances are context
    managers, as mxtpu's are (mxtpu/symbol/symbol.py:24-67): entering one
    scopes the auto-naming to its counter, and ``name.Prefix`` prepends
    a string (``with mx.name.Prefix('net_'):``)."""

    _tls = threading.local()

    def __init__(self):
        self._counter = {}
        self._prev = []  # a stack: re-entering one instance nests

    def _name(self, name, hint):
        if name:
            return name
        idx = self._counter.get(hint, 0)
        self._counter[hint] = idx + 1
        return "%s%d" % (hint, idx)

    def __enter__(self):
        self._prev.append(getattr(NameManager._tls, "current", None))
        NameManager._tls.current = self
        return self

    def __exit__(self, *exc):
        NameManager._tls.current = self._prev.pop()
        return False

    @classmethod
    def _current(cls):
        cur = getattr(cls._tls, "current", None)
        if cur is None:
            cur = cls._tls.current = NameManager()
        return cur

    @classmethod
    def get(cls, name, hint):
        return cls._current()._name(name, hint)

    @classmethod
    def reset(cls):
        cls._current()._counter = {}


class _Node:
    __slots__ = ("op", "name", "attrs", "inputs", "_extra_attrs")

    def __init__(self, op, name, attrs, inputs):
        self.op = op  # OpDef, or None for variables
        self.name = name
        self.attrs = dict(attrs)  # raw attr values (pre-parse)
        self.inputs = list(inputs)  # list of (node, out_index)
        self._extra_attrs = {}  # dunder attrs such as __shape__

    @property
    def is_variable(self):
        return self.op is None

    def parsed_attrs(self):
        return self.op.parse_attrs(self.attrs)


class Symbol:
    """A (possibly multi-output) symbolic expression: list of node entries."""

    def __init__(self, outputs):
        self._outputs = list(outputs)  # list of (node, out_index)

    def _topo(self):
        order = []
        seen = set()

        def visit(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for n, _ in node.inputs:
                visit(n)
            order.append(node)

        for n, _ in self._outputs:
            visit(n)
        return order

    def _aux_node_set(self):
        """Variable nodes wired into aux slots of any op."""
        aux = set()
        for node in self._topo():
            if node.op is None or not node.op.aux_names:
                continue
            names = node.op.input_names(node.parsed_attrs())
            for i, (inode, _) in enumerate(node.inputs):
                if i < len(names) and names[i] in node.op.aux_names \
                        and inode.is_variable:
                    aux.add(id(inode))
        return aux

    def list_arguments(self):
        aux = self._aux_node_set()
        return [n.name for n in self._topo()
                if n.is_variable and id(n) not in aux]

    def list_auxiliary_states(self):
        aux = self._aux_node_set()
        return [n.name for n in self._topo()
                if n.is_variable and id(n) in aux]

    def list_inputs(self):
        """Every variable (arguments and auxiliary states), in topological
        order."""
        return [n.name for n in self._topo() if n.is_variable]

    def list_outputs(self):
        out = []
        for node, idx in self._outputs:
            if node.is_variable:
                out.append(node.name)
            else:
                names = _output_names(node,
                                      node.op.n_out(node.parsed_attrs()))
                out.append(names[idx] if idx < len(names) else
                           "%s_output%d" % (node.name, idx))
        return out

    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    # ------------------------------------------------ access
    def __getitem__(self, index):
        """One output, by position or by its name in ``list_outputs``."""
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError("output %s not found" % index)
            index = names.index(index)
        if isinstance(index, int):
            return Symbol([self._outputs[index]])
        raise TypeError(index)

    def __len__(self):
        return len(self._outputs)

    def __iter__(self):
        for i in range(len(self._outputs)):
            yield self[i]

    def get_internals(self):
        """Every node's visible outputs (variables too) as one Symbol, in
        topological order; an op's updated aux values stay hidden."""
        entries = []
        for node in self._topo():
            n_vis = 1 if node.is_variable else \
                node.op.n_out(node.parsed_attrs())
            entries.extend((node, i) for i in range(n_vis))
        return Symbol(entries)

    def get_children(self):
        """The head node's inputs as one Symbol, or None for a
        variable."""
        node = self._outputs[0][0]
        if not node.inputs:
            return None
        return Symbol(list(node.inputs))

    def attr(self, key):
        """The head node's attribute ``key`` (a scoped or dunder attr
        first), or None."""
        node = self._outputs[0][0]
        v = node._extra_attrs.get(key)
        if v is None:
            v = node.attrs.get(key)
        return v

    def list_attr(self, recursive=False):
        """The head node's attributes as strings (its op attrs, then its
        scoped and dunder attrs); ``recursive=True`` raises, as the
        reference deprecated it for ``attr_dict``."""
        if recursive:
            raise MXNetError(
                "list_attr(recursive=True) is deprecated; use attr_dict()")
        node = self._outputs[0][0]
        out = {k: attr_repr(v) for k, v in node.attrs.items()
               if not k.startswith("__")}
        out.update(node._extra_attrs)
        return out


    # ------------------------------------------------ arithmetic sugar
    # (mxtpu/symbol/symbol.py:233-315): a Symbol operand composes the
    # elementwise op, a number the scalar op; comparisons build 0/1 masks
    def _binop(self, other, op, scalar_op):
        if isinstance(other, Symbol):
            return _compose(get_op(op), None, [self, other], {})
        return _compose(get_op(scalar_op), None, [self],
                        {"scalar": float(other)})

    def _rscalar(self, other, scalar_op):
        return _compose(get_op(scalar_op), None, [self],
                        {"scalar": float(other)})

    def __add__(self, o):
        return self._binop(o, "_plus", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, "_minus", "_minus_scalar")

    def __rsub__(self, o):
        return self._rscalar(o, "_rminus_scalar")

    def __mul__(self, o):
        return self._binop(o, "_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, "_div", "_div_scalar")

    __div__ = __truediv__

    def __rtruediv__(self, o):
        return self._rscalar(o, "_rdiv_scalar")

    __rdiv__ = __rtruediv__

    def __pow__(self, o):
        return self._binop(o, "_power", "_power_scalar")

    def __rpow__(self, o):
        return self._rscalar(o, "_rpower_scalar")

    def __neg__(self):
        return _compose(get_op("negative"), None, [self], {})

    def __gt__(self, o):
        return self._binop(o, "broadcast_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binop(o, "broadcast_greater_equal",
                           "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binop(o, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binop(o, "broadcast_lesser_equal",
                           "_lesser_equal_scalar")

    def __eq__(self, o):
        # a scalar builds the mask; Symbol == Symbol stays identity, as
        # symbols are dict keys and set members throughout
        if isinstance(o, (int, float)) and not isinstance(o, bool):
            return self._binop(o, "broadcast_equal", "_equal_scalar")
        return NotImplemented

    def __ne__(self, o):
        if isinstance(o, (int, float)) and not isinstance(o, bool):
            return self._binop(o, "broadcast_not_equal",
                               "_not_equal_scalar")
        return NotImplemented

    __hash__ = object.__hash__

    def __repr__(self):
        return "<Symbol %s>" % (self.name or ",".join(self.list_outputs()))

    # ------------------------------------------------ inference
    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) from known input shapes."""
        return self._infer_shape(False, args, kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        """As ``infer_shape``, with None for every shape the known ones do
        not determine (a node missing an input shape is skipped)."""
        return self._infer_shape(True, args, kwargs)

    def _infer_shape(self, partial, args, kwargs):
        arg_names = self.list_arguments()
        known = {}
        for n, s in zip(arg_names, args):
            if s is not None:
                known[n] = tuple(s)
        known.update({k: tuple(v) for k, v in kwargs.items()
                      if v is not None})
        shapes, _ = _infer_graph(self, known, partial=partial)
        arg_shapes = [shapes.get(n) for n in arg_names]
        if not partial:
            for n, s in zip(arg_names, arg_shapes):
                if s is None:
                    raise MXNetError("infer_shape: cannot infer the shape "
                                     "of argument '%s'; pass it" % n)
        out_shapes = [shapes.get(_entry_key(e)) for e in self._outputs]
        aux_shapes = [shapes.get(n) for n in self.list_auxiliary_states()]
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, *args, **kwargs):
        """(arg_types, out_types, aux_types) as numpy dtypes from known
        input types (positional in ``list_arguments`` order, or by name):
        a variable takes its hint or its ``__dtype__``; an op takes its
        ``dtype`` attr, else its first known input's type, and gives it
        to its still-untyped variable inputs and to its outputs (mxtpu's
        types-only walk); what nothing determines is None."""
        arg_names = self.list_arguments()
        known = {}
        for n, t in zip(arg_names, args):
            if t is not None:
                known[n] = _np.dtype(t)
        known.update({k: _np.dtype(v) for k, v in kwargs.items()})
        dtypes = _infer_types(self, known)
        return ([dtypes.get(n) for n in arg_names],
                [dtypes[_entry_key(e)] for e in self._outputs],
                [dtypes.get(n) for n in self.list_auxiliary_states()])

    def attr_dict(self):
        """``{variable name: {attr: string}}`` of the variables that carry
        attributes (``__lr_mult__``, ``__wd_mult__``, ``__init__``...)."""
        return {n.name: {k: str(v) for k, v in n._extra_attrs.items()}
                for n in self._topo() if n.is_variable and n._extra_attrs}

    # ------------------------------------------------ bind
    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        """An Executor over ``args``; ``args_grad`` (a dict or list of
        NDArrays) receives the gradients of ``backward`` per
        ``grad_req`` (write/add/null). ``group2ctx`` maps a
        ``__ctx_group__`` name to the context its nodes compute on.
        ``shared_exec`` is accepted as mxtpu accepts it: the arrays the
        caller passes are the ones shared."""
        from ..executor import Executor
        del shared_exec
        return Executor(self, ctx, args, args_grad=args_grad,
                        grad_req=grad_req, aux_states=aux_states,
                        group2ctx=group2ctx)

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    group2ctx=None, shared_exec=None,
                    shared_data_arrays=None, **kwargs):
        """An Executor with arrays allocated from the shapes inferred from
        ``kwargs`` (``executor.simple_bind``)."""
        from ..executor import simple_bind
        del shared_data_arrays
        return simple_bind(self, ctx, grad_req=grad_req, type_dict=type_dict,
                           group2ctx=group2ctx, shared_exec=shared_exec,
                           **kwargs)

    def eval(self, ctx=None, **kwargs):
        """Bind ``kwargs`` (every argument, as NDArrays) on ``ctx`` and
        run the inference forward; returns its outputs."""
        return self.bind(ctx, kwargs).forward()

    def grad(self, wrt):
        raise MXNetError("Symbol.grad: use bind + backward")

    def debug_str(self):
        """One line a node, in topological order: its op (or Variable),
        its name and its inputs' names."""
        lines = []
        for node in self._topo():
            kind = "Variable" if node.is_variable else node.op.name
            ins = ", ".join(n.name for n, _ in node.inputs)
            lines.append("%s %s(%s)" % (kind, node.name, ins))
        return "\n".join(lines)

    # ------------------------------------------------ serialization
    def tojson(self):
        nodes = []
        node_id = {}
        arg_nodes = []
        for node in self._topo():
            nid = len(nodes)
            node_id[id(node)] = nid
            attrs = {k: attr_repr(v) for k, v in node.attrs.items()
                     if not k.startswith("__") and v is not None}
            attrs.update(node._extra_attrs)
            entry = {"op": "null" if node.is_variable else node.op.name,
                     "name": node.name,
                     "inputs": [[node_id[id(n)], idx, 0]
                                for n, idx in node.inputs]}
            if attrs:
                entry["attrs"] = attrs
            nodes.append(entry)
            if node.is_variable:
                arg_nodes.append(nid)
        heads = [[node_id[id(n)], idx, 0] for n, idx in self._outputs]
        return json.dumps({"nodes": nodes, "arg_nodes": arg_nodes,
                           "node_row_ptr": list(range(len(nodes) + 1)),
                           "heads": heads,
                           "attrs": {"mxnet_version": ["int", 1100],
                                     "framework": ["str", "mxtpu"]}},
                          indent=2)

    def save(self, fname):
        """Write ``tojson()`` to ``fname`` (the ``-symbol.json`` of a
        checkpoint; mxtpu/symbol/symbol.py:446)."""
        with open(fname, "w") as f:
            f.write(self.tojson())


def _output_names(node, n_vis):
    if n_vis == 1:
        return ["%s_output" % node.name]
    return ["%s_output%d" % (node.name, i) for i in range(n_vis)]


def _entry_key(entry):
    node, idx = entry
    return (id(node), idx)


def _shape_attr(shp):
    """A variable's __shape__ attr: a tuple, a JSON list, or a string."""
    if isinstance(shp, str):
        shp = ast.literal_eval(shp)
    return tuple(int(x) for x in shp)


def _infer_types(sym, type_hints):
    """{variable name or entry key: numpy dtype or None}: the types-only
    walk of mxtpu's ``_infer_graph`` (mxtpu/symbol/symbol.py:535-557)."""
    dtypes = {}
    for node in sym._topo():
        if node.is_variable:
            dt = type_hints.get(node.name)
            vdt = node._extra_attrs.get("__dtype__")
            if dt is None and vdt is not None:
                dt = _np.dtype(str(vdt))
            dtypes[node.name] = dtypes[(id(node), 0)] = dt
            continue
        dt = None
        if node.attrs.get("dtype") is not None:
            dt = _np.dtype(str(node.attrs["dtype"]))
        else:
            dt = next((dtypes[(id(n), i)] for n, i in node.inputs
                       if dtypes.get((id(n), i)) is not None), None)
        if dt is not None:
            for inode, idx in node.inputs:
                if dtypes.get((id(inode), idx)) is None and \
                        inode.is_variable:
                    dtypes[(id(inode), idx)] = dtypes[inode.name] = dt
        n_all = node.op.n_out(node.parsed_attrs()) + len(node.op.aux_names)
        for i in range(n_all):
            dtypes[(id(node), i)] = dt
    return dtypes


def _infer_graph(sym, shape_hints, partial=False):
    """Forward shape/dtype propagation with ``OpDef.infer`` (meta tensors);
    a consumer's ``infer_args`` fills unknown parameter shapes. With
    ``partial`` a node missing an input shape is skipped, not an
    error."""
    shapes = {}
    dtypes = {}
    for node in sym._topo():
        if node.is_variable:
            shp = shape_hints.get(node.name)
            if shp is None and node._extra_attrs.get("__shape__") is not None:
                shp = _shape_attr(node._extra_attrs["__shape__"])
            vdt = node._extra_attrs.get("__dtype__")
            dt = torch_dtype(str(vdt)) if vdt is not None else torch.float32
            shapes[node.name] = tuple(shp) if shp is not None else None
            shapes[(id(node), 0)] = shapes[node.name]
            dtypes[node.name] = dt
            dtypes[(id(node), 0)] = dt
            continue
        attrs = node.parsed_attrs()
        in_shapes = [shapes.get((id(n), i)) for n, i in node.inputs]
        if any(s is None for s in in_shapes) and node.op.infer_args:
            try:  # a rule that needs the missing shape fills nothing
                full = node.op.infer_args(attrs, in_shapes)
            except (TypeError, IndexError, ValueError):
                full = in_shapes
            for (inode, _), old, new in zip(node.inputs, in_shapes, full):
                if old is None and new is not None and inode.is_variable:
                    shapes[inode.name] = tuple(new)
                    shapes[(id(inode), 0)] = tuple(new)
        missing = [n.name for n, i in node.inputs
                   if shapes.get((id(n), i)) is None]
        if missing and partial:
            continue
        if missing:
            raise MXNetError("infer_shape: node '%s' (%s) needs the shapes "
                             "of %s" % (node.name, node.op.name, missing))
        in_avals = [(shapes[(id(n), i)], dtypes[(id(n), i)])
                    for n, i in node.inputs]
        for i, (s, d) in enumerate(node.op.infer(attrs, in_avals)):
            shapes[(id(node), i)] = s
            dtypes[(id(node), i)] = d
    return shapes, dtypes


# ---------------------------------------------------------------- constructors
def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, **kwargs):
    """A variable node carrying the active ``AttrScope``'s attrs and its
    own: ``__shape__``, ``__lr_mult__``, ``__wd_mult__``, ``__dtype__`` and
    ``__init__`` (an initializer's ``dumps()``), as mxtpu stores them."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    node = _Node(None, name, {}, [])
    node._extra_attrs.update(AttrScope.current())
    if shape is not None:
        node._extra_attrs["__shape__"] = tuple(shape)
    if lr_mult is not None:
        node._extra_attrs["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        node._extra_attrs["__wd_mult__"] = str(wd_mult)
    if dtype is not None:
        node._extra_attrs["__dtype__"] = str(dtype)
    if init is not None:
        node._extra_attrs["__init__"] = init.dumps() \
            if hasattr(init, "dumps") else str(init)
    if attr:
        node._extra_attrs.update({k: str(v) for k, v in attr.items()})
    node._extra_attrs.update({k: str(v) for k, v in kwargs.items()})
    return Symbol([(node, 0)])


var = Variable


def Group(symbols):
    entries = []
    for s in symbols:
        entries.extend(s._outputs)
    return Symbol(entries)


def _compose(op, name, sym_inputs, attrs, kwarg_syms=None):
    """Create an op node; auto-create Variables for missing tensor inputs
    (fc weight/bias, norm gamma/beta, softmax_label)."""
    hint = op.name.lower().lstrip("_")
    name = NameManager.get(name, hint)
    if op.variadic:
        in_syms = list(sym_inputs)
        attrs = dict(attrs)
        attrs[op.variadic] = len(in_syms)
    parsed = op.parse_attrs(attrs)
    if not op.variadic:
        by_name = dict(kwarg_syms or {})
        in_syms = []
        pos = list(sym_inputs)
        for argn in op.input_names(parsed):
            if argn in by_name:
                in_syms.append(by_name[argn])
            elif pos:
                in_syms.append(pos.pop(0))
            else:
                in_syms.append(Variable("%s_%s" % (name, argn)))
    entries = []
    for s in in_syms:
        if not isinstance(s, Symbol):
            raise MXNetError("op %s: inputs must be Symbols, got %s"
                             % (op.name, type(s)))
        if len(s._outputs) != 1:
            raise MXNetError("op %s: cannot compose multi-output symbol "
                             "directly" % op.name)
        entries.append(s._outputs[0])
    node = _Node(op, name, attrs, entries)
    # the scoped attrs (with AttrScope(ctx_group=...)): the reference's
    # __ctx_group__ mechanism
    node._extra_attrs.update(AttrScope.current())
    n_vis = op.n_out(parsed)
    return Symbol([(node, i) for i in range(n_vis)])


def create(op_name, inputs, attrs, name=None, kwarg_syms=None):
    return _compose(get_op(op_name), name, inputs, attrs,
                    kwarg_syms=kwarg_syms)


# ---------------------------------------------------------------- load
def load_json(json_str):
    data = json.loads(json_str)
    built = []
    for meta in data["nodes"]:
        attrs = meta.get("attrs") or meta.get("attr") or \
            meta.get("param") or {}
        if meta["op"] == "null":
            node = _Node(None, meta["name"], {}, [])
            node._extra_attrs = {k: v for k, v in attrs.items()
                                 if k.startswith("__")}
        else:
            if not op_exists(meta["op"]):
                raise MXNetError("load: unknown op '%s'" % meta["op"])
            op = get_op(meta["op"])
            inputs = [(built[i], idx) for i, idx, *_ in meta["inputs"]]
            op_attrs = {k: v for k, v in attrs.items()
                        if not k.startswith("__") and (
                            k in op.attrs_spec or op.open_attrs)}
            node = _Node(op, meta["name"], op_attrs, inputs)
            node._extra_attrs = {k: v for k, v in attrs.items()
                                 if k.startswith("__")}
        built.append(node)
    heads = [(built[i], idx) for i, idx, *_ in data["heads"]]
    return Symbol(heads)


def load(fname):
    """The Symbol of a JSON file written by either package's ``save``."""
    with open(fname) as f:
        return load_json(f.read())
