"""Operator registry: every op is a plain function on torch tensors.

Counterpart of ``mxtpu/ops/registry.py`` (``OpDef`` :59, ``register``
:171, ``get_op`` :194, ``invoke`` :208). The JAX package jit-compiles each
op and infers shapes with ``jax.eval_shape``; here ops run eagerly and
shape inference runs the same function on ``device="meta"`` tensors,
which carry shapes and dtypes but no data and do no arithmetic.
"""
from __future__ import annotations

import torch

from .. import random as _random
from ..base import MXNetError, parse_attr

__all__ = ["OpDef", "register", "get_op", "op_exists", "list_ops",
           "Required", "invoke", "AttrDict", "torch_dtype"]

_OPS = {}

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64,
           "int32": torch.int32, "int64": torch.int64,
           "int8": torch.int8, "uint8": torch.uint8}


def torch_dtype(name):
    """torch dtype for an MXNet dtype string (or a torch dtype)."""
    if isinstance(name, torch.dtype):
        return name
    key = str(name)
    if key not in _DTYPES:
        raise MXNetError("unsupported dtype %r" % (name,))
    return _DTYPES[key]


class Required:
    """Marker for a required attribute; carries the prototype type."""

    def __init__(self, proto):
        self.proto = proto

    def __repr__(self):
        return "Required(%s)" % getattr(self.proto, "__name__", self.proto)


class AttrDict(dict):
    """Attribute-access dict of parsed op attributes."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k)


class OpDef:
    """Metadata + impl for one operator.

    ``fn(attrs, *inputs)`` returns a tensor or a tuple of tensors.
    ``infer_args(attrs, in_shapes_with_None)`` fills parameter shapes
    from the data shape (weights, biases, norm scales, labels).
    ``variadic`` names the attr holding the input count (``num_args``);
    the tensor inputs are then ``arg0 .. argN``.
    ``needs_rng``: the op draws random numbers; ``fn`` is then
    ``fn(attrs, generator, *inputs)`` with the ``torch.Generator`` of the
    inputs' device (``random.generator``), or None on meta tensors.
    ``loss_like``: the output is a loss head whose gradient ignores the
    incoming head gradient (SoftmaxOutput); ``fn`` encodes that in its
    autograd.Function, and a backward with no head gradients feeds ones.
    ``aux_names``: the trailing inputs that are auxiliary states
    (BatchNorm's moving_mean and moving_var). ``fn`` then returns its
    ``n_out`` visible outputs followed by ``len(aux_names)`` updated aux
    values, and the executor writes those back after a training forward
    (mxtpu/ops/registry.py:90-93).
    """

    def __init__(self, name, fn, arg_names=("data",), attrs=None,
                 num_outputs=1, aliases=(), aux_names=(), infer_args=None,
                 variadic=None, needs_rng=False, loss_like=False, doc=None):
        self.name = name
        self.fn = fn
        self.arg_names = arg_names if callable(arg_names) else list(arg_names)
        self.attrs_spec = dict(attrs or {})
        self.num_outputs = num_outputs
        self.aliases = aliases
        self.aux_names = list(aux_names)
        self.infer_args = infer_args
        self.variadic = variadic
        self.needs_rng = needs_rng
        self.loss_like = loss_like
        self.doc = doc or (fn.__doc__ or "")

    def parse_attrs(self, kwargs):
        out = AttrDict()
        for k, default in self.attrs_spec.items():
            if k in kwargs and kwargs[k] is not None:
                proto = default.proto if isinstance(default, Required) \
                    else default
                out[k] = parse_attr(kwargs[k], proto)
            elif isinstance(default, Required):
                raise MXNetError("op %s: required attr '%s' missing"
                                 % (self.name, k))
            else:
                out[k] = default
        return out

    def n_out(self, attrs):
        return self.num_outputs(attrs) if callable(self.num_outputs) \
            else self.num_outputs

    def input_names(self, attrs=None):
        if self.variadic:
            return ["arg%d" % i
                    for i in range(int((attrs or {}).get(self.variadic, 0)))]
        if callable(self.arg_names):
            return list(self.arg_names(attrs or AttrDict()))
        return self.arg_names

    def apply(self, attrs, inputs):
        """Run the op eagerly; returns a tuple of tensors: the visible
        outputs, then the updated aux values of an op with aux_names."""
        if self.needs_rng:
            dev = inputs[0].device
            gen = None if dev.type == "meta" else _random.generator(dev)
            out = self.fn(attrs, gen, *inputs)
        else:
            out = self.fn(attrs, *inputs)
        if not isinstance(out, (tuple, list)):
            out = (out,)
        return tuple(out)

    def infer(self, attrs, in_avals):
        """(shape, dtype) of the ``n_out`` visible outputs from input
        (shape, dtype) pairs, by running the op on meta tensors; the
        updated aux values an op returns after them are not outputs."""
        metas = [torch.empty(tuple(s), dtype=torch_dtype(d), device="meta")
                 for s, d in in_avals]
        outs = self.apply(attrs, metas)[:self.n_out(attrs)]
        return [(tuple(o.shape), o.dtype) for o in outs]


def register(name, fn=None, **kwargs):
    """Register an op. Usable as decorator or direct call."""

    def _do(f):
        op = OpDef(name, f, **kwargs)
        _OPS[name] = op
        for a in op.aliases:
            _OPS[a] = op
        return f

    if fn is not None:
        _do(fn)
        return _OPS[name]
    return _do


def get_op(name):
    if name not in _OPS:
        raise MXNetError("operator '%s' is not registered" % name)
    return _OPS[name]


def op_exists(name):
    return name in _OPS


def list_ops():
    return sorted(_OPS)


def invoke(name, inputs, attrs_kwargs):
    """Imperative invoke on raw tensors: parse attrs, run. Returns
    ``(op, attrs, outputs)``, where ``outputs`` is the full tuple of
    ``apply``: ``outputs[:op.n_out(attrs)]`` are the visible outputs and
    the rest the op's updated aux values (BatchNorm's new moving_mean and
    moving_var), which nothing writes back here."""
    op = get_op(name)
    attrs = op.parse_attrs(attrs_kwargs)
    return op, attrs, op.apply(attrs, inputs)


def write_aux(dst, updates):
    """Copy an op's or a graph's updated aux values (BatchNorm's moving
    statistics) into the aux tensors they came from, in place under
    ``no_grad``, so every holder of those tensors sees the new values:
    ``updates`` and ``dst`` map an aux name to the new value and to the
    tensor it updates. A value that is the aux tensor itself (BatchNorm
    under use_global_stats) is skipped: copying it onto itself would only
    bump the version of a tensor the backward may have saved."""
    with torch.no_grad():
        for name, val in updates.items():
            if val is not dst[name]:
                dst[name].copy_(val)
