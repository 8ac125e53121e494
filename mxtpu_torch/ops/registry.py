"""Operator registry: every op is a plain function on torch tensors.

Counterpart of ``mxtpu/ops/registry.py`` (``OpDef`` :59, ``register``
:171, ``get_op`` :194, ``invoke`` :208). The JAX package jit-compiles each
op and infers shapes with ``jax.eval_shape``; here ops run eagerly and
shape inference runs the same function on ``device="meta"`` tensors,
which carry shapes and dtypes but no data and do no arithmetic.
"""
from __future__ import annotations

import numpy as _np
import torch

from .. import random as _random
from ..base import MXNetError, parse_attr

__all__ = ["OpDef", "register", "register_op", "get_op", "op_exists",
           "list_ops", "Required", "invoke", "AttrDict", "torch_dtype",
           "numpy_dtype", "BFLOAT16", "set_replicas", "off_batch_axis",
           "int_convert"]

_OPS = {}

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64,
           "int32": torch.int32, "int64": torch.int64, "int16": torch.int16,
           "int8": torch.int8, "uint8": torch.uint8, "uint32": torch.uint32,
           "bool": torch.bool}

#: What ``NDArray.dtype`` gives for a bfloat16 array. numpy has no
#: bfloat16 (mxtpu's comes from ml_dtypes, which the port does not
#: need), so the stand-in is a 2-byte record whose one field is named
#: "bfloat16": it equals no numeric type, ``torch_dtype`` maps it back,
#: and ``np.zeros(n, BFLOAT16)`` holds the raw bits.
BFLOAT16 = _np.dtype([("bfloat16", "<u2")])

_NUMPY = {t: (BFLOAT16 if t == torch.bfloat16 else _np.dtype(n))
          for n, t in _DTYPES.items()}


def torch_dtype(name):
    """torch dtype for an MXNet dtype: a string ("float32"), a numpy type
    or dtype (``np.float32``, ``np.dtype("int8")``, ``BFLOAT16``) or a
    torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    if isinstance(name, str) or name is None:
        key = str(name)
    else:
        try:
            dt = _np.dtype(name)
        except TypeError:
            raise MXNetError("unsupported dtype %r" % (name,))
        key = "bfloat16" if dt == BFLOAT16 else dt.name
    if key not in _DTYPES:
        raise MXNetError("unsupported dtype %r" % (name,))
    return _DTYPES[key]


def numpy_dtype(dtype):
    """The numpy dtype of a torch dtype (``BFLOAT16`` for bfloat16), as
    mxtpu's ``NDArray.dtype`` is ``np.dtype(array.dtype)``."""
    return _NUMPY[torch_dtype(dtype)]


def int_convert(x, dtype=torch.int32):
    """``x`` in the integer type ``dtype`` as XLA's convert makes it for
    mxtpu's ``astype``: a float truncates toward zero, NaN becomes 0 and
    a value outside the type's range saturates at its bound, where
    torch's own conversion wraps or overflows; an integer converts as
    torch converts it. The one place of that rule: ``Cast``, the index
    reads of ``take``/``pick``/``one_hot``, ROI batch indices, CTC's
    labels and lengths, count_sketch's ``h`` and MultiBox's classes."""
    dtype = torch_dtype(dtype)
    if not x.is_floating_point():
        return x.to(dtype)
    info = torch.iinfo(dtype)
    # float64 holds every int32 bound exactly; int64's max rounds up to
    # 2**63, which the comparison then still maps to the max
    xd = torch.nan_to_num(x.to(torch.float64), nan=0.0)
    over, under = xd >= float(info.max), xd <= float(info.min)
    mid = torch.where(over | under, torch.zeros_like(xd), xd).to(dtype)
    return torch.where(over, info.max, torch.where(under, info.min, mid)
                       ).to(dtype)


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
    inputs' device (``random.generator``), or None on meta tensors; one
    with no tensor inputs (``_random_uniform``) is ``fn(attrs, generator,
    device)``.
    ``loss_like``: the output is a loss head whose gradient ignores the
    incoming head gradient (SoftmaxOutput); ``fn`` encodes that in its
    autograd.Function, and a backward with no head gradients feeds ones.
    ``aux_names``: the trailing inputs that are auxiliary states
    (BatchNorm's moving_mean and moving_var). ``fn`` then returns its
    ``n_out`` visible outputs followed by ``len(aux_names)`` updated aux
    values, and the executor writes those back after a training forward
    (mxtpu/ops/registry.py:90-93).

    Over replicas (the executor's replica walk: the batch split over
    several devices, one graph each, in lockstep), ``row_local`` (a bool,
    or a function of the attrs and the first input's rank) says whether each replica's result is
    the whole batch's result on its rows; ``group_fn(attrs,
    inputs_per_replica)`` computes an op that couples rows of the batch
    (BatchNorm in training, a normalized loss) over all replicas at once
    and returns each replica's ``apply`` tuple. ``replica_mode`` picks.
    ``tp_fn(attrs, inputs_per_replica, split, layout)`` runs the op on
    replicas that hold blocks of a parameter split over the mesh
    (``split``: {input position: parameter name}, ``layout`` the
    ``parallel.mesh.ReplicaLayout``) without gathering the block its
    ``tp`` axis splits, or returns None for a split it has no form for;
    the walk then gathers every split input first (FullyConnected,
    Convolution and Embedding have one).
    ``open_attrs``: the op takes attrs beyond ``attrs_spec`` (``Custom``'s
    kwargs for its prop), which ``load_json`` keeps.
    """

    open_attrs = False

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
        self.row_local = False
        self.group_fn = None
        self.tp_fn = None
        self.doc = doc or (fn.__doc__ or "")

    def replica_mode(self, attrs, ndim):
        """"rows" (each replica runs the op on its rows), "group" (one
        ``group_fn`` call over the replicas), or None: the op couples rows
        of the batch and has no group form, so a replica walk refuses
        it rather than compute a per-replica answer. ``ndim`` is the rank
        of the op's first input."""
        rows = self.row_local(attrs, ndim) if callable(self.row_local) \
            else self.row_local
        if rows:
            return "rows"
        return "group" if self.group_fn is not None else None

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

    def apply(self, attrs, inputs, device=None):
        """Run the op eagerly; returns a tuple of tensors: the visible
        outputs, then the updated aux values of an op with aux_names. An
        op with no tensor inputs (``_zeros``) is ``fn(attrs, device)``,
        and makes its output on ``device``."""
        if self.needs_rng:
            dev = inputs[0].device if inputs else \
                torch.device(device or "cpu")
            gen = None if dev.type == "meta" else _random.generator(dev)
            out = self.fn(attrs, gen, *(inputs or (dev,)))
        elif not inputs and not self.variadic:
            out = self.fn(attrs, torch.device(device or "cpu"))
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
        outs = self.apply(attrs, metas, "meta")[:self.n_out(attrs)]
        return [(tuple(o.shape), o.dtype) for o in outs]


def register(name, fn=None, **kwargs):
    """Register an op. Usable as decorator or direct call."""

    def _do(f):
        register_op(OpDef(name, f, **kwargs))
        return f

    if fn is not None:
        _do(fn)
        return _OPS[name]
    return _do


def register_op(op):
    """Register an OpDef (a subclass with its own ``parse_attrs``, such
    as ``Custom``'s) under its name and aliases."""
    _OPS[op.name] = op
    for a in op.aliases:
        _OPS[a] = op
    return op


def set_replicas(names, row_local=True, group_fn=None):
    """Declare how the ops ``names`` run over replicas (``OpDef``'s
    ``row_local`` and ``group_fn``)."""
    for name in names:
        op = get_op(name)
        op.row_local = row_local
        if group_fn is not None:
            op.group_fn = group_fn


def set_tp(names, tp_fn):
    """Give the ops ``names`` their ``tp_fn``."""
    for name in names:
        get_op(name).tp_fn = tp_fn


def off_batch_axis(axis, ndim):
    """Whether an ``axis`` attr (an int, a tuple, or None for every axis)
    leaves axis 0, the batch axis, alone."""
    if axis is None or ndim == 0:
        return False
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    return bool(axes) and all(int(x) % ndim != 0 for x in axes)


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
