"""nd namespace: NDArray, one function per registered op, and mxtpu's
file format.

Counterpart of ``mxtpu/ndarray/__init__.py``: ``_make_nd_fn`` (:18)
generates ``nd.<op>`` for every op in the registry at import, with
tensor inputs first (positionally or by arg name) and the non-tensor
positionals mapped onto the attrs in registration order, as MXNet's
generated signatures do; ``maximum``/``minimum`` take an array or a
scalar on either side (:170-190), and the comparison functions
(:246-262) an array or a scalar on the right.
"""
from __future__ import annotations

import builtins as _builtins
import operator as _op
import sys as _sys

from ..base import PrefixOpNamespace as _PrefixNS
from ..ops.registry import get_op, list_ops
from .ndarray import (NDArray, arange, array, concatenate, empty, full,
                      host_copies, imperative_invoke, invoke_op, load, ones,
                      save, to_numpy, waitall, zeros)

__all__ = ["NDArray", "array", "zeros", "ones", "empty", "full", "arange",
           "concatenate", "invoke_op", "imperative_invoke", "waitall",
           "to_numpy", "host_copies", "save", "load", "add", "subtract",
           "multiply", "divide", "true_divide", "power", "maximum",
           "minimum", "equal", "not_equal", "greater", "greater_equal",
           "lesser", "lesser_equal", "contrib", "random", "imread",
           "imdecode", "imresize"]


def _make_nd_fn(opname, op):
    def fn(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)
        pos = [a for a in args if isinstance(a, NDArray)]
        # non-tensor positionals map onto attrs in registration order
        # (MXNet generated signatures: tensor inputs first, then attrs)
        if op.variadic:
            extra_pos = [a for a in args
                         if not isinstance(a, (NDArray, list, tuple))]
        else:
            extra_pos = [a for a in args if not isinstance(a, NDArray)]
        if extra_pos:
            for attr_name in op.attrs_spec:
                if not extra_pos:
                    break
                if attr_name.startswith("__") or attr_name in kwargs:
                    continue
                kwargs[attr_name] = extra_pos.pop(0)
        nd_kw = {k: v for k, v in list(kwargs.items())
                 if isinstance(v, NDArray)}
        for k in nd_kw:
            kwargs.pop(k)
        if op.variadic:
            if args and isinstance(args[0], (list, tuple)):
                pos = list(args[0]) + pos
            kwargs.setdefault(op.variadic, len(pos))
            inputs = pos
        else:
            wanted = op.input_names(op.parse_attrs(dict(kwargs)))
            inputs = []
            for name in wanted:
                if name in nd_kw:
                    inputs.append(nd_kw.pop(name))
                elif pos:
                    inputs.append(pos.pop(0))
            inputs += pos  # any leftovers positionally
        res = invoke_op(opname, inputs, kwargs, out=out)
        return res[0] if len(res) == 1 else res

    fn.__name__ = opname
    fn.__doc__ = op.doc or ("%s operator" % opname)
    return fn


_mod = _sys.modules[__name__]
for _name in list_ops():
    if not hasattr(_mod, _name):
        setattr(_mod, _name, _make_nd_fn(_name, get_op(_name)))

# the samplers' public names (mxtpu/ndarray/__init__.py:69-78)
for _pub, _priv in [("uniform", "_random_uniform"),
                    ("normal", "_random_normal"),
                    ("random_uniform", "_random_uniform"),
                    ("random_normal", "_random_normal"),
                    ("random_gamma", "_random_gamma"),
                    ("random_exponential", "_random_exponential"),
                    ("random_poisson", "_random_poisson"),
                    ("negative_binomial", "_random_negative_binomial"),
                    ("generalized_negative_binomial",
                     "_random_generalized_negative_binomial")]:
    setattr(_mod, _pub, _make_nd_fn(_priv, get_op(_priv)))

contrib = _PrefixNS(_mod, "_contrib_")
random = _PrefixNS(_mod, "_random_")

# ------------------------------------------------- module-level arithmetic
add = _op.add
subtract = _op.sub
multiply = _op.mul
divide = _op.truediv
true_divide = _op.truediv
power = _op.pow


def _either_side(name, scalar_name, plain):
    def fn(lhs, rhs):
        if isinstance(lhs, NDArray):
            return invoke_op(name, [lhs, rhs], {})[0] \
                if isinstance(rhs, NDArray) else \
                invoke_op(scalar_name, [lhs], {"scalar": float(rhs)})[0]
        if isinstance(rhs, NDArray):
            return invoke_op(scalar_name, [rhs], {"scalar": float(lhs)})[0]
        return plain(lhs, rhs)
    fn.__name__ = plain.__name__
    return fn


maximum = _either_side("broadcast_maximum", "_maximum_scalar", _builtins.max)
minimum = _either_side("broadcast_minimum", "_minimum_scalar", _builtins.min)


def _cmp_fn(broadcast_name, scalar_name):
    def fn(lhs, rhs):
        if isinstance(rhs, NDArray):
            return invoke_op(broadcast_name, [lhs, rhs], {})[0]
        return invoke_op(scalar_name, [lhs], {"scalar": float(rhs)})[0]
    fn.__name__ = broadcast_name.replace("broadcast_", "")
    return fn


equal = _cmp_fn("broadcast_equal", "_equal_scalar")
not_equal = _cmp_fn("broadcast_not_equal", "_not_equal_scalar")
greater = _cmp_fn("broadcast_greater", "_greater_scalar")
greater_equal = _cmp_fn("broadcast_greater_equal", "_greater_equal_scalar")
lesser = _cmp_fn("broadcast_lesser", "_lesser_scalar")
lesser_equal = _cmp_fn("broadcast_lesser_equal", "_lesser_equal_scalar")


# the host's image codec ops (parity: src/io/image_io.cc _cvimread,
# _cvimdecode, _cvimresize: OpenCV on the CPU in the reference too)
def imread(filename, flag=1, to_rgb=True, **kw):
    from ..image import imread as impl
    return impl(filename, flag=flag, to_rgb=to_rgb)


def imdecode(buf, flag=1, to_rgb=True, **kw):
    from ..image import imdecode as impl
    return impl(buf, flag=flag, to_rgb=to_rgb)


def imresize(src, w, h, interp=1, **kw):
    from ..image import imresize as impl
    return impl(src, w, h, interp=interp)
