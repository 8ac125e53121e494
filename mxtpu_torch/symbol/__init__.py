"""sym namespace: Symbol plus a composer for every registered op.

Counterpart of ``mxtpu/symbol/__init__.py``.
"""
from __future__ import annotations

import builtins as _builtins
import math as _math
import sys as _sys

from ..base import PrefixOpNamespace as _PrefixNS
from ..ops.registry import get_op, list_ops
from .symbol import (Group, NameManager, Symbol, Variable, create, load,
                     load_json, var)

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "NameManager", "create", "contrib", "linalg", "maximum", "minimum",
           "hypot", "zeros", "ones", "full", "arange", "uniform", "normal",
           "pow"]


def _make_sym_fn(opname, op):
    def fn(*args, **kwargs):
        name = kwargs.pop("name", None)
        kwargs.pop("attr", None)
        extra = [a for a in args
                 if not isinstance(a, (Symbol, list, tuple))]
        if extra and not op.variadic:
            # non-Symbol positionals map onto attrs in registration order
            # (mxtpu/symbol/__init__.py:22-34): sym.clip(x, -1, 1)
            args = [a for a in args if isinstance(a, Symbol)]
            for attr_name in op.attrs_spec:
                if not extra:
                    break
                if attr_name.startswith("__") or attr_name in kwargs:
                    continue
                kwargs[attr_name] = extra.pop(0)
        sym_kw = {k: v for k, v in kwargs.items() if isinstance(v, Symbol)}
        for k in sym_kw:
            kwargs.pop(k)
        return create(opname, list(args), kwargs, name=name,
                      kwarg_syms=sym_kw)

    fn.__name__ = opname
    fn.__doc__ = op.doc or ("%s symbol composer" % opname)
    return fn


_mod = _sys.modules[__name__]
for _name in list_ops():
    if not hasattr(_mod, _name):
        setattr(_mod, _name, _make_sym_fn(_name, get_op(_name)))

zeros = _make_sym_fn("_zeros", get_op("_zeros"))

contrib = _PrefixNS(_mod, "_contrib_")
linalg = _PrefixNS(_mod, "_linalg_")


def _either_side(op, scalar_op, plain):
    """Symbol or number on either side (mxtpu/symbol/__init__.py:80)."""
    def fn(left, right):
        if isinstance(left, Symbol) and isinstance(right, Symbol):
            return create(op, [left, right], {})
        if isinstance(left, Symbol):
            return create(scalar_op, [left], {"scalar": float(right)})
        if isinstance(right, Symbol):
            return create(scalar_op, [right], {"scalar": float(left)})
        return plain(left, right)
    fn.__name__ = plain.__name__
    return fn


maximum = _either_side("_maximum", "_maximum_scalar", _builtins.max)
minimum = _either_side("_minimum", "_minimum_scalar", _builtins.min)
hypot = _either_side("_hypot", "_hypot_scalar", _math.hypot)
# the constructors' public names (mxtpu/symbol/__init__.py:53-63)
ones = _make_sym_fn("_ones", get_op("_ones"))
arange = _make_sym_fn("_arange", get_op("_arange"))
uniform = _make_sym_fn("_random_uniform", get_op("_random_uniform"))
normal = _make_sym_fn("_random_normal", get_op("_random_normal"))


def full(shape, val, dtype="float32", **kwargs):
    """A constant-filled symbol: ``_ones * val``, as mxtpu's."""
    return ones(shape=shape, dtype=dtype, **kwargs) * float(val)


def pow(base, exp):  # noqa: A001  (mxtpu's name)
    return base ** exp
