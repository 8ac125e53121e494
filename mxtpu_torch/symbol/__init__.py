"""sym namespace: Symbol plus a composer for every registered op.

Counterpart of ``mxtpu/symbol/__init__.py``.
"""
from __future__ import annotations

import sys as _sys

from ..base import PrefixOpNamespace as _PrefixNS
from ..ops.registry import get_op, list_ops
from .symbol import (Group, NameManager, Symbol, Variable, create, load,
                     load_json, var)

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "NameManager", "create", "contrib"]


def _make_sym_fn(opname, op):
    def fn(*args, **kwargs):
        name = kwargs.pop("name", None)
        kwargs.pop("attr", None)
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

contrib = _PrefixNS(_mod, "_contrib_")
