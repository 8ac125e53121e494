"""Base utilities: the error type and symbol-attribute parsing.

Counterpart of ``mxtpu/base.py``; carries its own copy of the pieces the
port needs (``MXNetError``, ``parse_attr``, ``attr_repr``) so the port
never imports the JAX package.
"""
from __future__ import annotations

import ast

__all__ = ["MXNetError", "parse_attr", "attr_repr", "PrefixOpNamespace"]


class MXNetError(RuntimeError):
    """Error raised by the framework (parity with python/mxnet/base.py:56)."""


def parse_attr(value, proto):
    """Parse a (possibly string) attribute value to the type of ``proto``.

    Symbol JSON stores all attrs as strings (reference nnvm attr dicts);
    this is the counterpart of dmlc::Parameter string parsing.
    """
    if proto is None:
        return value
    ty = proto if isinstance(proto, type) else type(proto)
    if value is None:
        return value
    if ty is bool:
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes")
        return bool(value)
    if ty in (tuple, list):
        if isinstance(value, str):
            v = ast.literal_eval(value) if value.strip() else ()
            # attr_repr writes one-element tuples without a trailing
            # comma ("(1)"), which literal_eval reads back as a scalar
            return (v,) if not isinstance(v, (tuple, list)) else tuple(v)
        if isinstance(value, (tuple, list)):
            return tuple(value)
        return (value,)
    if ty is int:
        if isinstance(value, str) and value.lower() == "none":
            return None
        return int(float(value)) if isinstance(value, str) else int(value)
    if ty is float:
        return float(value)
    if ty is str:
        return str(value)
    return value


def attr_repr(value):
    """Serialize an attribute for symbol JSON (everything becomes a string)."""
    if isinstance(value, (tuple, list)):
        return "(" + ", ".join(str(v) for v in value) + ")"
    return str(value)


class PrefixOpNamespace:
    """Sub-namespace over a module exposing prefix-registered ops, e.g.
    sym.contrib.FlashAttention -> module attr '_contrib_FlashAttention'."""

    def __init__(self, module, prefix):
        self._module = module
        self._prefix = prefix

    def __getattr__(self, name):
        full = self._prefix + name
        if hasattr(self._module, full):
            return getattr(self._module, full)
        raise AttributeError("%s%s" % (self._prefix, name))

    def __dir__(self):
        n = len(self._prefix)
        return [k[n:] for k in dir(self._module)
                if k.startswith(self._prefix)]
