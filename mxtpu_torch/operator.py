"""User-defined operators in Python (``mx.operator``).

Counterpart of ``mxtpu/operator.py``: ``CustomOp`` (:25, with ``assign``
and its write requests), ``CustomOpProp`` (:47), ``register`` (:96),
``get_prop_cls`` (:109), ``make_prop`` (:116) and the array the op's body
sees (``_HostArray``, :126). The op itself is ``Custom`` in
``ops/custom.py``: its body runs on the host, on numpy copies of its
inputs, inside a ``torch.autograd.Function``.
"""
from __future__ import annotations

import numpy as _np

from .base import MXNetError

__all__ = ["CustomOp", "CustomOpProp", "register", "get_prop_cls"]

_REGISTRY = {}  # op_type -> CustomOpProp subclass


class CustomOp:
    """Base class of a user op's body."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` as the request ``req`` says: "write"
        and "inplace" overwrite, "add" adds, "null" does nothing."""
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] = dst[:] + src
        else:
            raise MXNetError("unknown req '%s'" % req)


class CustomOpProp:
    """Describes a user op: its arguments, outputs, auxiliary states,
    shapes and types. Its kwargs arrive as strings, as in MXNet."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = bool(need_top_grad)

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def need_top_grad(self):
        return self.need_top_grad_

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError


def register(reg_name):
    """Decorator: register a CustomOpProp subclass under ``op_type``."""

    def _do(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("register expects a CustomOpProp subclass")
        _REGISTRY[reg_name] = prop_cls
        return prop_cls

    return _do


def get_prop_cls(op_type):
    if op_type not in _REGISTRY:
        raise MXNetError("custom op type '%s' is not registered "
                         "(use mx.operator.register)" % op_type)
    return _REGISTRY[op_type]


def make_prop(op_type, kwargs):
    """The prop of ``op_type`` made with its kwargs as strings (a prop
    whose constructor takes none is made without them)."""
    cls = get_prop_cls(op_type)
    str_kwargs = {k: str(v) for k, v in kwargs.items()}
    try:
        return cls(**str_kwargs)
    except TypeError:
        return cls()


class _HostArray:
    """A mutable host array handed to ``CustomOp.forward``/``backward``:
    ``.asnumpy()``, ``.shape``, ``.dtype``, ``x[k]`` and ``x[:] = value``,
    as MXNet's NDArray offers them to a custom op's body."""

    def __init__(self, arr):
        self._arr = _np.asarray(arr)

    def asnumpy(self):
        return self._arr

    @property
    def shape(self):
        return self._arr.shape

    @property
    def dtype(self):
        return self._arr.dtype

    def __getitem__(self, k):
        return self._arr[k]

    def __setitem__(self, k, v):
        self._arr[k] = _np.asarray(getattr(v, "_arr", v))

    def __array__(self, dtype=None, copy=None):
        return self._arr if dtype is None else self._arr.astype(dtype)
