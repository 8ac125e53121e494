"""Gluon Parameter and ParameterDict.

Counterpart of ``mxtpu/gluon/parameter.py`` (``Parameter`` :19,
``ParameterDict`` :224): deferred initialization (:77-85), the variable
marked with its gradient buffer (``_init_impl`` :64-75), ``data``,
``grad``, ``set_data``, ``zero_grad``, ``cast``, ``var`` and
``reset_ctx``; ``ParameterDict.save``/``load`` with ``strip_prefix`` in
mxtpu's ``.params`` format (``nd.save``/``nd.load``, which cross between
the packages bit for bit). A parameter lives on one context: several
need the KVStore over NCCL (ROADMAP A.4) and raise. ``set_data`` and a
load write the tensor in place, so the parameter stays the same autograd
leaf the Trainer updates.
"""
from __future__ import annotations

import torch

from .. import autograd
from .. import context as ctx_mod
from .. import ndarray as nd
from .. import symbol as sym_mod
from ..base import MXNetError
from ..initializer import InitDesc

__all__ = ["DeferredInitializationError", "Parameter", "ParameterDict"]


class DeferredInitializationError(MXNetError):
    pass


def one_context(ctx, what):
    """The one Context of ``ctx`` (None: the current context, which is
    gpu(0) unless a ``with cpu():`` scope says otherwise)."""
    if ctx is None:
        return ctx_mod.current_context()
    if isinstance(ctx, (list, tuple)):
        if len(ctx) != 1:
            raise MXNetError(
                "%s on %d contexts: several contexts need the KVStore over "
                "NCCL (ROADMAP A.4), not ported yet" % (what, len(ctx)))
        ctx = ctx[0]
    return ctx_mod.as_context(ctx)


class Parameter:
    """A weight (or aux state) of a Block (parity parameter.py:41)."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True):
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.grad_req = grad_req if differentiable else "null"
        self._allow_deferred_init = allow_deferred_init
        self._var = None
        self._data = None  # the NDArray, once initialized
        self._grad = None
        self._ctx = None
        self._deferred_init = ()

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self.shape,
                                                      self.dtype)

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        from ..initializer import Uniform
        default_init = default_init or Uniform()
        if self._data is not None and not force_reinit:
            return
        ctx = one_context(ctx, "Parameter %s" % self.name)
        if self.shape is None or any(s == 0 for s in self.shape):
            if self._allow_deferred_init:
                self._deferred_init = (init, ctx, default_init)
                return
            raise MXNetError("Cannot initialize Parameter %s because it has "
                             "invalid shape: %s." % (self.name,
                                                     str(self.shape)))
        self._finish_init(init, ctx, default_init)

    def _finish_init(self, init, ctx, default_init):
        data = nd.zeros(self.shape, dtype=self.dtype, ctx=ctx)
        initializer = init or self.init or default_init
        initializer(InitDesc(self.name), data)
        self._init_impl(data, ctx)

    def _init_impl(self, data, ctx):
        """Hold ``data`` on ``ctx`` and, unless grad_req is "null", mark
        it as an autograd variable with a zero gradient buffer."""
        self._ctx = ctx
        self._data = data.as_in_context(ctx)
        if self.grad_req == "null":
            self._grad = None
            return
        self._grad = nd.zeros(self.shape, dtype=self.dtype, ctx=ctx)
        autograd.mark_variables([self._data], [self._grad], self.grad_req)

    def _finish_deferred_init(self):
        if not self._deferred_init:
            return
        init, ctx, default_init = self._deferred_init
        self._deferred_init = ()
        if self.shape is None or any(s == 0 for s in self.shape):
            raise DeferredInitializationError(
                "Parameter %s has unknown shape" % self.name)
        self._finish_init(init, ctx, default_init)

    def _load_init(self, data, ctx):
        if self.shape and any(s != 0 for s in self.shape):
            # 0 dims are deferred-init wildcards: only compare known dims
            if len(data.shape) != len(self.shape) or not all(
                    s in (0, d) for s, d in zip(self.shape, data.shape)):
                raise MXNetError(
                    "Failed loading Parameter %s: shape %s vs saved %s"
                    % (self.name, self.shape, data.shape))
        self.shape = tuple(data.shape)
        if self._data is None:
            self._deferred_init = ()
            with autograd.pause():
                self._init_impl(data.astype(self.dtype),
                                one_context(ctx, "Parameter %s"
                                            % self.name))
        else:
            self.set_data(data)

    def set_data(self, data):
        """Write ``data`` into the parameter in place."""
        if self._data is None:
            raise MXNetError("Parameter %s has not been initialized"
                             % self.name)
        src = getattr(data, "_data", data)
        with torch.no_grad():
            self._data._data.copy_(src.reshape(self._data.shape))

    def data(self, ctx=None):
        if self._data is None:
            if self._deferred_init:
                raise DeferredInitializationError(
                    "Parameter %s was not initialized on context %s." %
                    (self.name, str(ctx)))
            raise MXNetError("Parameter %s has not been initialized. "
                             "call .initialize() first" % self.name)
        if ctx is not None and ctx_mod.as_context(ctx) != self._ctx:
            raise MXNetError("Parameter %s was not initialized on context "
                             "%s." % (self.name, str(ctx)))
        return self._data

    def list_data(self):
        return [self.data()]

    def grad(self, ctx=None):
        if self._grad is None:
            raise MXNetError(
                "Cannot get gradient array for Parameter %s because grad_req"
                "='null'" % self.name)
        self.data(ctx)  # the same context checks
        return self._grad

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        if self._data is None:
            if self._deferred_init:
                return [self._deferred_init[1]]
            raise MXNetError("Parameter %s has not been initialized"
                             % self.name)
        return [self._ctx]

    def zero_grad(self):
        if self._grad is not None:
            self._grad._data.zero_()

    def var(self):
        if self._var is None:
            shape = self.shape
            if shape is not None and any(s == 0 for s in shape):
                shape = None  # unknown dims: let graph inference fill them
            self._var = sym_mod.var(self.name, shape=shape,
                                    dtype=self.dtype, lr_mult=self.lr_mult,
                                    wd_mult=self.wd_mult)
        return self._var

    def reset_ctx(self, ctx):
        ctx = one_context(ctx, "Parameter %s" % self.name)
        if self._data is not None:
            with autograd.pause():
                self._init_impl(self._data.detach(), ctx)
        elif self._deferred_init:
            init, _, default_init = self._deferred_init
            self._deferred_init = (init, ctx, default_init)

    def cast(self, dtype):
        self.dtype = dtype
        if self._data is None:
            return
        with autograd.pause():
            data = self._data.detach().astype(dtype)
            self._init_impl(data, self._ctx)


class ParameterDict:
    """Prefix-scoped dict of Parameters (parity parameter.py:394)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = {}
        self._shared = shared

    def __repr__(self):
        s = "{name}(\n{content}\n)"
        name = self._prefix + " " if self._prefix else ""
        return s.format(name=name, content="\n".join(
            "  " + repr(v) for v in self.values()))

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name, **kwargs):
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
        else:
            for k, v in kwargs.items():
                if hasattr(param, k) and getattr(param, k) is not None:
                    existing = getattr(param, k)
                    if k == "shape" and v is not None and \
                            len(tuple(v)) == len(existing):
                        param.shape = tuple(a if a != 0 else b for a, b in
                                            zip(existing, tuple(v)))
                else:
                    setattr(param, k, v)
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params:
                if self._params[k] is not v:
                    raise MXNetError(
                        "Cannot update self with other because they have "
                        "different Parameters with the same name %s" % k)
            else:
                self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        from ..initializer import Uniform
        del verbose
        for v in self.values():
            v.initialize(None, ctx, init or Uniform(),
                         force_reinit=force_reinit)

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def reset_ctx(self, ctx):
        for v in self.values():
            v.reset_ctx(ctx)

    def setattr(self, name, value):
        for v in self.values():
            setattr(v, name, value)

    def save(self, filename, strip_prefix=""):
        arg_dict = {}
        for param in self.values():
            if not param.name.startswith(strip_prefix):
                raise ValueError("Prefix %s is to be striped before saving, "
                                 "but Parameter %s does not start with %s"
                                 % (strip_prefix, param.name, strip_prefix))
            arg_dict[param.name[len(strip_prefix):]] = param.data()
        nd.save(filename, arg_dict)

    def load(self, filename, ctx, allow_missing=False, ignore_extra=False,
             restore_prefix=""):
        if restore_prefix:
            for name in self.keys():
                if not name.startswith(restore_prefix):
                    raise MXNetError(
                        "restore_prefix is %s but Parameter name %s does not "
                        "start with it" % (restore_prefix, name))
        lprefix = len(restore_prefix)
        arg_dict = {restore_prefix + k: v
                    for k, v in nd.load(filename).items()}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise MXNetError("Parameter %s is missing in file %s"
                                     % (name[lprefix:], filename))
        for name in arg_dict:
            if name not in self._params:
                if not ignore_extra:
                    raise MXNetError(
                        "Parameter %s loaded from file %s is not present in "
                        "ParameterDict" % (name[lprefix:], filename))
                continue
            self[name]._load_init(arg_dict[name], ctx)
