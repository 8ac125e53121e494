"""The ``Custom`` operator: a user's Python op inside a graph.

Counterpart of ``mxtpu/ops/custom.py``: ``_CustomOpDef`` (:21-35, every
kwarg kept), ``_custom_fn`` (:44-132), ``_custom_infer_args`` (:139-155)
and ``_NoGradient`` (:170). mxtpu runs the body as a
``jax.pure_callback`` under a ``jax.custom_vjp``; here the body is a
``torch.autograd.Function`` whose forward hands the user's
``CustomOp.forward`` numpy copies of the inputs and whose backward hands
``CustomOp.backward`` the saved inputs and outputs with the head
gradients. One operator instance serves a call's forward and backward,
so an op may keep what its backward needs. ``is_train`` is the
executor's ``__is_train__``, else ``autograd.is_training()``.

Each call draws a seed from the ``torch.Generator`` of the inputs'
device and puts it on the operator as ``_mxtpu_rng_seed`` before its
forward: a stochastic body draws the same numbers in that call's
forward and backward. mxtpu takes its seed from the op's JAX PRNG key,
so the two packages' seeds differ (a deliberate delta of the random
streams, as for the samplers). Shape inference (meta tensors) takes the
prop's ``infer_shape`` and ``infer_type`` and never runs the body.
"""
from __future__ import annotations

import numpy as _np
import torch

from .. import operator as _operator
from ..base import MXNetError
from .registry import (AttrDict, OpDef, Required, numpy_dtype, register,
                       register_op, torch_dtype)


class _CustomOpDef(OpDef):
    """OpDef that keeps every kwarg: a custom op takes any str params."""

    open_attrs = True  # load_json keeps every serialized attr

    def parse_attrs(self, kwargs):
        if "op_type" not in kwargs:
            raise MXNetError("Custom op requires op_type=")
        out = AttrDict()
        for k, v in kwargs.items():
            if k in ("name", "out", "ctx", "dtype_hint"):
                continue
            out[k] = v if not isinstance(v, (list, dict)) else str(v)
        return out


def _prop_of(attrs):
    kwargs = {k: v for k, v in attrs.items()
              if k not in ("op_type", "__is_train__")}
    return _operator.make_prop(attrs["op_type"], kwargs)


class _CustomCall:
    """One call of a custom op: its prop, operator, seed and mode, and
    the host side of its forward and backward."""

    def __init__(self, prop, in_shapes, in_dtypes, out_shapes, out_dtypes,
                 is_train, seed, device):
        self.n_args = len(prop.list_arguments())
        self.n_aux = len(prop.list_auxiliary_states())
        self.out_shapes, self.out_dtypes = out_shapes, out_dtypes
        self.in_dtypes = in_dtypes
        self.is_train, self.device = is_train, device
        self.op = prop.create_operator(None, [list(s) for s in in_shapes],
                                       in_dtypes)
        self.op._mxtpu_rng_seed = seed

    @staticmethod
    def _host(tensors):
        return [_operator._HostArray(t.detach().cpu().numpy().copy())
                for t in tensors]

    def _device(self, arr, dtype):
        return torch.from_numpy(_np.ascontiguousarray(
            _np.asarray(arr, dtype))).to(self.device)

    def forward(self, ins):
        in_data = self._host(ins)
        out_data = [_operator._HostArray(_np.zeros(s, d))
                    for s, d in zip(self.out_shapes, self.out_dtypes)]
        aux = in_data[self.n_args:self.n_args + self.n_aux]
        self.op.forward(self.is_train, ["write"] * len(out_data),
                        in_data[:self.n_args], out_data, aux)
        return tuple(self._device(o.asnumpy(), d)
                     for o, d in zip(out_data, self.out_dtypes))

    def backward(self, ins, outs, cts):
        in_data = self._host(ins)
        in_grad = [_operator._HostArray(_np.zeros(x.shape, x.dtype))
                   for x in in_data]
        aux = in_data[self.n_args:self.n_args + self.n_aux]
        self.op.backward(["write"] * len(ins), self._host(cts),
                         in_data[:self.n_args], self._host(outs), in_grad,
                         aux)
        return [self._device(g.asnumpy(), d)
                for g, d in zip(in_grad, self.in_dtypes)]


class _CustomFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, call, *ins):
        outs = call.forward(ins)
        ctx.call = call
        ctx.n_in = len(ins)
        ctx.save_for_backward(*ins, *outs)
        ctx.mark_non_differentiable(
            *[o for o in outs if not o.is_floating_point()])
        return outs

    @staticmethod
    def backward(ctx, *cts):
        saved = ctx.saved_tensors
        ins, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        grads = ctx.call.backward(ins, outs, cts)
        return (None,) + tuple(
            g if need else None
            for g, need in zip(grads, ctx.needs_input_grad[1:]))


def _custom_fn(attrs, generator, *inputs):
    prop = _prop_of(attrs)
    n_args = len(prop.list_arguments())
    in_shapes = [tuple(x.shape) for x in inputs]
    _, out_shapes, _ = prop.infer_shape([list(s) for s in
                                         in_shapes[:n_args]])
    in_dt = [numpy_dtype(x.dtype) for x in inputs]
    _, out_dtypes, _ = prop.infer_type(list(in_dt[:n_args]))
    out_shapes = [tuple(int(d) for d in s) for s in out_shapes]
    out_dtypes = [_np.dtype(d) for d in out_dtypes]
    device = inputs[0].device
    if device.type == "meta":
        return tuple(torch.empty(s, dtype=torch_dtype(d), device="meta")
                     for s, d in zip(out_shapes, out_dtypes))
    is_train = attrs.get("__is_train__")
    if is_train is None:
        from .. import autograd as _ag
        is_train = _ag.is_training()
    seed = int(torch.randint(0, 1 << 32, (1,), generator=generator,
                             device=generator.device).item())
    call = _CustomCall(prop, in_shapes, in_dt, out_shapes, out_dtypes,
                       bool(is_train), seed, device)
    return _CustomFunction.apply(call, *inputs)


def _custom_arg_names(attrs):
    prop = _prop_of(attrs)
    return list(prop.list_arguments()) + list(prop.list_auxiliary_states())


def _custom_n_out(attrs):
    return len(_prop_of(attrs).list_outputs())


def _custom_infer_args(attrs, in_shapes):
    """Fill unknown input shapes from the prop's ``infer_shape``: a prop
    may declare its parameters' and labels' shapes from the data's (the
    graph's shape pass leaves them unknown when this raises)."""
    prop = _prop_of(attrs)
    n_args = len(prop.list_arguments())
    arg_shapes, _, aux_shapes = prop.infer_shape(
        [list(s) if s is not None else None for s in in_shapes[:n_args]])
    full = [tuple(s) if s is not None else None for s in arg_shapes]
    full += [tuple(s) for s in aux_shapes]
    return full + list(in_shapes[len(full):])


register_op(_CustomOpDef(
    "Custom", _custom_fn, arg_names=_custom_arg_names,
    attrs={"op_type": Required(str), "__is_train__": None},
    num_outputs=_custom_n_out, needs_rng=True,
    infer_args=_custom_infer_args, aliases=("_Custom",)))


def _no_gradient(a, device):
    """A node meaning "no gradient flows here": a constant zero (1,)."""
    return torch.zeros((1,), dtype=torch.float32, device=device)


register("_NoGradient", _no_gradient, arg_names=[])
