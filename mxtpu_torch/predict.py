"""Standalone inference API.

Counterpart of ``mxtpu/predict.py``: ``Predictor`` with ``arg:``/``aux:``
weight loading, the shape-keyed bind cache (``_bind``/``_bind_fresh``
:112-150), ``set_input`` (float32, as :158), ``forward``, ``reshape`` and
``get_outputs``. Unlike the JAX package, which defaults to ``cpu()``, a
Predictor given no context runs on ``gpu(0)`` and raises without CUDA.
Weights are taken as a dict of NDArrays, tensors or numpy arrays; the
serialized-bytes form of ``nd.load`` is not ported yet.
"""
from __future__ import annotations

from collections import OrderedDict as _OrderedDict

import numpy as _np
import torch

from . import ndarray as nd
from . import symbol as sym_mod
from .base import MXNetError
from .context import as_context, current_context

__all__ = ["Predictor", "to_host"]


def to_host(tensors):
    """Numpy copies of output tensors: one device->host copy per output,
    each waiting for the device (the LM has a single output)."""
    return [nd.to_numpy(t) for t in tensors]


def _as_tensor(v, device):
    if isinstance(v, nd.NDArray):
        v = v._data
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.as_tensor(_np.asarray(v), device=device)


class Predictor:
    """One bound inference graph (parity: the PredictorHandle object)."""

    def __init__(self, symbol_json_str, params, ctx=None, input_shapes=None,
                 max_cached_binds=8):
        if input_shapes is None:
            raise MXNetError("Predictor requires input_shapes")
        if isinstance(params, (bytes, bytearray)):
            raise MXNetError("Predictor: serialized params are not ported "
                             "yet; pass a dict of arrays")
        self._ctx = as_context(ctx) if ctx is not None else current_context()
        device = self._ctx.torch_device
        self._symbol = sym_mod.load_json(symbol_json_str) \
            if isinstance(symbol_json_str, str) else symbol_json_str
        self._arg_params = {}
        self._aux_params = {}
        for k, v in params.items():
            # weights land on THIS predictor's device exactly once
            arr = nd.NDArray(_as_tensor(v, device), self._ctx)
            if k.startswith("aux:"):
                self._aux_params[k[4:]] = arr
            else:
                self._arg_params[k[4:] if k.startswith("arg:") else k] = arr
        self._input_shapes = {k: tuple(v) for k, v in input_shapes.items()}
        self._max_cached_binds = max(1, int(max_cached_binds))
        self._bind_cache = _OrderedDict()  # shape key -> (exec, args, outs)
        self._bind()

    @staticmethod
    def shape_key(input_shapes):
        """The bind-cache key for an input-shape dict."""
        return tuple(sorted((k, tuple(v)) for k, v in input_shapes.items()))

    def _bind(self):
        key = self.shape_key(self._input_shapes)
        hit = self._bind_cache.get(key)
        if hit is not None:
            self._bind_cache.move_to_end(key)
            self._executor, self._arg_arrays, self._out_shapes = hit
            return
        self._bind_fresh()
        self._bind_cache[key] = (self._executor, self._arg_arrays,
                                 self._out_shapes)
        while len(self._bind_cache) > self._max_cached_binds:
            self._bind_cache.popitem(last=False)

    def _bind_fresh(self):
        symbol = self._symbol
        arg_shapes, out_shapes, aux_shapes = symbol.infer_shape(
            **self._input_shapes)
        args = {}
        for name, shape in zip(symbol.list_arguments(), arg_shapes):
            if name in self._input_shapes or name not in self._arg_params:
                # inputs, and unfed non-param args (e.g. softmax_label,
                # dead in the inference graph), bind zeros
                args[name] = nd.zeros(shape, self._ctx)
            else:
                args[name] = self._arg_params[name]
        aux = {}
        for name in symbol.list_auxiliary_states():
            if name not in self._aux_params:
                raise MXNetError("predictor: missing aux state %s" % name)
            aux[name] = self._aux_params[name]
        self._executor = symbol.bind(self._ctx, args, aux_states=aux)
        self._arg_arrays = args
        self._out_shapes = out_shapes

    def set_input(self, name, value):
        """MXPredSetInput: the value is cast to float32 and copied into
        the bound input."""
        if name not in self._input_shapes:
            raise MXNetError("unknown input %s" % name)
        value = _np.asarray(value, dtype=_np.float32)
        if tuple(value.shape) != tuple(self._input_shapes[name]):
            raise MXNetError("input %s shape %s != bound shape %s" % (
                name, value.shape, self._input_shapes[name]))
        self._arg_arrays[name][:] = value

    def forward(self, **inputs):
        """MXPredForward (optionally setting inputs in one call)."""
        for k, v in inputs.items():
            self.set_input(k, v)
        self._executor.forward(is_train=False)

    def get_output(self, index=0):
        """MXPredGetOutput -> numpy."""
        return self._executor.outputs[index].asnumpy()

    def get_outputs(self):
        """Every output as numpy (one device->host copy each)."""
        return to_host([o._data for o in self._executor.outputs])

    def get_output_shape(self, index=0):
        return tuple(self._out_shapes[index])

    def reshape(self, new_input_shapes):
        """MXPredReshape: rebind with new shapes. Weights are reused, and a
        shape set seen before reuses its cached executor."""
        self._input_shapes.update(
            {k: tuple(v) for k, v in new_input_shapes.items()})
        self._bind()
