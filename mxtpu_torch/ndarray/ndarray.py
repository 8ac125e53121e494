"""NDArray over torch.Tensor (the subset serving and Module use).

Counterpart of ``mxtpu/ndarray/ndarray.py``: ``NDArray`` with ``shape``,
``dtype``, ``asnumpy``, ``as_in_context``, ``copyto`` and in-place
``__setitem__`` (an array, or a scalar filling it), and the ``array`` /
``zeros`` constructors. ``dtype`` is the torch dtype (bfloat16 has no
numpy counterpart); ``asnumpy`` returns bfloat16 data as float32. The
optimizers update the tensors behind NDArrays in place
(``optimizer.py``), so no NDArray arithmetic is needed yet.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..context import as_context, current_context
from ..ops.registry import torch_dtype

__all__ = ["NDArray", "array", "zeros", "to_numpy"]


def to_numpy(t):
    """Host numpy copy of a tensor (bfloat16 widened to float32)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


class NDArray:
    """A tensor bound to a Context."""

    __slots__ = ("_data", "_ctx")

    def __init__(self, data, ctx=None):
        self._data = data
        self._ctx = as_context(data.device) if ctx is None else ctx

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def context(self):
        return self._ctx

    def asnumpy(self):
        return to_numpy(self._data)

    def as_in_context(self, ctx):
        ctx = as_context(ctx)
        if ctx == self._ctx:
            return self
        return NDArray(self._data.to(ctx.torch_device), ctx)

    def copyto(self, other):
        """Copy into the NDArray ``other`` (in place) or onto the Context
        ``other`` (a new NDArray); returns the destination."""
        if isinstance(other, NDArray):
            other._data.copy_(self._data.reshape(other._data.shape))
            return other
        ctx = as_context(other)
        return NDArray(self._data.to(ctx.torch_device, copy=True), ctx)

    def __setitem__(self, key, value):
        if isinstance(value, (int, float)):
            if isinstance(key, slice) and key == slice(None):
                self._data.fill_(value)
            else:
                self._data[key] = value
            return
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, torch.Tensor):
            value = torch.as_tensor(_np.asarray(value))
        if isinstance(key, slice) and key == slice(None):
            self._data.copy_(value.reshape(self._data.shape))
        else:
            self._data[key] = value.to(self._data.device)

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(map(str, self.shape)),
                                     self._ctx)


def _device(ctx):
    return (as_context(ctx) if ctx is not None
            else current_context()).torch_device


def array(source_array, ctx=None, dtype=None):
    """NDArray from a numpy array, list, tensor or NDArray (float32
    unless ``dtype`` is given, as in MXNet)."""
    if isinstance(source_array, NDArray):
        source_array = source_array._data
    dt = torch_dtype(dtype) if dtype is not None else torch.float32
    if isinstance(source_array, torch.Tensor):
        t = source_array.to(device=_device(ctx), dtype=dt)
    else:
        t = torch.as_tensor(_np.asarray(source_array), dtype=dt,
                            device=_device(ctx))
    return NDArray(t)


def zeros(shape, ctx=None, dtype="float32"):
    return NDArray(torch.zeros(tuple(shape), dtype=torch_dtype(dtype),
                               device=_device(ctx)))
