"""NDArray over torch.Tensor (the subset serving and Module use).

Counterpart of ``mxtpu/ndarray/ndarray.py``: ``NDArray`` with ``shape``,
``dtype``, ``asnumpy``, ``as_in_context``, ``copyto`` and in-place
``__setitem__`` (an array, or a scalar filling it), and the ``array`` /
``zeros`` constructors. ``dtype`` is the torch dtype (bfloat16 has no
numpy counterpart); ``asnumpy`` returns bfloat16 data as float32. The
optimizers update the tensors behind NDArrays in place
(``optimizer.py``), so no NDArray arithmetic is needed yet.

``save`` and ``load`` read and write mxtpu's binary format (a copy of
``mxtpu/ndarray/ndarray.py:574-686``), so a file written by either
package loads in the other, bit for bit.
"""
from __future__ import annotations

import json
import struct
from contextlib import nullcontext

import numpy as _np
import torch

from ..base import MXNetError
from ..context import as_context, cpu, current_context
from ..ops.registry import torch_dtype

__all__ = ["NDArray", "array", "zeros", "to_numpy", "host_copies", "save",
           "load"]


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
    unless ``dtype`` is given, as in MXNet): always a copy, so the
    in-place writes of training (the optimizer's, the aux writeback)
    never reach the source."""
    if isinstance(source_array, NDArray):
        source_array = source_array._data
    dt = torch_dtype(dtype) if dtype is not None else torch.float32
    if not isinstance(source_array, torch.Tensor):
        source_array = torch.from_numpy(_np.asarray(source_array))
    return NDArray(source_array.to(device=_device(ctx), dtype=dt,
                                   copy=True))


def zeros(shape, ctx=None, dtype="float32"):
    return NDArray(torch.zeros(tuple(shape), dtype=torch_dtype(dtype),
                               device=_device(ctx)))


# ---------------------------------------------------------------- serialization
# mxtpu's format (parity role of NDArray::Save/Load ndarray.h:361-373):
#   magic 'MXTPU001' | int64 n | per item: int64 len, name | int64 len,
#   JSON header {"shape", "dtype"} | int64 len, raw little-endian bytes
_MAGIC = b"MXTPU001"


def dtype_name(dtype):
    """numpy's name of a torch dtype ("float32", "bfloat16", ...), the
    name the file header and the checkpoint manifest carry."""
    return str(dtype).rsplit(".", 1)[-1]


def host_copies(tensors):
    """cpu() copies of many tensors with one device->host copy per dtype:
    the device tensors of one dtype are concatenated on their device,
    copied once, and split on the host. Host tensors are cloned."""
    out = [None] * len(tensors)
    groups = {}
    for i, t in enumerate(tensors):
        t = t.detach()
        if t.device.type == "cpu":
            out[i] = t.clone()
        else:
            groups.setdefault((t.device, t.dtype), []).append(i)
    for idxs in groups.values():
        flat = torch.cat([tensors[i].detach().reshape(-1)
                          for i in idxs]).cpu()
        for i, part in zip(idxs, torch.split(
                flat, [tensors[i].numel() for i in idxs])):
            out[i] = part.reshape(tensors[i].shape)
    return out


def _raw_bytes(t):
    """(numpy name of the dtype, the tensor's bytes) of a host tensor."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:  # numpy has no bfloat16: its bits
        return "bfloat16", t.view(torch.int16).numpy().tobytes()
    return dtype_name(t.dtype), t.numpy().tobytes()


def save(fname, data):
    """Save NDArrays (or tensors): a list, or a dict by name (parity
    mx.nd.save). Every array reaches the host in one copy per dtype."""
    if isinstance(data, (NDArray, torch.Tensor)):
        data = [data]
    items = list(data.items()) if isinstance(data, dict) else \
        [("", v) for v in data]
    host = host_copies([getattr(v, "_data", v) for _, v in items])
    with open(fname, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<q", len(items)))
        for (name, _), t in zip(items, host):
            dtype, raw = _raw_bytes(t)
            hdr = json.dumps({"shape": list(t.shape),
                              "dtype": dtype}).encode()
            for chunk in (name.encode(), hdr, raw):
                f.write(struct.pack("<q", len(chunk)))
                f.write(chunk)


def _from_raw(raw, dtype, shape):
    if dtype == "bfloat16":
        arr = _np.frombuffer(raw, dtype=_np.int16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    arr = _np.frombuffer(raw, dtype=_np.dtype(dtype)).reshape(shape)
    return torch.from_numpy(arr.copy())


def load(fname):
    """Load NDArrays written by ``save`` (either package's): a dict when
    the file names them, else a list, of cpu() NDArrays in the stored
    dtype, as the reference loads onto the host. ``fname`` is a path or
    a binary file object."""
    opened = nullcontext(fname) if hasattr(fname, "read") else \
        open(fname, "rb")
    named, unnamed = {}, []
    with opened as f:
        if f.read(8) != _MAGIC:
            raise MXNetError("invalid NDArray file %s" % (fname,))

        def chunk():
            (n,) = struct.unpack("<q", f.read(8))
            return f.read(n)

        (n,) = struct.unpack("<q", f.read(8))
        for _ in range(n):
            name = chunk().decode()
            hdr = json.loads(chunk().decode())
            arr = NDArray(_from_raw(chunk(), hdr["dtype"], hdr["shape"]),
                          cpu())
            if name:
                named[name] = arr
            else:
                unnamed.append(arr)
    return named if named else unnamed
