"""Gluon utilities.

Counterpart of ``mxtpu/gluon/utils.py``: ``split_data``,
``split_and_load`` (each slice copied onto its own context),
``clip_global_norm`` (over arrays on any devices) and ``check_sha1``. ``download``
raises: the port fetches nothing over the network.
"""
from __future__ import annotations

import hashlib
import math

import torch

from .. import ndarray as nd
from ..base import MXNetError
from ..ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    size = data.shape[batch_axis]
    if size < num_slice:
        raise ValueError(
            "Too many slices for data with shape %s. Arguments are "
            "num_slice=%d and batch_axis=%d." % (str(data.shape), num_slice,
                                                 batch_axis))
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices along "
            "axis %d. Use a batch size that's multiple of %d or set "
            "even_split=False to allow uneven partitioning of data." % (
                str(data.shape), num_slice, batch_axis, num_slice))
    step = size // num_slice
    if batch_axis == 0:
        return [data[i * step:(i + 1) * step] if i < num_slice - 1
                else data[i * step:size] for i in range(num_slice)]
    return [nd.slice_axis(data, axis=batch_axis, begin=i * step,
                          end=(i + 1) * step if i < num_slice - 1 else size)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    if not isinstance(data, NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [i.as_in_context(ctx) for i, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm):
    """Rescale ``arrays`` in place so that the 2-norm of them all is at
    most ``max_norm``; returns that norm before the rescale."""
    if not arrays:
        raise MXNetError("clip_global_norm: no arrays")
    # each array's sum of squares on its own device, added on the first
    # array's device: one host read for arrays on any set of devices
    dev = arrays[0]._data.device
    total = sum(torch.sum(torch.square(arr._data.detach())).to(dev)
                for arr in arrays)
    total_norm = math.sqrt(float(total))
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        for arr in arrays:
            arr *= scale
    return total_norm


def check_sha1(filename, sha1_hash):
    """Whether the file's sha1 matches (parity utils.py check_sha1)."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            sha1.update(chunk)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None):
    raise MXNetError("download(%r): the port fetches nothing over the "
                     "network; place the file locally" % (url,))
