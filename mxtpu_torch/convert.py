"""Carry weights from the JAX package's format to the port's.

Both packages name parameters alike (``arg:``/``aux:`` prefixes, the same
symbol variable names) and store FullyConnected weights as
``(num_hidden, in)``, so the conversion copies values one to one. Gluon
parameters are matched with the block's prefix stripped: both packages
count block names process-wide (``mxtpu/gluon/block.py:68``), so the
same net gets other prefixes in the two packages, and from run to run.
"""
from __future__ import annotations

import numpy as _np
import torch

from .base import MXNetError
from .context import as_context
from .ndarray import NDArray

__all__ = ["params_from_mxtpu", "gluon_params_from_mxtpu"]


def params_from_mxtpu(params, device):
    """``{name: array}`` of the JAX package (numpy values, or objects with
    ``asnumpy()``) -> ``{name: NDArray}`` on ``device`` (a Context, a
    torch.device or a device string). Names and dtypes are kept."""
    ctx = as_context(device)
    dev = ctx.torch_device
    out = {}
    for name, v in params.items():
        arr = _np.ascontiguousarray(v.asnumpy() if hasattr(v, "asnumpy")
                                    else _np.asarray(v))
        out[name] = NDArray(torch.from_numpy(arr.copy()).to(dev), ctx)
    return out


def gluon_params_from_mxtpu(params, device, block=None):
    """``{name without the block prefix: array}`` of an mxtpu Gluon block
    (numpy values, or objects with ``asnumpy()``) -> the same dict of
    NDArrays on ``device``; with ``block`` (a port Block) also load them
    into its Parameters by the same stripped names, initializing any
    still deferred, as ``load_params`` does. Every name must match."""
    out = params_from_mxtpu(params, device)
    if block is not None:
        pd = block.collect_params()
        prefix = block.prefix
        names = {k[len(prefix):]: p for k, p in pd.items()}
        if sorted(names) != sorted(out):
            raise MXNetError("gluon_params_from_mxtpu: the block's "
                             "parameters %s are not the given %s"
                             % (sorted(names), sorted(out)))
        for k, v in out.items():
            names[k]._load_init(v, as_context(device))
    return out
