"""Carry weights from the JAX package's format to the port's.

Both packages name parameters alike (``arg:``/``aux:`` prefixes, the same
symbol variable names) and store FullyConnected weights as
``(num_hidden, in)``, so the conversion copies values one to one.
"""
from __future__ import annotations

import numpy as _np
import torch

from .context import as_context
from .ndarray import NDArray

__all__ = ["params_from_mxtpu"]


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
