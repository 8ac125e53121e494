"""Checkpoint files: ``prefix-symbol.json``, ``prefix-%04d.params`` and
the versioned ``.params.manifest.json`` beside the params.

A copy of ``mxtpu/model.py``'s checkpoint part (``_checkpoint_manifest``
:81, ``save_checkpoint`` :100, ``load_checkpoint`` :142), in mxtpu's
formats, so a checkpoint written by either package loads in the other.
Writes are synchronous: mxtpu's ``async_write`` goes through its elastic
snapshot writer, which is not ported, so asking for it raises.
"""
from __future__ import annotations

import json
import logging
import os
import time

from . import ndarray as nd
from . import symbol as sym
from .base import MXNetError
from .ndarray.ndarray import dtype_name

__all__ = ["save_checkpoint", "load_checkpoint", "checkpoint_manifest"]


def checkpoint_manifest(save_dict, epoch):
    """The manifest written beside every checkpoint: per-array shape and
    dtype and the arg/aux name lists, so a loader can check the file
    without parsing the binary, and a format tag."""
    return {
        "format": "mxtpu-checkpoint-1",
        "version": 1,
        "epoch": int(epoch),
        "time": round(time.time(), 3),
        "params": sorted(k[4:] for k in save_dict if k.startswith("arg:")),
        "aux": sorted(k[4:] for k in save_dict if k.startswith("aux:")),
        "arrays": {k: {"shape": list(v.shape),
                       "dtype": dtype_name(v.dtype)}
                   for k, v in save_dict.items()},
    }


def _write_atomic(path, data):
    """tmp + fsync + rename: the file has either all of ``data`` or its
    previous content."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def refuse_async(async_write):
    if async_write:
        raise MXNetError("save_checkpoint(async_write=True) needs the "
                         "elastic snapshot writer, which is not ported yet "
                         "(ROADMAP A.12); write synchronously")


def save_params(param_name, epoch, arg_params, aux_params):
    """``param_name`` (arg:/aux: names) and its manifest."""
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    nd.save(param_name, save_dict)
    _write_atomic(param_name + ".manifest.json", json.dumps(
        checkpoint_manifest(save_dict, epoch), indent=1).encode())
    logging.info('Saved checkpoint to "%s"', param_name)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    async_write=False):
    """prefix-symbol.json + prefix-%04d.params + the manifest (parity
    model.py:340)."""
    refuse_async(async_write)
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_params("%s-%04d.params" % (prefix, epoch), epoch, arg_params,
                aux_params)


def split_params(save_dict, fname):
    """(arg_params, aux_params) of a loaded ``.params`` dict."""
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        kind, name = k.split(":", 1)
        if kind == "arg":
            arg_params[name] = v
        elif kind == "aux":
            aux_params[name] = v
        else:
            raise MXNetError("invalid param file %s: key %r" % (fname, k))
    return arg_params, aux_params


def load_checkpoint(prefix, epoch):
    """(symbol, arg_params, aux_params), the params as cpu() NDArrays."""
    symbol = sym.load("%s-symbol.json" % prefix)
    fname = "%s-%04d.params" % (prefix, epoch)
    return (symbol,) + split_params(nd.load(fname), fname)
