"""The KVStore decision rules, and the checkpoint files:
``prefix-symbol.json``, ``prefix-%04d.params`` and the versioned
``.params.manifest.json`` beside the params.

A copy of ``mxtpu/model.py``: the kvstore rules (``_create_kvstore``
:20, ``_initialize_kvstore`` :45, ``_update_params_on_kvstore`` :54,
``_update_params`` :65) and the checkpoint part (``_checkpoint_manifest``
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
from .kvstore import KVStore
from .kvstore import create as _create_kv
from .ndarray.ndarray import dtype_name

__all__ = ["save_checkpoint", "load_checkpoint", "checkpoint_manifest"]


def _create_kvstore(kvstore, num_device, arg_params):
    """(kvstore or None, update_on_kvstore): one device and not ``dist``
    needs no store; ``local`` with a parameter over 16 M elements updates
    on the devices, not on the store (mxtpu/model.py:20-42)."""
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            kv = _create_kv(kvstore)
            if kvstore == "local":
                max_size = max(p.size for p in arg_params.values()) \
                    if arg_params else 0
                if max_size > 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    for idx, param_on_devs in enumerate(param_arrays):
        name = param_names[idx]
        kvstore.init(name, arg_params[name])
        if update_on_kvstore:
            kvstore.pull(name, param_on_devs, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore,
                              param_names):
    for index, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                      grad_arrays)):
        if grad_list[0] is None:
            continue
        name = param_names[index]
        kvstore.push(name, grad_list, priority=-index)
        kvstore.pull(name, arg_list, priority=-index)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    for index, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                      grad_arrays)):
        if grad_list[0] is None:
            continue
        if kvstore:
            name = param_names[index]
            kvstore.push(name, grad_list, priority=-index)
            kvstore.pull(name, grad_list, priority=-index)
        for k, (w, g) in enumerate(zip(arg_list, grad_list)):
            updater(index * num_device + k, g, w)


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
