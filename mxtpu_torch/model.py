"""The KVStore decision rules, and the checkpoint files:
``prefix-symbol.json``, ``prefix-%04d.params`` and the versioned
``.params.manifest.json`` beside the params.

A copy of ``mxtpu/model.py``: ``BatchEndParam`` (:18), the kvstore
rules (``_create_kvstore`` :20, ``_initialize_kvstore`` :45,
``_update_params_on_kvstore`` :54, ``_update_params`` :65), the
checkpoint part (``_checkpoint_manifest`` :81, ``save_checkpoint`` :100,
``load_checkpoint`` :142), in mxtpu's formats, so a checkpoint written by
either package loads in the other, and the legacy ``FeedForward``
(:157-273) over the port's ``Module``. Writes are synchronous: mxtpu's
``async_write`` goes through its elastic snapshot writer, which is not
ported, so asking for it raises, and ``wait_checkpoints`` returns at
once.
"""
from __future__ import annotations

import json
import logging
import os
import time
from collections import namedtuple

import numpy as _np

from . import ndarray as nd
from . import symbol as sym
from .base import MXNetError
from .kvstore import KVStore
from .kvstore import create as _create_kv
from .ndarray.ndarray import dtype_name

__all__ = ["BatchEndParam", "FeedForward", "save_checkpoint",
           "load_checkpoint", "checkpoint_manifest", "wait_checkpoints"]

#: what a batch-end callback receives
BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


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


def wait_checkpoints(prefix=None):
    """Block until pending checkpoint writes are durable: the port writes
    synchronously, so there is never one."""
    del prefix


class FeedForward:
    """The legacy training API (mxtpu/model.py:157), over ``Module``:
    ``fit`` on numpy arrays or a DataIter, ``predict`` in row order (with
    ``return_data`` also the data and labels it ran, as the reference
    returns them), ``score``, ``save``/``load`` through the checkpoint
    files, ``create``."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from .initializer import Uniform
        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer or Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = kwargs.copy()
        self._module = None

    def _get_module(self, data_names=("data",),
                    label_names=("softmax_label",)):
        from .module import Module
        if self._module is None:
            ctx = self.ctx if isinstance(self.ctx, list) else \
                [self.ctx] if self.ctx else None
            self._module = Module(self.symbol, data_names=list(data_names),
                                  label_names=list(label_names), context=ctx)
        return self._module

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        data = self._prepare_iter(X, y, shuffle=True)
        label_name = data.provide_label[0][0] if data.provide_label \
            else "softmax_label"
        mod = self._get_module(
            data_names=[d[0] for d in data.provide_data],
            label_names=[label_name])
        params = {k: v for k, v in self.kwargs.items()
                  if k != "learning_rate"}
        params["learning_rate"] = self.kwargs.get("learning_rate", 0.01)
        mod.fit(data, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer, optimizer_params=params,
                eval_end_callback=eval_end_callback,
                eval_batch_end_callback=eval_batch_end_callback,
                initializer=self.initializer, arg_params=self.arg_params,
                aux_params=self.aux_params, begin_epoch=self.begin_epoch,
                num_epoch=self.num_epoch, monitor=monitor)
        self.arg_params, self.aux_params = mod.get_params()

    def _prepare_iter(self, X, y=None, shuffle=False):
        """numpy -> NDArrayIter; only training shuffles, so predict and
        score keep the caller's row order."""
        from .io import DataIter, NDArrayIter
        if isinstance(X, DataIter):
            return X
        return NDArrayIter(X, y, batch_size=self.numpy_batch_size,
                           shuffle=shuffle)

    def _bound(self, data, with_labels):
        # an iterator without labels keeps the default label name (mxtpu
        # passes None there and fails on a fresh model)
        mod = self._get_module(
            data_names=[d[0] for d in data.provide_data],
            label_names=[lb[0] for lb in data.provide_label] or
            ["softmax_label"])
        if not mod.binded:
            mod.bind(data_shapes=data.provide_data,
                     label_shapes=data.provide_label if with_labels
                     else None, for_training=False)
            mod.set_params(self.arg_params or {}, self.aux_params or {},
                           allow_missing=True)
        return mod

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """The outputs (a numpy array, or a list with several outputs) of
        ``X`` in row order; with ``return_data``, (outputs, data, label),
        each a numpy array concatenated over the batches, pads trimmed."""
        data = self._prepare_iter(X)
        mod = self._bound(data, False)
        if not return_data:
            outs = mod.predict(data, num_batch=num_batch, reset=reset)
            return outs.asnumpy() if not isinstance(outs, list) else \
                [o.asnumpy() for o in outs]
        outs, xs, ys = [], [], []
        for out, _, batch in mod.iter_predict(data, num_batch=num_batch,
                                              reset=reset):
            keep = out[0].shape[0]
            outs.append([o.asnumpy() for o in out])
            xs.append(batch.data[0].asnumpy()[:keep])
            if batch.label:
                ys.append(batch.label[0].asnumpy()[:keep])
        merged = [_np.concatenate([o[i] for o in outs])
                  for i in range(len(outs[0]))]
        return (merged[0] if len(merged) == 1 else merged,
                _np.concatenate(xs), _np.concatenate(ys) if ys else None)

    def score(self, X, eval_metric="acc", num_batch=None, **kwargs):
        from . import metric as _metric
        data = self._prepare_iter(X)
        mod = self._bound(data, True)
        res = mod.score(data, _metric.create(eval_metric),
                        num_batch=num_batch)
        return res[0][1]

    def save(self, prefix, epoch=None):
        if epoch is None:
            epoch = self.num_epoch
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=None, eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               **kwargs):
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger)
        return model
