"""KVStore: parameter synchronisation over torch's collectives.

Counterpart of ``mxtpu/kvstore.py`` (``KVStore`` :69, ``init`` :200,
``_local_merge`` :289, ``push`` :306, ``_apply_push`` :340, ``pull``
:364, ``set_optimizer`` :451, ``save_optimizer_states`` /
``load_optimizer_states`` :504-520, ``create`` :535).

- ``local`` / ``device``: one process. ``push`` of a list sums it onto
  the first value's device, then runs the updater on the stored value,
  or stores the sum. ``pull`` copies the stored value into each ``out``
  on its own device, in place, so the arrays an executor or a Parameter
  holds stay the same tensors.
- ``dist_sync`` / ``dist_device_sync``: several processes. ``push`` also
  sums the merged value over the processes with one
  ``torch.distributed.all_reduce``: NCCL for CUDA values, gloo for CPU
  values. ``create`` uses the process group the process has joined, or
  joins one from torch's ``env://`` variables (``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``) when ``WORLD_SIZE``
  is above 1; with neither the store is one worker, as mxtpu's is when
  ``jax.process_count() == 1``.
- ``row_sparse_pull`` (mxtpu's :401): into a ``RowSparseNDArray`` out,
  the unique requested rows of the stored value, gathered on the store's
  device; into a dense out, the whole value. Every kind above serves it
  from the worker's own copy, which the push keeps equal on every
  worker. ``dist_async`` (mxtpu's TCP parameter server, whose
  ``pull_rows`` ships only the rows) raises.
- The mesh veneer (mxtpu's :211-290): with a 1-D data mesh active
  (``sharding.current()``), a ``local``/``device`` push of one value per
  mesh device is one all-reduce over the mesh (``sum_replicas``: NCCL
  on CUDA), counted in ``mesh_allreduces``; without an updater each
  device keeps its copy of the sum and ``pull`` hands each ``out`` the
  copy on its own device. A value list that does not cover the mesh's
  devices, a multi-axis mesh or a ``dist`` store takes the path above.

The optimizer runs on each worker after the all-reduce, mxtpu's
"sync server" semantics; there is no server process.
"""
from __future__ import annotations

import os
import pickle

import torch

from . import optimizer as opt
from . import sharding as _sharding
from .base import MXNetError
from .ops.collective import sum_replicas
from .ndarray import NDArray
from .ndarray.sparse import BaseSparseNDArray, RowSparseNDArray

__all__ = ["KVStore", "create"]

_KINDS = ("local", "device", "local_allreduce_cpu", "local_allreduce_device",
          "dist_sync", "dist_device_sync", "dist_async", "dist_sync_device",
          "nccl")


def _process_group():
    """``torch.distributed`` with its default group: the process's own
    where it has joined one (of any size), else joined from the
    ``env://`` variables when ``WORLD_SIZE`` > 1; None for a single
    worker. The group it joins carries both backends: gloo for CPU
    tensors, NCCL for CUDA tensors (where CUDA is present)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    if not dist.is_available():
        raise MXNetError("dist kvstore: torch.distributed is not available")
    backend = "gloo"
    if torch.cuda.is_available():
        backend = "cpu:gloo,cuda:nccl"
        if "LOCAL_RANK" in os.environ:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(backend=backend, init_method="env://")
    return dist


def _raw(v):
    return getattr(v, "_data", v)


def _pull_into(dst, src, row_ids=None):
    """Write the stored value ``src`` into the out ``dst``: given
    ``row_ids``, a ``RowSparseNDArray`` holds the unique requested rows,
    gathered on the store's device; another sparse out is rebound to a
    copy of the whole value (mxtpu's rebinding); a dense out is copied
    into in place."""
    if row_ids is not None and isinstance(dst, RowSparseNDArray):
        rows = torch.unique(row_ids._data.to(src.device, torch.int64)
                            .reshape(-1))
        dst._set_rows(src[rows], rows)
    elif isinstance(dst, BaseSparseNDArray):
        dst._data = src.to(dst.context.torch_device, copy=True)
    else:
        dst._data.copy_(src)


class KVStore:
    def __init__(self, kind="local"):
        if kind == "dist_async":
            raise MXNetError(
                "kvstore dist_async needs mxtpu's TCP parameter server "
                "(kvstore_server.py), not ported yet (ROADMAP A.4: "
                "dist_async and the server)")
        self._kind = kind
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._dist = _process_group() if kind.startswith("dist") else None
        # key -> {context: its copy of the last mesh all-reduce}
        self._replicas = {}
        self.mesh_allreduces = 0

    # ------------------------------------------------ identity
    @property
    def type(self):
        return self._kind

    @property
    def rank(self):
        return self._dist.get_rank() if self._dist is not None else 0

    @property
    def num_workers(self):
        return self._dist.get_world_size() if self._dist is not None else 1

    # ------------------------------------------------ core ops
    def init(self, key, value):
        """Store a copy of each value (the first of a list), on its
        device."""
        keys, values = self._normalize(key, value)
        for k, v in zip(keys, values):
            arr = v[0] if isinstance(v, list) else v
            self._store[k] = NDArray(_raw(arr).detach().clone(),
                                     arr.context)

    @staticmethod
    def _local_merge(vlist):
        """The sum of a per-device value list on the first value's
        device, added in list order (mxtpu's ``_local_merge``); a list of
        one is that value itself."""
        if len(vlist) == 1:
            return vlist[0]
        dev = _raw(vlist[0]).device
        acc = _raw(vlist[0]).detach()
        for x in vlist[1:]:
            acc = acc + _raw(x).detach().to(dev)
        return NDArray(acc, vlist[0].context)

    def _mesh_align(self, vlist):
        """``vlist`` in mesh order when it holds one value on each device
        of an active 1-D data mesh (and the store is not ``dist``); else
        None."""
        if self._dist is not None or len(vlist) < 2:
            return None
        mctx = _sharding.current()
        if mctx is None or mctx.mesh.axis_names != (mctx.layout.data_axis,):
            return None
        devices = mctx.devices
        by_ctx = {getattr(v, "context", None): v for v in vlist}
        if len(vlist) != len(devices) or set(by_ctx) != set(devices):
            return None
        return [by_ctx[c] for c in devices]

    def _mesh_merge(self, ordered):
        """One all-reduce of ``ordered`` (copies; the callers' arrays stay
        as they were): each device's copy of the sum, in mesh order."""
        sums = [_raw(v).detach().clone() for v in ordered]
        sum_replicas(sums)
        self.mesh_allreduces += 1
        return [NDArray(t, v.context) for t, v in zip(sums, ordered)]

    def push(self, key, value, priority=0):
        """Sum the pushed values of each key (over the list, then over
        the workers); run the updater on the stored value, or store the
        sum."""
        del priority
        keys, values = self._normalize(key, value)
        for k, v in zip(keys, values):
            vlist = v if isinstance(v, list) else [v]
            self._replicas.pop(k, None)
            ordered = self._mesh_align(vlist)
            if ordered is not None:
                sums = self._mesh_merge(ordered)
                stored = self._store.get(k)
                mine = next((x for x in sums if stored is not None
                             and x.context == stored.context), sums[0])
                self._apply_push(k, mine)
                if self._updater is None:
                    self._replicas[k] = {x.context: x._data for x in sums}
                continue
            merged = self._local_merge(vlist)
            if self._dist is not None:
                t = _raw(merged).detach()
                if merged is vlist[0]:
                    t = t.clone()  # the caller's array stays as it was
                self._dist.all_reduce(t)
                merged = NDArray(t, merged.context)
            self._apply_push(k, merged)

    def _apply_push(self, k, merged):
        if k not in self._store:
            self._store[k] = NDArray(_raw(merged).detach().clone(),
                                     merged.context)
            return
        stored = self._store[k]
        if self._updater is not None:
            self._updater(self._key_int(k), merged, stored)
            return
        with torch.no_grad():
            stored._data.copy_(_raw(merged))

    def pull(self, key, out=None, priority=0):
        """Copy each key's stored value into every array of ``out``, in
        place, on the array's own device."""
        del priority
        if out is None:
            raise MXNetError("pull: out is required")
        keys, outs = self._normalize(key, out)
        with torch.no_grad():
            for k, o in zip(keys, outs):
                if k not in self._store:
                    raise MXNetError("pull: key %r was never initialized"
                                     % (k,))
                src = self._store[k]._data
                copies = self._replicas.get(k, {})
                for dst in (o if isinstance(o, list) else [o]):
                    _pull_into(dst, copies.get(dst.context, src))

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows ``row_ids`` (an NDArray, or one a out) of
        each key: a ``RowSparseNDArray`` out holds the unique requested
        rows, in order, as its data; a dense out gets the whole value."""
        del priority
        if out is None or row_ids is None:
            raise MXNetError("row_sparse_pull requires out and row_ids")
        keys, outs = self._normalize(key, out)
        rids = row_ids if isinstance(row_ids, list) else [row_ids]
        with torch.no_grad():
            for k, o in zip(keys, outs):
                if k not in self._store:
                    raise MXNetError("row_sparse_pull: key %r was never "
                                     "initialized" % (k,))
                olist = o if isinstance(o, list) else [o]
                rlist = rids if len(rids) == len(olist) \
                    else rids * len(olist)
                copies = self._replicas.get(k, {})
                for dst, rid in zip(olist, rlist):
                    _pull_into(dst, copies.get(dst.context,
                                               self._store[k]._data), rid)

    # ------------------------------------------------ updater / optimizer
    def set_updater(self, updater):
        self._updater = updater

    def set_optimizer(self, optimizer):
        """The optimizer runs on every worker after the sum (mxtpu's
        worker-side update, the sync server's semantics)."""
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    # ------------------------------------------------ cluster control
    def barrier(self):
        if self._dist is not None:
            self._dist.barrier()

    def close(self):
        """Nothing to stop: the store holds no connection. The process
        group, where one was joined, belongs to the process."""

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("optimizer is not set")
        payload = self._updater.get_states()
        if dump_optimizer:
            payload = pickle.dumps((payload, self._optimizer))
        with open(fname, "wb") as f:
            f.write(payload)

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("optimizer is not set")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    # ------------------------------------------------ helpers
    @staticmethod
    def _key_int(k):
        try:
            return int(k)
        except (TypeError, ValueError):
            return k

    @staticmethod
    def _normalize(key, value):
        if isinstance(key, (str, int)):
            return [key], [value]
        if len(key) != len(value):
            raise MXNetError("%d keys and %d values" % (len(key),
                                                        len(value)))
        return list(key), list(value)


def create(name="local"):
    """A KVStore of kind ``name`` (mxtpu's ``create``)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name not in _KINDS:
        raise MXNetError("Unknown KVStore type %s" % name)
    return KVStore(name)
