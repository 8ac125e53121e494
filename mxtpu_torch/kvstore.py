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
- Under a cluster environment whose role is ``worker``
  (``kvstore_server.cluster_env``: a server started as ``python -m
  mxtpu_torch.kvstore_server``, mxtpu's ``tools/launch.py`` layout),
  every ``dist_*`` kind goes over the TCP parameter server
  (``kvstore_server.KVClient``, mxtpu's :70-172): the client starts its
  heartbeat, ``dist_async`` switches the server to async mode, then a
  barrier. ``push`` sends the merged value, ``pull`` copies the server's
  value into each out in place, ``set_optimizer`` pickles the optimizer
  to the server, which runs it.
- ``dist_async`` in a ``torch.distributed`` job (``env://``): rank 0
  hosts an async ``KVServer`` in a thread at ``MASTER_PORT + 1000`` on
  ``MASTER_ADDR`` (``MXTPU_ASYNC_PS_URI``/``MXTPU_ASYNC_PS_PORT`` override
  both) and every rank connects: a push applies at once and a pull never
  waits for another worker (mxtpu's :101-149). With no cluster it is one
  worker.
- ``row_sparse_pull`` (mxtpu's :401): into a ``RowSparseNDArray`` out,
  the unique requested rows of the stored value, gathered on the store's
  device; into a dense out, the whole value. Every kind above serves it
  from the worker's own copy, which the push keeps equal on every
  worker; over the TCP server (below) a ``RowSparseNDArray`` out gets
  only the requested rows from the server (``pull_rows``, mxtpu's
  :401-433) and a dense out the server's whole value.
- The mesh veneer (mxtpu's :211-290): with a 1-D data mesh active
  (``sharding.current()``), a ``local``/``device`` push of one value per
  mesh device is one all-reduce over the mesh (``sum_replicas``: NCCL
  on CUDA), counted in ``mesh_allreduces``; without an updater each
  device keeps its copy of the sum and ``pull`` hands each ``out`` the
  copy on its own device. A value list that does not cover the mesh's
  devices, a multi-axis mesh or a ``dist`` store takes the path above.

Without the TCP server the optimizer runs on each worker after the
all-reduce, mxtpu's "sync server" semantics; over it, on the server.
``barrier``, ``send_command_to_servers``, ``num_dead_node`` and
``close`` follow mxtpu's :440-520.

Telemetry and faults (mxtpu's :41-47, :79-96, :304-400): ``push`` and
``pull`` open the ``kvstore.push``/``kvstore.pull`` spans, observe
``kvstore_push_ms``/``kvstore_pull_ms`` and count
``kvstore_push_bytes``/``kvstore_pull_bytes``; a mesh merge counts
``kvstore_mesh_allreduce``. The transport head of each key (the TCP
client's push, pull and row pull, or the local ``kvstore.push``/
``kvstore.pull`` fault point) runs through a ``faults.RetryPolicy``
(``MXTPU_KVSTORE_RETRIES``, default 2; ``MXTPU_KVSTORE_BACKOFF_S``); the
all-reduce, the mesh merge and the updater never do. A TCP push is
retried only when its send failed, on a new connection: one whose reply
was lost may have been applied, and raises (``KVClient``).
"""
from __future__ import annotations

import os
import pickle

import torch

from . import optimizer as opt
from . import sharding as _sharding
from . import telemetry as _tel
from .base import MXNetError
from .faults import RetryPolicy as _RetryPolicy
from .faults import env_attempts as _env_attempts
from .faults import injection as _faults
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


def _nbytes(t):
    """Payload bytes of a tensor (its shape times its item size; no
    copy, no device sync)."""
    return t.numel() * t.element_size()


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
        from . import kvstore_server as kvs
        self._kind = kind
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._dist = None
        self._client = self._env = self._server = None
        # key -> {context: its copy of the last mesh all-reduce}
        self._replicas = {}
        self.mesh_allreduces = 0
        # transient transport failures (socket resets, IO hiccups, and the
        # injected faults that model them) retry through the shared policy
        # (mxtpu's :79-96): MXTPU_KVSTORE_RETRIES counts retries after the
        # first attempt, MXTPU_KVSTORE_BACKOFF_S is the base delay. Only
        # the transport head is retried: a collective or an updater run
        # twice would desync the peers or move the weights twice.
        attempts = _env_attempts("MXTPU_KVSTORE_RETRIES", 2)
        backoff = float(os.environ.get("MXTPU_KVSTORE_BACKOFF_S", "0.05"))
        self._push_retry = _RetryPolicy(
            "kvstore.push", max_attempts=attempts, backoff_s=backoff,
            backoff_cap_s=1.0)
        self._pull_retry = _RetryPolicy(
            "kvstore.pull", max_attempts=attempts, backoff_s=backoff,
            backoff_cap_s=1.0)
        if not kind.startswith("dist"):
            return
        env = kvs.cluster_env()
        if env is not None and env["role"] == "worker":
            self._env = env
            self._connect_worker(kvs, env["uri"], env["port"],
                                 env["worker_id"], "async" in kind)
            return
        self._dist = _process_group()
        if "async" in kind and self._dist is not None:
            self._start_async_server(kvs)

    def _start_async_server(self, kvs):
        """``dist_async`` in a torch.distributed job: rank 0 serves (an
        async ``KVServer`` thread), every rank connects."""
        host = os.environ.get("MXTPU_ASYNC_PS_URI",
                              os.environ.get("MASTER_ADDR"))
        port = os.environ.get("MXTPU_ASYNC_PS_PORT")
        if port is None and "MASTER_PORT" in os.environ:
            port = int(os.environ["MASTER_PORT"]) + 1000
        if host is None or port is None:
            raise MXNetError(
                "dist_async over torch.distributed: set MASTER_ADDR and "
                "MASTER_PORT (env://), or MXTPU_ASYNC_PS_URI and "
                "MXTPU_ASYNC_PS_PORT, to where rank 0 serves")
        rank, n = self._dist.get_rank(), self._dist.get_world_size()
        if rank == 0:
            self._server = kvs.KVServer(int(port), n, host="0.0.0.0")
            self._server.sync_mode = False
            self._server.run_in_thread()
        self._connect_worker(kvs, host, port, rank, True)

    def _connect_worker(self, kvs, host, port, rank, async_mode):
        """Connect, start the heartbeat, set the mode, then a barrier."""
        self._client = kvs.KVClient(host, port)
        self._client.start_heartbeat(rank)
        if async_mode:
            self._client.send_command("sync_mode", False)
        self._client.barrier()

    # ------------------------------------------------ identity
    @property
    def type(self):
        return self._kind

    @property
    def rank(self):
        if self._env is not None:
            return self._env["worker_id"]
        return self._dist.get_rank() if self._dist is not None else 0

    @property
    def num_workers(self):
        if self._env is not None:
            return self._env["num_workers"]
        return self._dist.get_world_size() if self._dist is not None else 1

    # ------------------------------------------------ core ops
    def init(self, key, value):
        """Store a copy of each value (the first of a list), on its
        device."""
        keys, values = self._normalize(key, value)
        for k, v in zip(keys, values):
            arr = v[0] if isinstance(v, list) else v
            if self._client is not None:  # the lowest rank's value wins
                self._client.init(k, arr.asnumpy(), rank=self.rank)
                self._client.barrier()
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
        if self._dist is not None or self._client is not None or \
                len(vlist) < 2:
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
        _tel.counter("kvstore_mesh_allreduce",
                     help="push aggregations lowered to mesh "
                          "collectives instead of the host loop").inc()
        return [NDArray(t, v.context) for t, v in zip(sums, ordered)]

    def push(self, key, value, priority=0):
        """Sum the pushed values of each key (over the list, then over
        the workers); run the updater on the stored value, or store the
        sum."""
        del priority
        with _tel.span("kvstore.push", category="kvstore") as sp:
            self._push_impl(key, value)
        _tel.histogram("kvstore_push_ms",
                       help="per push() call latency").observe(
            sp.duration_ms)

    def _push_impl(self, key, value):
        bytes_pushed = _tel.counter("kvstore_push_bytes",
                                    help="aggregated gradient bytes pushed")
        keys, values = self._normalize(key, value)
        for k, v in zip(keys, values):
            vlist = v if isinstance(v, list) else [v]
            self._replicas.pop(k, None)
            ordered = self._mesh_align(vlist)
            if ordered is not None:
                sums = self._mesh_merge(ordered)
                bytes_pushed.inc(_nbytes(sums[0]._data))
                self._push_retry.call(_faults.point, "kvstore.push")
                stored = self._store.get(k)
                mine = next((x for x in sums if stored is not None
                             and x.context == stored.context), sums[0])
                self._apply_push(k, mine)
                if self._updater is None:
                    self._replicas[k] = {x.context: x._data for x in sums}
                continue
            merged = self._local_merge(vlist)
            bytes_pushed.inc(_nbytes(_raw(merged)))
            # only the transport head is retried (mxtpu's :323-336): the
            # TCP client raises a retryable error only where the server
            # cannot have applied the push (the send failed), and
            # MXNetError, which no policy retries, where a reply was lost
            # after it went out; the all-reduce (every peer runs it
            # exactly once) and the updater's in-place write run once,
            # outside the retry
            if self._client is not None:
                self._push_retry.call(self._push_transport, k, merged)
                continue
            self._push_retry.call(_faults.point, "kvstore.push")
            if self._dist is not None:
                t = _raw(merged).detach()
                if merged is vlist[0]:
                    t = t.clone()  # the caller's array stays as it was
                self._dist.all_reduce(t)
                merged = NDArray(t, merged.context)
            self._apply_push(k, merged)

    def _push_transport(self, k, merged):
        _faults.point("kvstore.push")
        self._client.push(k, merged.asnumpy())

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
        with _tel.span("kvstore.pull", category="kvstore") as sp:
            self._pull_impl(key, out)
        _tel.histogram("kvstore_pull_ms",
                       help="per pull() call latency").observe(
            sp.duration_ms)

    def _pull_impl(self, key, out):
        bytes_pulled = _tel.counter("kvstore_pull_bytes",
                                    help="weight bytes pulled to devices")
        keys, outs = self._normalize(key, out)
        with torch.no_grad():
            for k, o in zip(keys, outs):
                if k not in self._store:
                    raise MXNetError("pull: key %r was never initialized"
                                     % (k,))
                # the same split as push: the transport read is retried,
                # the copies into the outs happen once
                if self._client is not None:
                    src = torch.from_numpy(
                        self._pull_retry.call(self._pull_transport, k))
                else:
                    self._pull_retry.call(_faults.point, "kvstore.pull")
                    src = self._store[k]._data
                copies = self._replicas.get(k, {})
                for dst in (o if isinstance(o, list) else [o]):
                    val = copies.get(dst.context, src)
                    _pull_into(dst, val)
                    bytes_pulled.inc(_nbytes(val))

    def _pull_transport(self, k):
        _faults.point("kvstore.pull")
        return self._client.pull(k)

    def _pull_rows_transport(self, k, rows):
        _faults.point("kvstore.pull")
        return self._client.pull_rows(k, rows)

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
                    if self._client is not None:
                        self._pull_rows_tcp(k, dst, rid)
                        continue
                    _pull_into(dst, copies.get(dst.context,
                                               self._store[k]._data), rid)

    def _pull_rows_tcp(self, k, dst, rid):
        """A pull from the TCP server: only the unique requested rows
        into a ``RowSparseNDArray``, the whole value into any other
        out."""
        if not isinstance(dst, RowSparseNDArray):
            _pull_into(dst, torch.from_numpy(
                self._pull_retry.call(self._pull_transport, k)))
            return
        rows = torch.unique(rid._data.to(torch.int64).reshape(-1)).cpu()
        got = torch.from_numpy(self._pull_retry.call(
            self._pull_rows_transport, k, rows.numpy()))
        dev = dst.context.torch_device
        dst._set_rows(got.to(dev), rows.to(dev))

    # ------------------------------------------------ updater / optimizer
    def set_updater(self, updater):
        self._updater = updater

    def set_optimizer(self, optimizer):
        """Over the TCP server the optimizer is pickled to it and runs
        there (every worker sends it; the socket's order puts it before
        the worker's pushes). Otherwise it runs on every worker after the
        sum (mxtpu's worker-side update, the sync server's semantics)."""
        self._optimizer = optimizer
        if self._client is not None:
            self._client.send_command("set_optimizer",
                                      pickle.dumps(optimizer))
            return
        self._updater = opt.get_updater(optimizer)

    # ------------------------------------------------ cluster control
    def barrier(self):
        if self._client is not None:
            self._client.barrier()
        elif self._dist is not None:
            self._dist.barrier()

    def send_command_to_servers(self, head, body):
        """A command to the TCP server (``sync_mode``,
        ``set_optimizer``); nothing without one."""
        if self._client is not None:
            self._client.send_command(head, body)

    def num_dead_node(self, node_id=0, timeout=60):
        """Workers the TCP server counts dead: silent longer than
        ``timeout`` seconds since their heartbeat started, clean stops
        excluded (``node_id`` kept for the signature); 0 without one."""
        del node_id
        if self._client is not None:
            return self._client.num_dead_node(timeout)
        return 0

    def close(self):
        """Stop this worker's connection to the TCP server (the server
        ends once every worker has stopped). The process group, where one
        was joined, belongs to the process."""
        if self._client is not None:
            self._client.stop()
            self._client = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

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
