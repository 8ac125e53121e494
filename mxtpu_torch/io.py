"""Data iterators (parity: python/mxnet/io.py DataDesc/DataBatch/DataIter
:176, PrefetchingIter and NDArrayIter :516).

Counterpart of ``mxtpu/io.py:26-128, 191-440, 466-648``. Batches are
assembled on the host, as numpy slices wrapped in cpu() NDArrays; the
training step copies each batch to its device (``Module``), so an
iterator never needs a card. ``PrefetchingIter`` fetches the next batch
on producer threads; ``DevicePrefetchIter`` also stages it on the
device there: through a pinned host buffer and a copy on a side stream,
which the consumer's stream waits for before it touches the batch.
"""
from __future__ import annotations

import threading
import time

import numpy as _np
import torch

from .base import MXNetError
from .context import as_context, cpu, gpu
from .ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "PrefetchingIter",
           "DevicePrefetchIter", "NDArrayIter"]


class DataDesc:
    """Name/shape/dtype/layout of one input (parity io.py DataDesc)."""

    def __init__(self, name, shape, dtype="float32", layout="NCHW"):
        self.name = name
        self.shape = tuple(shape)
        self.dtype = _np.dtype(dtype)
        self.layout = layout

    def __getitem__(self, i):
        return (self.name, self.shape)[i]

    def __iter__(self):
        return iter((self.name, self.shape))

    def __len__(self):
        return 2

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)

    @staticmethod
    def get_list(shapes, types=None):
        type_dict = dict(types or [])
        return [DataDesc(x[0], x[1], type_dict.get(x[0], "float32"))
                for x in shapes]


class DataBatch:
    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Base iterator (parity io.py:176)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        pass

    def getdata(self):
        pass

    def getlabel(self):
        pass

    def getindex(self):
        return None

    def getpad(self):
        pass


class PrefetchingIter(DataIter):
    """Background-thread double buffering (parity io.py PrefetchingIter /
    src/io/iter_prefetcher.h): one producer thread per iterator fetches
    the next batch while the consumer uses the current one.

    ``_stage(batch)`` runs on the producer thread on every fetched batch
    and ``_handover(batches)`` on the consumer thread when it takes them:
    the seams ``DevicePrefetchIter`` stages through. A producer's
    exception is parked and re-raised at the consumer, on every use from
    then on. ``close()`` stops and joins the producer threads (also the
    context manager's exit); a closed iterator raises. ``ready_hits`` and
    ``ready_waits`` count the consumer's arrivals that found the next
    batch already staged and those that had to wait for it."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0][1][0]
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()
        self.started = True
        self.current_batch = None
        self.next_batch = [None] * self.n_iter
        self.producer_error = [None] * self.n_iter
        self.ready_hits = self.ready_waits = 0
        self.prefetch_threads = [
            threading.Thread(target=self._produce, args=(i,), daemon=True)
            for i in range(self.n_iter)]
        for thread in self.prefetch_threads:
            thread.start()

    def _produce(self, i):
        while True:
            self.data_taken[i].wait()
            if not self.started:
                # unblock a consumer parked in iter_next()/reset(): it
                # sees the end of the data
                self.next_batch[i] = None
                self.data_ready[i].set()
                break
            try:
                self.next_batch[i] = self._stage(self.iters[i].next())
            except StopIteration:
                self.next_batch[i] = None
            except BaseException as exc:  # re-raised at the consumer
                self.producer_error[i] = exc
                self.next_batch[i] = None
                self.data_taken[i].clear()
                self.data_ready[i].set()
                break
            self.data_taken[i].clear()
            self.data_ready[i].set()

    def _stage(self, batch):
        """Producer-thread hook applied to every fetched batch."""
        return batch

    def _handover(self, batches):
        """Consumer-thread hook on the batches it is about to take."""

    def close(self, join=True):
        """Stop the producer threads and, with ``join``, wait for them
        to exit. Idempotent. The wrapped iterators stay open."""
        if not self.started:
            return
        self.started = False
        for e in self.data_taken:
            e.set()
        if not join:
            return
        # a producer mid-fetch clears data_taken after we set it and then
        # waits on it: set it again until each thread has exited
        deadline = time.monotonic() + 10.0
        for thread in self.prefetch_threads:
            while thread.is_alive() and time.monotonic() < deadline:
                for e in self.data_taken:
                    e.set()
                thread.join(timeout=0.05)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            # signal only: a join here could stall the collecting thread
            # behind a producer blocked in a slow fetch
            self.close(join=False)
        except Exception:  # the threads are daemons; nothing to report
            pass

    def _renamed(self, descs_of, renames):
        if renames is None:
            return sum([descs_of(i) for i in self.iters], [])
        return sum([[DataDesc(r[x[0]], x[1], getattr(x, "dtype", "float32"))
                     for x in descs_of(i)]
                    for r, i in zip(renames, self.iters)], [])

    @property
    def provide_data(self):
        return self._renamed(lambda i: i.provide_data, self.rename_data)

    @property
    def provide_label(self):
        return self._renamed(lambda i: i.provide_label, self.rename_label)

    def _raise_producer_error(self):
        for exc in self.producer_error:
            if exc is not None:
                raise exc

    def reset(self):
        if not self.started:
            raise MXNetError("PrefetchingIter is closed")
        for e in self.data_ready:
            e.wait()
        self._raise_producer_error()
        for i in self.iters:
            i.reset()
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def iter_next(self):
        if not self.started:
            raise MXNetError("PrefetchingIter is closed")
        if all(e.is_set() for e in self.data_ready):
            self.ready_hits += 1
        else:
            self.ready_waits += 1
        for e in self.data_ready:
            e.wait()
        self._raise_producer_error()
        if self.next_batch[0] is None:
            return False
        self._handover(self.next_batch)
        self.current_batch = DataBatch(
            sum([b.data for b in self.next_batch], []),
            sum([b.label for b in self.next_batch], []),
            self.next_batch[0].pad, self.next_batch[0].index)
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class DevicePrefetchIter(PrefetchingIter):
    """A ``PrefetchingIter`` whose producer thread also stages each batch
    on ``device`` (a Context, torch.device or string; None is gpu(0),
    which raises without CUDA, as every entry point does), so that the
    host->device copy of batch N+1 runs while the consumer runs step N.

    On a CUDA device each host array is copied into a pinned buffer and
    from there to the device with ``non_blocking`` on a side stream of
    its own, and an event is recorded behind the copies. The consumer's
    current stream waits on that event before the batch is handed over,
    and each staged tensor is ``record_stream``-ed on it, so the caching
    allocator does not hand its memory to the side stream while the
    consumer still reads it. A pinned buffer is written again only after
    the copy out of it has completed (two buffers per input, in turn).
    On cpu() batches pass through as they are.
    """

    N_BUFFERS = 2

    def __init__(self, iters, device=None, rename_data=None,
                 rename_label=None):
        ctx = gpu(0) if device is None else as_context(device)
        self.device = ctx.torch_device  # raises for a missing card
        self.context = ctx
        self._stream = None
        # (producer thread, input slot) -> ring of [pinned buffer, event
        # of the copy out of it]; each producer thread touches its own
        self._rings = {}
        self._turns = {}
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
        super().__init__(iters, rename_data=rename_data,
                         rename_label=rename_label)

    def _pinned(self, slot, turn, src):
        """The ring entry ``[buffer, event]`` of ``slot`` for this turn,
        its buffer pinned, shaped like ``src`` and free: the copy that
        last read it has completed."""
        ring = self._rings.setdefault(slot, [None] * self.N_BUFFERS)
        entry = ring[turn % self.N_BUFFERS]
        if entry is not None:
            entry[1].synchronize()
            if entry[0].shape == src.shape and entry[0].dtype == src.dtype:
                return entry
        entry = ring[turn % self.N_BUFFERS] = [
            torch.empty(src.shape, dtype=src.dtype, pin_memory=True), None]
        return entry

    def _stage(self, batch):
        if self._stream is None or batch is None:
            return batch
        me = threading.get_ident()
        turn = self._turns.get(me, 0)
        self._turns[me] = turn + 1
        staged, used = [], []
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            for group, arrs in (("data", batch.data or []),
                                ("label", batch.label or [])):
                for j, a in enumerate(arrs):
                    src = getattr(a, "_data", a)
                    if src.device.type != "cpu":
                        staged.append(src.to(self.device, non_blocking=True))
                        continue
                    entry = self._pinned((me, group, j), turn, src)
                    entry[0].copy_(src)
                    staged.append(entry[0].to(self.device,
                                              non_blocking=True))
                    used.append(entry)
            done = torch.cuda.Event()
            done.record(self._stream)
        for entry in used:
            entry[1] = done
        n = len(batch.data or [])
        out = DataBatch([NDArray(t, self.context) for t in staged[:n]],
                        [NDArray(t, self.context) for t in staged[n:]],
                        pad=batch.pad, index=batch.index)
        out.staged_event = done
        return out

    def _handover(self, batches):
        if self._stream is None:
            return
        consumer = torch.cuda.current_stream(self.device)
        for b in batches:
            consumer.wait_event(b.staged_event)
            for arr in (b.data or []) + (b.label or []):
                arr._data.record_stream(consumer)

    @property
    def host_buffers(self):
        """The pinned host buffers (for inspection)."""
        return [e[0] for ring in list(self._rings.values()) for e in ring
                if e is not None]


def _init_data(data, allow_empty, default_name):
    if data is None:
        data = []
    if isinstance(data, (_np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {("_%d_%s" % (i, default_name)): d
                    for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, list or dict")
    out = []
    for k, v in data.items():
        if isinstance(v, NDArray):
            v = v.asnumpy()
        out.append((k, _np.asarray(v)))
    return out


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (parity io.py:516): ``shuffle``
    permutes once, from numpy's global RNG, at construction;
    ``last_batch_handle`` is "pad" (wrap to the start and report
    ``pad``), "discard" or "roll_over"."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.idx = _np.arange(self.data[0][1].shape[0])
        if shuffle:
            _np.random.shuffle(self.idx)
        if last_batch_handle == "discard":
            n = self.data[0][1].shape[0]
            self.idx = self.idx[:n - n % batch_size]
        self.num_data = self.idx.shape[0]
        assert self.num_data >= batch_size, \
            "batch_size needs to be smaller than data size"
        self.cursor = -batch_size
        self.batch_size = batch_size
        self.last_batch_handle = last_batch_handle

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size + (self.cursor % self.num_data) \
                % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _getdata(self, data_source):
        assert self.cursor < self.num_data, "DataIter needs reset."
        if self.cursor + self.batch_size <= self.num_data:
            sel = self.idx[self.cursor:self.cursor + self.batch_size]
        else:
            pad = self.batch_size - self.num_data + self.cursor
            sel = _np.concatenate([self.idx[self.cursor:], self.idx[:pad]])
        return [NDArray(torch.from_numpy(_np.ascontiguousarray(
            x[1][sel], dtype=_np.float32)), cpu()) for x in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0
