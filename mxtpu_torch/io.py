"""Data iterators (parity: python/mxnet/io.py DataDesc/DataBatch/DataIter
:176, ResizeIter, PrefetchingIter, NDArrayIter :516 and MXDataIter, and
the C++ iterators of src/io: MNISTIter, CSVIter, LibSVMIter and the
record iterators, by name through ``create_iterator``).

Counterpart of ``mxtpu/io.py``. Batches are
assembled on the host, as numpy slices wrapped in cpu() NDArrays; the
training step copies each batch to its device (``Module``), so an
iterator never needs a card. ``PrefetchingIter`` fetches the next batch
on producer threads; ``DevicePrefetchIter`` also stages it on the
device there: through a pinned host buffer and a copy on a side stream,
which the consumer's stream waits for before it touches the batch.
"""
from __future__ import annotations

import gzip
import os
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as _np
import torch

from .base import MXNetError
from .context import as_context, cpu, gpu
from .ndarray import NDArray
from .ndarray.ndarray import NARROW

__all__ = ["DataDesc", "DataBatch", "DataIter", "ResizeIter",
           "PrefetchingIter", "DevicePrefetchIter", "NDArrayIter",
           "register_iter", "MNISTIter", "CSVIter", "MXDataIter",
           "create_iterator", "ImageRecordIter", "ImageRecordUInt8Iter",
           "ImageRecordIter_v1", "ImageRecordUInt8Iter_v1",
           "ImageDetRecordIter", "LibSVMIter"]


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

    def checkpoint_state(self):
        """The iterator's position for an exact resume (everything the
        next ``next()`` needs to return the batch it would have), or None
        where it cannot say."""
        return None

    def restore_state(self, state):
        """Restore a ``checkpoint_state``; False where unsupported."""
        return False


class ResizeIter(DataIter):
    """Another iterator with its epoch cut or stretched to ``size``
    batches: the inner iterator is reset whenever it runs out."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
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

    def checkpoint_state(self):
        inner = self.data_iter.checkpoint_state()
        if inner is None:
            return None
        return {"cur": self.cur, "inner": inner}

    def restore_state(self, state):
        if not isinstance(state, dict) or "inner" not in state:
            return False
        if not self.data_iter.restore_state(state["inner"]):
            return False
        self.cur = int(state["cur"])
        return True


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
    ``pad``), "discard" or "roll_over". ``num_workers > 0`` assembles up
    to that many upcoming batches ahead of the cursor on a thread pool
    (``close()`` shuts it down). ``checkpoint_state`` is the cursor and
    the permutation."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", num_workers=0):
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
        self._num_workers = int(num_workers)
        self._pool = None
        self._pending = {}
        if self._num_workers > 0:
            self._pool = ThreadPoolExecutor(
                max_workers=self._num_workers,
                thread_name_prefix="ndarrayiter")

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def hard_reset(self):
        """Back to the first batch, whatever ``last_batch_handle``."""
        self._drop_pending()
        self.cursor = -self.batch_size

    def reset(self):
        self._drop_pending()
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size + (self.cursor % self.num_data) \
                % self.batch_size
        else:
            self.cursor = -self.batch_size

    def close(self):
        """Shut down the assembly pool (nothing to do without
        ``num_workers``)."""
        self._drop_pending()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
            self._num_workers = 0

    def _drop_pending(self):
        for fut in self._pending.values():
            fut.cancel()
        self._pending.clear()

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if not self.iter_next():
            raise StopIteration
        if self._pool is None:
            return self._assemble(self.cursor)
        fut = self._pending.pop(self.cursor, None)
        if fut is None:
            fut = self._pool.submit(self._assemble, self.cursor)
        # queue the lookahead before waiting, so the workers stay busy
        for k in range(1, self._num_workers + 1):
            nc = self.cursor + k * self.batch_size
            if nc < self.num_data and nc not in self._pending:
                self._pending[nc] = self._pool.submit(self._assemble, nc)
        return fut.result()

    def _assemble(self, cursor):
        """The batch at ``cursor``: a pure function of (cursor, idx), safe
        on pool threads."""
        return DataBatch(data=self._getdata(self.data, cursor),
                         label=self._getdata(self.label, cursor),
                         pad=self._pad_at(cursor), index=None)

    def _getdata(self, data_source, cursor=None):
        cursor = self.cursor if cursor is None else cursor
        assert cursor < self.num_data, "DataIter needs reset."
        if cursor + self.batch_size <= self.num_data:
            sel = self.idx[cursor:cursor + self.batch_size]
        else:
            pad = self.batch_size - self.num_data + cursor
            sel = _np.concatenate([self.idx[cursor:], self.idx[:pad]])
        return [NDArray(torch.from_numpy(_np.ascontiguousarray(
            x[1][sel], dtype=NARROW.get(x[1].dtype.name, x[1].dtype))),
            cpu()) for x in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def _pad_at(self, cursor):
        if self.last_batch_handle == "pad" and \
                cursor + self.batch_size > self.num_data:
            return cursor + self.batch_size - self.num_data
        return 0

    def getpad(self):
        return self._pad_at(self.cursor)

    def checkpoint_state(self):
        """The cursor and the permutation (a resumed process's fresh
        iterator drew another one); ``idx`` by reference, as it never
        changes after construction."""
        return {"cursor": int(self.cursor), "idx": self.idx}

    def restore_state(self, state):
        if not isinstance(state, dict) or "cursor" not in state:
            return False
        idx = state.get("idx")
        if idx is not None:
            idx = _np.asarray(idx)
            if idx.shape != self.idx.shape:
                return False  # another dataset or epoch length
            self.idx = idx.astype(self.idx.dtype, copy=False)
        self._drop_pending()
        self.cursor = int(state["cursor"])
        return True


_ITERS = {}


def register_iter(fn, name=None):
    """Register an iterator factory under its name, for
    ``create_iterator`` (case-insensitive)."""
    _ITERS[(name or fn.__name__).lower()] = fn
    return fn


def create_iterator(name, **kwargs):
    """The registered iterator ``name`` made with ``kwargs`` (the names
    the reference's C API creates iterators by)."""
    fn = _ITERS.get(name.lower())
    if fn is None:
        raise MXNetError("Cannot find data iterator '%s'. Registered: %s"
                         % (name, sorted(_ITERS)))
    return fn(**kwargs)


def _read_idx_file(path, is_image):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        if is_image:
            _, n, rows, cols = struct.unpack(">IIII", f.read(16))
            return _np.frombuffer(f.read(), dtype=_np.uint8).reshape(
                n, rows, cols)
        struct.unpack(">II", f.read(8))
        return _np.frombuffer(f.read(), dtype=_np.uint8)


@register_iter
def MNISTIter(image="train-images-idx3-ubyte", label="train-labels-idx1-ubyte",
              batch_size=128, shuffle=True, flat=False, silent=False, seed=0,
              input_shape=None, num_parts=1, part_index=0, **kwargs):
    """MNIST's idx files (``.gz`` too) as an NDArrayIter of pixels in
    [0, 1) (parity src/io/iter_mnist.cc:79); ``shuffle`` permutes with
    ``RandomState(seed)``, the tail batch is dropped."""
    for p in (image, label):
        if not os.path.exists(p) and not os.path.exists(p + ".gz"):
            raise MXNetError("MNISTIter: file not found: %s" % p)
    img_path = image if os.path.exists(image) else image + ".gz"
    lbl_path = label if os.path.exists(label) else label + ".gz"
    images = _read_idx_file(img_path, True).astype("float32") / 255.0
    labels = _read_idx_file(lbl_path, False).astype("float32")
    if num_parts > 1:
        part = images.shape[0] // num_parts
        s = part * part_index
        images, labels = images[s:s + part], labels[s:s + part]
    if flat:
        images = images.reshape(images.shape[0], -1)
    else:
        images = images.reshape(images.shape[0], 1, 28, 28)
    if shuffle:
        order = _np.random.RandomState(seed).permutation(images.shape[0])
        images, labels = images[order], labels[order]
    return NDArrayIter(images, labels, batch_size=batch_size,
                       shuffle=False, last_batch_handle="discard")


@register_iter
def CSVIter(data_csv, data_shape, label_csv=None, label_shape=(1,),
            batch_size=128, round_batch=True, **kwargs):
    """Rows of a CSV file as an NDArrayIter (parity src/io/iter_csv.cc:59);
    labels 0 without ``label_csv``."""
    data = _np.loadtxt(data_csv, delimiter=",", dtype="float32")
    data = data.reshape((-1,) + tuple(data_shape))
    if label_csv is not None:
        label = _np.loadtxt(label_csv, delimiter=",", dtype="float32")
        label = label.reshape((-1,) + tuple(label_shape))
        if label.shape[1:] == (1,):
            label = label[:, 0]
    else:
        label = _np.zeros((data.shape[0],), dtype="float32")
    return NDArrayIter(data, label, batch_size=batch_size,
                       last_batch_handle="pad" if round_batch else "discard")


class MXDataIter(DataIter):
    """The reference's wrapper of a native iterator (io.py:740 MXDataIter);
    the registered iterators here are Python objects already, so this
    delegates to ``underlying``."""

    def __init__(self, underlying, data_name="data",
                 label_name="softmax_label"):
        super().__init__()
        self._it = underlying
        self.data_name = data_name
        self.label_name = label_name

    def __getattr__(self, name):
        try:
            it = self.__dict__["_it"]
        except KeyError:
            raise AttributeError(name)
        return getattr(it, name)

    def reset(self):
        self._it.reset()

    def next(self):
        return self._it.next()


def _record_iter(name):
    """image_record's iterator ``name``, imported when called
    (image_record imports this module)."""
    def make(**kwargs):
        from . import image_record
        return getattr(image_record, name)(**kwargs)
    make.__name__ = make.__qualname__ = name
    return make


for _name in ("ImageRecordIter", "ImageRecordUInt8Iter", "ImageRecordIter_v1",
              "ImageRecordUInt8Iter_v1", "ImageDetRecordIter"):
    globals()[_name] = register_iter(_record_iter(_name))
del _name


@register_iter
def LibSVMIter(data_libsvm, data_shape, batch_size=128, dense=False,
               **kwargs):
    """LibSVM text as batches (parity mxtpu/io.py:791,
    src/io/iter_libsvm.cc): each batch's data is a cpu() ``CSRNDArray``
    (the reference's csr storage), or dense with ``dense=True``; the
    tail batch wraps to the first rows and reports ``pad``."""
    from .ndarray.sparse import CSRNDArray
    feat_dim = int(_np.prod(data_shape))
    vals, cols, ptr, labels = [], [], [0], []
    with open(data_libsvm) as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            labels.append(float(parts[0]))
            for tok in parts[1:]:
                k, v = tok.split(":")
                cols.append(int(k))
                vals.append(float(v))
            ptr.append(len(cols))
    n = len(labels)
    labels = _np.asarray(labels, dtype="float32")
    if dense:
        full = _np.zeros((n, feat_dim), dtype="float32")
        ptr = _np.asarray(ptr)
        full[_np.repeat(_np.arange(n), _np.diff(ptr)), _np.asarray(cols)] = \
            vals
        return NDArrayIter(full.reshape((-1,) + tuple(data_shape)), labels,
                           batch_size=batch_size, last_batch_handle="pad")
    csr = CSRNDArray(_np.asarray(vals, dtype="float32"),
                     _np.asarray(cols, dtype=_np.int64),
                     _np.asarray(ptr, dtype=_np.int64), (n, feat_dim), cpu())
    return _LibSVMIter(csr, labels, batch_size)


class _LibSVMIter(DataIter):
    def __init__(self, csr, labels, batch_size):
        super().__init__(batch_size)
        self._csr = csr
        self._labels = labels
        self._cursor = 0
        self.provide_data = [DataDesc("data", (batch_size, csr.shape[1]),
                                      "float32")]
        self.provide_label = [DataDesc("label", (batch_size,), "float32")]

    def reset(self):
        self._cursor = 0

    def next(self):
        from .ndarray.sparse import CSRNDArray
        n = len(self._labels)
        if self._cursor >= n:
            raise StopIteration
        lo = self._cursor
        hi = min(lo + self.batch_size, n)
        pad = self.batch_size - (hi - lo)
        sl = self._csr[lo:hi]
        lab = self._labels[lo:hi]
        if pad:  # the first rows again (modulo n where pad > n)
            wrap = _np.arange(pad) % n
            d, ix, ptr = [c.numpy() for c in self._csr._components()]
            sel = _np.concatenate([_np.arange(ptr[r], ptr[r + 1])
                                   for r in wrap]).astype(_np.int64)
            sd, six, sptr = [c.numpy() for c in sl._components()]
            sl = CSRNDArray(_np.concatenate([sd, d[sel]]),
                            _np.concatenate([six, ix[sel]]),
                            _np.concatenate([sptr, sptr[-1] + _np.cumsum(
                                ptr[wrap + 1] - ptr[wrap])]),
                            (self.batch_size, self._csr.shape[1]), cpu())
            lab = _np.concatenate([lab, self._labels[wrap]])
        self._cursor = hi
        return DataBatch(data=[sl], label=[NDArray(torch.from_numpy(lab),
                                                   cpu())],
                         pad=pad, index=None)
