"""DataLoader (counterpart of mxtpu/gluon/data/dataloader.py).

Batches are assembled on the host (numpy) and made NDArrays by
``default_batchify_fn`` on the current context, as mxtpu's are: gpu(0)
unless a ``with cpu():`` scope says otherwise (the context in force when
iteration starts, also in the producer thread). ``num_workers=0``
assembles each batch when it is asked for; ``num_workers>0`` runs one
producer thread that assembles batches ahead (:60-95).
"""
from __future__ import annotations

import queue
import threading

import numpy as _np

from ... import ndarray as nd
from ...context import current_context
from ...ndarray import NDArray
from . import sampler as _sampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    if isinstance(data[0], NDArray):
        return nd.stack(*data)
    if isinstance(data[0], tuple):
        return [default_batchify_fn(i) for i in zip(*data)]
    data = _np.asarray(data)
    return nd.array(data, dtype=data.dtype)


class DataLoader:
    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                if shuffle:
                    sampler = _sampler.RandomSampler(len(dataset))
                else:
                    sampler = _sampler.SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler is "
                                 "specified")
            batch_sampler = _sampler.BatchSampler(
                sampler, batch_size, last_batch if last_batch else "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError("batch_size, shuffle, sampler and last_batch "
                             "must not be specified if batch_sampler is "
                             "specified.")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = num_workers

    def _batch(self, idxs):
        return self._batchify_fn([self._dataset[i] for i in idxs])

    def __iter__(self):
        ctx = current_context()
        if self._num_workers == 0:
            for batch in self._batch_sampler:
                with ctx:
                    item = self._batch(batch)
                yield item
            return
        # one producer assembling batches ahead; a stop flag and timed puts
        # let it exit when the consumer abandons the iteration early
        q = queue.Queue(maxsize=max(2, self._num_workers * 2))
        sentinel = object()
        stopped = threading.Event()

        def put(item):
            while not stopped.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ctx:
                    for batch in self._batch_sampler:
                        if not put(self._batch(batch)):
                            return
            except Exception as e:
                put(e)  # raised in the consumer
                return
            put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stopped.set()
            t.join()

    def __len__(self):
        return len(self._batch_sampler)
