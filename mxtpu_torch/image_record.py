"""ImageRecordIter, ImageDetRecordIter and ImageRecordUInt8Iter: the
``.rec`` training pipeline.

Counterpart of ``mxtpu/image_record.py`` (parity: the reference's
src/io/iter_image_recordio_2.cc:503 ImageRecordIter2 and
iter_image_det_recordio.cc), with the parameter surface the C iterators
register. The pipeline: the native prefetch thread (``src/core/
threaded_iter.h`` through ``_native``) reads each batch's records in
order, hands their decodes to a thread pool of ``preprocess_threads``
(cv2 and numpy release the GIL), draws each record's crop and mirror in
record order itself, has the pool crop, mirror, normalize and write each
image into the batch's NCHW buffer, and queues the batch (at most
``prefetch_buffer`` ahead). Batches are cpu() NDArrays, as the port's
``NDArrayIter`` yields them; ``Module`` copies them to its device.

Two points differ from mxtpu on purpose:

- mxtpu draws the random crop and mirror inside its decode pool's
  threads from one shared ``RandomState``, so the draws' order, and the
  batches, follow thread scheduling. Here they are drawn in record order
  in the reading thread, so the batches are the same at every
  ``preprocess_threads``; at one thread they equal mxtpu's. The
  augmenter chains (``resize``/``aug_list``, ImageDetRecordIter) draw in
  the producer thread from Python and numpy generators of the iterator's
  own, copied from the global ones when it is made, so the caller's
  draws neither move them nor are moved by them. A reset rewinds all of
  the iterator's draws to the state after the last batch the consumer
  took, so batches the prefetcher made ahead and nobody read draw
  nothing.
- Lifetime. mxtpu frees its native iterator from ``__del__``, which the
  GC may run inside the producer's own Python callback (the process
  then dies). Here the producer's callback reaches only the reading
  state, never the iterator; the iterator's ``weakref.finalize`` frees
  the native iterator (joining its thread) on a helper thread, and the
  ctypes callback lives until that free has returned. ``close()`` is
  public and idempotent, and ``reset()`` joins the producer before it
  rewinds the reader.
"""
from __future__ import annotations

import ctypes
import os
import random as _pyrandom
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as _np
import torch

from . import _native
from . import io as _io
from . import recordio as _rio
from .analysis import concurrency as _conc
from .base import MXNetError
from .context import cpu
from .image import image as _img
from .ndarray import NDArray

__all__ = ["ImageRecordIter", "ImageDetRecordIter", "ImageRecordUInt8Iter",
           "ImageRecordIter_v1", "ImageRecordUInt8Iter_v1"]

_POOL_PREFIX = "mxtpu_torch-decode"


class _Prefetcher:
    """The native ThreadedIter over ``produce`` (the next item, or None
    at the end): a thread of its own calls it through ``_callback`` and
    keeps up to ``buffer_size`` items queued. The native queue carries
    integer tickets into ``_store``; a producer's exception is kept and
    raised at the consumer."""

    def __init__(self, produce, buffer_size):
        self._produce = produce
        self._store = {}
        self._lock = _conc.lock("_Prefetcher", "_lock")
        self._last = 0
        self._error = None
        self.thread = None  # ident of the native producer thread
        self._lib = _native.get_lib()
        self._cb = _native.PRODUCE_FN(self._callback)
        h = ctypes.c_void_p()
        _native.check_call(self._lib.MXTPUThreadedIterCreate(
            self._cb, None, int(buffer_size), ctypes.byref(h)))
        self._h = h

    def _callback(self, _ctx, out_item):
        self.thread = threading.get_ident()
        try:
            item = self._produce()
        except StopIteration:
            return 1
        except BaseException as e:  # re-raised at the consumer
            self._error = e
            return -1
        if item is None:
            return 1
        with self._lock:
            self._last += 1
            self._store[self._last] = item
        out_item[0] = self._last
        return 0

    def next(self):
        if self._h is None:
            raise MXNetError("the record iterator is closed")
        item = ctypes.c_void_p()
        _native.check_call(self._lib.MXTPUThreadedIterNext(
            self._h, ctypes.byref(item)))
        if not item.value:
            if self._error is not None:
                raise self._error
            raise StopIteration
        with self._lock:
            return self._store.pop(item.value)

    def close(self):
        """Stop and join the producer thread, then drop what it queued.
        The callback object is released only after the native free."""
        h, self._h = self._h, None
        if h is not None:
            _native.check_call(self._lib.MXTPUThreadedIterFree(h))
            self._store.clear()


class _Parts:
    """What an iterator owns besides its own attributes: the prefetcher
    of the current epoch and the reading state (reader, decode pool).
    Nothing here refers back to the iterator, so the GC can collect it
    while its producer runs."""

    def __init__(self, source):
        self.source = source
        self.prefetcher = None

    def stop(self):
        if self.prefetcher is not None:
            self.prefetcher.close()
            self.prefetcher = None

    def close(self):
        self.stop()
        self.source.close()

    def on_pipeline_thread(self):
        me = threading.current_thread()
        return (self.prefetcher is not None
                and self.prefetcher.thread == me.ident) \
            or me.name.startswith(_POOL_PREFIX)


def _producer(source):
    """The prefetch thread's produce function: the source's next batch,
    tagged with the draws' state after it. It holds the source only,
    never the iterator."""
    def produce():
        batch = source.produce()
        if batch is not None:
            batch.draw_state = source.draw_state()
        return batch
    return produce


def _close_parts(parts, now):
    """Close ``parts``: here and now when asked and safe, else on a
    helper thread (a finalizer may run inside the producer's callback or
    a decode task, which the close would then wait for)."""
    if now and not parts.on_pipeline_thread():
        parts.close()
        return
    if threading.main_thread().is_alive():
        threading.Thread(target=parts.close, daemon=True,
                         name="mxtpu_torch-record-close").start()
    else:  # interpreter exit: the pipeline threads are done with Python
        parts.close()


class _PipelineIter(_io.DataIter):
    """A DataIter whose batches come from a ``source`` through the native
    prefetcher. ``source`` has ``produce()`` (the next DataBatch, None at
    the end), ``rewind(epoch)``, ``draw_state()``/``set_draw_state(s)``
    (its random draws' position) and ``close()``."""

    def _start(self, source, prefetch_buffer):
        self._prefetch_n = max(1, int(prefetch_buffer))
        self._parts = _Parts(source)
        self._finalizer = weakref.finalize(self, _close_parts, self._parts,
                                           False)
        self._epoch = 0
        self._draws = None
        self.reset()

    def reset(self):
        if not self._finalizer.alive:
            raise MXNetError("the record iterator is closed")
        parts = self._parts
        parts.stop()  # the producer is joined before the reader rewinds
        if self._draws is not None:
            parts.source.set_draw_state(self._draws)
        parts.source.rewind(self._epoch)
        self._epoch += 1
        self._draws = parts.source.draw_state()
        parts.prefetcher = _Prefetcher(_producer(parts.source),
                                       self._prefetch_n)

    def next(self):
        if not self._finalizer.alive:
            raise MXNetError("the record iterator is closed")
        batch = self._parts.prefetcher.next()
        self._draws = batch.draw_state
        return batch

    def close(self):
        """Join the producer, shut the decode pool, close the reader.
        Idempotent; the iterator raises from then on."""
        if self._finalizer.detach() is not None:
            _close_parts(self._parts, True)


def _cpu_array(arr):
    return NDArray(torch.from_numpy(arr), cpu())


class _AugDraws:
    """The generators a source's augmenter chain draws from: copies of
    Python's and numpy's global generators as they stand when the
    iterator is made (where mxtpu's chain would start drawing), never the
    global ones themselves."""

    def __init__(self):
        self.py = _pyrandom.Random()
        self.py.setstate(_pyrandom.getstate())
        self.np = _np.random.RandomState()
        self.np.set_state(_np.random.get_state())

    def active(self):
        """Within the block, this thread's augmenters draw from here."""
        return _img.drawing_from(self.py, self.np)

    def state(self):
        return self.py.getstate(), self.np.get_state()

    def set_state(self, state):
        self.py.setstate(state[0])
        self.np.set_state(state[1])


class _RecordSource:
    """ImageRecordIter's reading state: the record reader and the epoch's
    key order, the decode pool, the crop/mirror RNG, the augmenter
    chain's generators, and the recipe."""

    def __init__(self, rec, keys, batch_size, data_shape, label_width,
                 dtype, shuffle, seed, round_batch, augs, fast, mean, std,
                 mean_arr, scale, rand_crop, rand_mirror, threads):
        self.rec, self.keys = rec, keys
        self.batch_size = batch_size
        self.data_shape = data_shape
        self.label_width = label_width
        self.dtype = dtype
        self.shuffle, self.seed = shuffle, seed
        self.round_batch = round_batch
        self.augs, self.fast = augs, fast
        self.mean, self.std = mean, std
        self.mean_arr, self.scale = mean_arr, scale
        self.rand_crop, self.rand_mirror = rand_crop, rand_mirror
        self.rng = _np.random.RandomState(seed + 12345)
        self.aug_draws = _AugDraws()
        self.pool = ThreadPoolExecutor(max_workers=int(threads),
                                       thread_name_prefix=_POOL_PREFIX)
        self.order = None
        self.cursor = 0

    def close(self):
        self.pool.shutdown(wait=True)
        self.rec.close()

    def draw_state(self):
        return self.rng.get_state(), self.aug_draws.state()

    def set_draw_state(self, state):
        self.rng.set_state(state[0])
        self.aug_draws.set_state(state[1])

    def rewind(self, epoch):
        if self.keys is not None:
            order = list(self.keys)
            if self.shuffle:
                _np.random.RandomState(self.seed + epoch).shuffle(order)
            self.order = order
        else:
            self.rec.reset()
        self.cursor = 0

    def _read_raw(self):
        if self.order is not None:
            if self.cursor >= len(self.order):
                return None
            key = self.order[self.cursor]
            self.cursor += 1
            return self.rec.read_idx(key)
        return self.rec.read()

    def _decode(self, raw):
        """(HWC image, label) of a record; the fast recipe upscales a
        source smaller than the crop, as mxtpu's ``_decode_fast``."""
        header, img = _rio.unpack(raw)
        arr = _img.imdecode_np(img)
        if self.fast:
            c, h, w = self.data_shape
            H, W = arr.shape[:2]
            if H < h or W < w:
                arr = _img.imresize_np(arr, max(w, int(W * h / H)),
                                       max(h, int(H * w / W)))
        return arr, _np.asarray(header.label, _np.float32).reshape(-1)

    def _draw(self, arr):
        """The crop's corner and the mirror of one image, in mxtpu's order
        of draws."""
        c, h, w = self.data_shape
        H, W = arr.shape[:2]
        if self.rand_crop:
            y0 = self.rng.randint(0, H - h + 1)
            x0 = self.rng.randint(0, W - w + 1)
        else:  # center crop, the reference's evaluation path
            y0, x0 = (H - h) // 2, (W - w) // 2
        mirror = bool(self.rand_mirror and self.rng.rand() < 0.5)
        return y0, x0, mirror

    def _finish(self, arr):
        """mxtpu's steps after the recipe: the mean image, then scale."""
        if self.mean_arr is not None:
            arr = arr.astype(_np.float32) - self.mean_arr
        if self.scale != 1.0:
            arr = arr.astype(_np.float32) * self.scale
        return arr

    def _place(self, out, i, arr, draw):
        c, h, w = self.data_shape
        y0, x0, mirror = draw
        arr = arr[y0:y0 + h, x0:x0 + w]
        if mirror:
            arr = arr[:, ::-1]
        if self.mean is not None or self.std is not None:
            arr = arr.astype(_np.float32)
            if self.mean is not None:
                arr = arr - self.mean
            if self.std is not None:
                arr = arr / self.std
        out[i] = self._finish(arr).reshape(h, w, c).transpose(2, 0, 1)

    def produce(self):
        c, h, w = self.data_shape
        raws = []
        while len(raws) < self.batch_size:
            raw = self._read_raw()
            if raw is None:
                break
            raws.append(raw)
        if not raws:
            return None
        pad = self.batch_size - len(raws)
        if pad and not self.round_batch:
            return None
        decoded = list(self.pool.map(self._decode, raws))
        n = len(decoded)
        data = _np.empty((self.batch_size, c, h, w), self.dtype)
        label = _np.zeros((self.batch_size, self.label_width), _np.float32)
        if self.fast:
            draws = [self._draw(arr) for arr, _ in decoded]
            list(self.pool.map(
                lambda i: self._place(data, i, decoded[i][0], draws[i]),
                range(n)))
        else:  # the augmenters draw in record order, from aug_draws
            with self.aug_draws.active():
                for i, (arr, _) in enumerate(decoded):
                    for aug in self.augs:
                        arr = _img._as_np(aug(arr)[0])
                    data[i] = self._finish(arr).reshape(h, w, c).transpose(
                        2, 0, 1)
        for i, (_, lab) in enumerate(decoded):
            label[i] = lab[:self.label_width]
        for j in range(pad):  # wrap-pad the tail batch
            data[n + j] = data[j % n]
            label[n + j] = label[j % n]
        return _io.DataBatch(
            data=[_cpu_array(data)],
            label=[_cpu_array(label[:, 0].copy() if self.label_width == 1
                              else label)],
            pad=pad, index=None)


class ImageRecordIter(_PipelineIter):
    """Decode and augment a ``.rec`` file into NCHW batches (see the
    module docstring). ``shuffle`` and ``num_parts`` need the ``.idx``
    (``path_imgidx``, or the ``.rec``'s name with ``.idx``); the epoch's
    order is a ``RandomState(seed + epoch)`` permutation; the crops and
    mirrors draw from ``RandomState(seed + 12345)``. Without ``aug_list``
    and ``resize`` the standard recipe (crop, mirror, means, std) runs in
    numpy; otherwise the augmenter chain runs on each image in record
    order, drawing from the iterator's own copies of Python's and
    numpy's generators. The tail batch is wrap-padded (``round_batch``)
    or dropped."""

    def __init__(self, path_imgrec, data_shape, batch_size,
                 path_imgidx=None, label_width=1, shuffle=False,
                 rand_crop=False, rand_mirror=False, resize=0,
                 mean_img=None, mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=0.0, std_g=0.0, std_b=0.0, scale=1.0,
                 preprocess_threads=4, prefetch_buffer=4, seed=0,
                 num_parts=1, part_index=0, round_batch=True,
                 data_name="data", label_name="softmax_label",
                 aug_list=None, dtype="float32", **kwargs):
        super().__init__(batch_size)
        dtype = _np.dtype(dtype)
        if dtype == _np.uint8 and (
                any((mean_r, mean_g, mean_b, std_r, std_g, std_b))
                or mean_img is not None or scale != 1.0):
            raise MXNetError("ImageRecordUInt8Iter yields raw uint8 "
                             "pixels; mean/std/scale do not apply")
        self.data_shape = tuple(int(x) for x in data_shape)
        self.label_width = int(label_width)
        self.shuffle = shuffle
        self.seed = seed
        self.round_batch = round_batch
        if path_imgidx is None:
            guess = os.path.splitext(path_imgrec)[0] + ".idx"
            if os.path.exists(guess):
                path_imgidx = guess
        if path_imgidx is not None:
            rec = _rio.MXIndexedRecordIO(path_imgidx, path_imgrec, "r")
            keys = list(rec.keys)
            if num_parts > 1:
                part = len(keys) // num_parts
                keys = keys[part * part_index:part * (part_index + 1)]
        else:
            if shuffle or num_parts > 1:
                raise MXNetError(
                    "shuffle/num_parts need path_imgidx (an .idx file)")
            rec, keys = _rio.MXRecordIO(path_imgrec, "r"), None
        channels = self.data_shape[0]
        mean = None
        if any((mean_r, mean_g, mean_b)):
            mean = _np.array([mean_r, mean_g, mean_b][:channels],
                             dtype=_np.float32)
        std = None
        if any((std_r, std_g, std_b)):
            std = _np.array([std_r, std_g, std_b][:channels],
                            dtype=_np.float32)
        mean_arr = None
        if mean_img is not None and os.path.exists(mean_img):
            from . import ndarray as nd
            loaded = nd.load(mean_img)
            arr = loaded["mean_img"] if isinstance(loaded, dict) \
                else loaded[0]
            mean_arr = arr.asnumpy().transpose(1, 2, 0)
        fast = aug_list is None and not resize
        augs = aug_list if aug_list is not None else _img.CreateAugmenter(
            self.data_shape, resize=resize, rand_crop=rand_crop,
            rand_mirror=rand_mirror, mean=mean, std=std)
        self.provide_data = [_io.DataDesc(data_name,
                                          (batch_size,) + self.data_shape,
                                          dtype=dtype)]
        if self.label_width > 1:
            self.provide_label = [_io.DataDesc(
                label_name, (batch_size, self.label_width))]
        else:
            self.provide_label = [_io.DataDesc(label_name, (batch_size,))]
        self._start(_RecordSource(
            rec, keys, batch_size, self.data_shape, self.label_width, dtype,
            shuffle, seed, round_batch, augs, fast, mean, std, mean_arr,
            float(scale), bool(rand_crop), bool(rand_mirror),
            preprocess_threads), prefetch_buffer)


class _DetSource:
    """ImageDetRecordIter's reading state: an ImageDetIter whose batches
    the prefetch thread makes. Its augmenters and its shuffle draw from
    the source's own generators, which a reset rewinds."""

    def __init__(self, it):
        self.it = it
        self.aug_draws = _AugDraws()

    def produce(self):
        with self.aug_draws.active():
            try:
                return self.it.next()
            except StopIteration:
                return None

    def rewind(self, epoch):
        if epoch:  # ImageIter reset (and reshuffled) itself when made
            with self.aug_draws.active():
                self.it.reset()

    def draw_state(self):
        return self.aug_draws.state()

    def set_draw_state(self, state):
        self.aug_draws.set_state(state)

    def close(self):
        rec = self.it.imgrec
        if rec is not None:
            rec.close()


class ImageDetRecordIter(_PipelineIter):
    """Detection batches from a ``.rec`` of ``[header_width,
    object_width, ...]`` labels (parity ImageDetRecordIter,
    src/io/iter_image_det_recordio.cc): ImageDetIter's label-aware
    augmenter chain, run by the native prefetch thread. Labels come out
    (batch, objects, object_width), padded with -1 rows."""

    def __init__(self, path_imgrec, data_shape, batch_size,
                 path_imgidx=None, shuffle=False, mean_pixels=None,
                 rand_mirror_prob=0.0, rand_crop_prob=0.0,
                 rand_pad_prob=0.0, max_pad_scale=3.0, label_pad_width=0,
                 min_object_covered=0.1, preprocess_threads=4,
                 num_parts=1, part_index=0, data_name="data",
                 label_name="label", **kwargs):
        super().__init__(batch_size)
        from .image.detection import CreateDetAugmenter, ImageDetIter
        mean = None
        if mean_pixels is not None:
            mean = _np.asarray(mean_pixels, _np.float32)
        aug = CreateDetAugmenter(
            data_shape, rand_crop=rand_crop_prob, rand_pad=rand_pad_prob,
            rand_mirror=rand_mirror_prob > 0, mean=mean,
            min_object_covered=min_object_covered,
            area_range=(0.05, max_pad_scale))
        it = ImageDetIter(
            batch_size=batch_size, data_shape=data_shape,
            path_imgrec=path_imgrec, path_imgidx=path_imgidx,
            shuffle=shuffle, num_parts=num_parts, part_index=part_index,
            aug_list=aug, data_name=data_name, label_name=label_name)
        if label_pad_width:
            it.reshape(label_shape=(
                batch_size, int(label_pad_width) // it.object_width,
                it.object_width))
        self.object_width = it.object_width
        self.provide_data = it.provide_data
        self.provide_label = it.provide_label
        self._start(_DetSource(it), prefetch_buffer=4)


class ImageRecordUInt8Iter(ImageRecordIter):
    """ImageRecordIter yielding raw uint8 pixels (parity
    ImageRecordUInt8Iter, src/io/iter_image_recordio_2.cc:602): a
    quarter of the float batch's bytes to copy; normalize on the device."""

    def __init__(self, **kwargs):
        kwargs["dtype"] = "uint8"
        super().__init__(**kwargs)


# the reference keeps its previous iterators registered under _v1 names
# (src/io/iter_image_recordio.cc:337,361); one implementation serves both
ImageRecordIter_v1 = ImageRecordIter
ImageRecordUInt8Iter_v1 = ImageRecordUInt8Iter
