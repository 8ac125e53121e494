"""Bucketed sequence data iterators (parity python/mxnet/rnn/io.py).

Counterpart of ``mxtpu/rnn/io.py``: ``encode_sentences`` and
``BucketSentenceIter`` with ``checkpoint_state``/``restore_state``. The
iterator shuffles with Python's ``random`` and numpy's global RNG as
mxtpu's does, so the same seeds give the same batches and bucket keys in
both packages. Batches are cpu() NDArrays; the module copies them to its
device.
"""
from __future__ import annotations

import bisect
import logging
import random

import numpy as np

from ..context import cpu
from ..io import DataBatch, DataDesc, DataIter
from ..ndarray import array

__all__ = ["encode_sentences", "BucketSentenceIter"]


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0):
    """Map token lists to int lists, building/extending a vocab
    (parity rnn/io.py:29)."""
    idx = start_label
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        new_vocab = True
    else:
        new_vocab = False
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                assert new_vocab, "Unknown token %s" % word
                if idx == invalid_label:
                    idx += 1
                vocab[word] = idx
                idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """Pads variable-length int sequences into fixed bucket lengths; each
    batch comes from one bucket, so a BucketingModule binds one module
    per bucket length (parity rnn/io.py:78)."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NT"):
        super().__init__(batch_size)
        if not buckets:
            counts = np.bincount([len(s) for s in sentences])
            buckets = [i for i, j in enumerate(counts)
                       if j >= batch_size]
        buckets.sort()
        ndiscard = 0
        self.data = [[] for _ in buckets]
        for sent in sentences:
            buck = bisect.bisect_left(buckets, len(sent))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sent)] = sent
            self.data[buck].append(buff)
        self.data = [np.asarray(i, dtype=dtype) for i in self.data]
        if ndiscard:
            logging.warning("discarded %d sentences longer than the largest "
                            "bucket", ndiscard)

        self.batch_size = batch_size
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.nddata = []
        self.ndlabel = []
        self.major_axis = layout.find("N")
        self.layout = layout
        self.default_bucket_key = max(buckets)

        if self.major_axis == 0:
            self.provide_data = [DataDesc(
                name=self.data_name,
                shape=(batch_size, self.default_bucket_key),
                layout=layout)]
            self.provide_label = [DataDesc(
                name=self.label_name,
                shape=(batch_size, self.default_bucket_key),
                layout=layout)]
        elif self.major_axis == 1:
            self.provide_data = [DataDesc(
                name=self.data_name,
                shape=(self.default_bucket_key, batch_size),
                layout=layout)]
            self.provide_label = [DataDesc(
                name=self.label_name,
                shape=(self.default_bucket_key, batch_size),
                layout=layout)]
        else:
            raise ValueError("Invalid layout %s: Must by NT (batch major) or "
                             "TN (time major)" % layout)

        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend([(i, j) for j in
                             range(0, len(buck) - batch_size + 1,
                                   batch_size)])
        self.curr_idx = 0
        self._order = None  # per-bucket row permutations of the last reset
        self.reset()

    def reset(self):
        self.curr_idx = 0
        random.shuffle(self.idx)
        # permutation-based shuffle (rather than shuffling the buckets in
        # place): the (idx order, per-bucket permutation) pair fully
        # determines the epoch's batch stream, so checkpoint_state can
        # capture it and a resumed process reproduces the exact batches
        self._order = [np.random.permutation(len(buck))
                       for buck in self.data]
        self._rebuild()

    def _rebuild(self):
        self.nddata = []
        self.ndlabel = []
        for buck, order in zip(self.data, self._order):
            buck = buck[order]
            label = np.empty_like(buck)
            label[:, :-1] = buck[:, 1:]
            label[:, -1] = self.invalid_label
            self.nddata.append(array(buck, ctx=cpu(), dtype=self.dtype))
            self.ndlabel.append(array(label, ctx=cpu(), dtype=self.dtype))

    # ------------------------------------------------- elastic cursor
    def checkpoint_state(self):
        """Exact position for fit-resume: batch cursor, the shuffled
        bucket-batch schedule, and the per-bucket row permutations."""
        return {"curr_idx": int(self.curr_idx),
                "idx_bucket": np.asarray([i for i, _ in self.idx],
                                         dtype=np.int64),
                "idx_offset": np.asarray([j for _, j in self.idx],
                                         dtype=np.int64),
                "order": {str(k): np.asarray(o)
                          for k, o in enumerate(self._order)}}

    def restore_state(self, state):
        if not isinstance(state, dict) or "curr_idx" not in state:
            return False
        order = state.get("order") or {}
        if len(order) != len(self.data):
            return False
        buckets = [int(b) for b in np.asarray(state["idx_bucket"])]
        offsets = [int(j) for j in np.asarray(state["idx_offset"])]
        if len(buckets) != len(self.idx):
            return False
        self.idx = list(zip(buckets, offsets))
        self._order = [np.asarray(order[str(k)], dtype=np.int64)
                       for k in range(len(self.data))]
        self.curr_idx = int(state["curr_idx"])
        self._rebuild()
        return True

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        if self.major_axis == 1:
            data = self.nddata[i][j:j + self.batch_size].T
            label = self.ndlabel[i][j:j + self.batch_size].T
        else:
            data = self.nddata[i][j:j + self.batch_size]
            label = self.ndlabel[i][j:j + self.batch_size]
        return DataBatch([data], [label], pad=0,
                         bucket_key=self.buckets[i],
                         provide_data=[DataDesc(self.data_name, data.shape,
                                                layout=self.layout)],
                         provide_label=[DataDesc(self.label_name, label.shape,
                                                 layout=self.layout)])
