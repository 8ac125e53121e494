"""The port's record iterators (``mxtpu_torch/image_record.py`` over the
native prefetch thread) against mxtpu's, on small JPEG ``.rec`` files:

- ``ImageRecordIter`` bit for bit against mxtpu's at one decode thread
  with the random crop, mirror and means (mxtpu draws them inside its
  decode pool, so only its one-thread batches are reproducible), and at
  four threads without random augmentation; the port's batches the same
  at 1 and 8 threads; the sequential (no ``.idx``) reader, label arrays,
  ``num_parts``, ``round_batch``, the augmenter-chain path, a mean image;
- ``ImageRecordUInt8Iter`` against mxtpu's and against the float
  iterator's pixels; ``ImageDetRecordIter`` against mxtpu's;
- a reset in the middle of an epoch draws as if the prefetcher had not
  run ahead; ``close()``; a producer's error at the consumer; the
  iterator dropped mid-epoch under a busy GC, in a subprocess;
- every name with mxtpu's signature; the twin of
  tests/test_examples_gate.py::test_train_imagenet_on_packed_rec through
  ``chip_smoke.train_imagenet_twin`` on the CPU.

mxtpu's iterators are closed with ``it._prefetcher.close()`` (its class
has no ``close``, and collecting a running one can crash the process).
"""
import inspect
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import mxtpu as mx

cv2 = pytest.importorskip("cv2")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


@pytest.fixture(scope="module")
def rec(mt, tmp_path_factory):
    """22 JPEGs of 40x40 with labels i % 4, and the ``.idx``."""
    d = tmp_path_factory.mktemp("rec")
    return mt.test_utils.make_rec(str(d / "a.rec"), 22, edge=40,
                                  num_classes=4)


def _epochs(it, epochs=2):
    out = []
    for epoch in range(epochs):
        if epoch:
            it.reset()
        for b in it:
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    return out


def _ours(mt, epochs=2, **kw):
    it = mt.io.ImageRecordIter(**kw)
    try:
        return _epochs(it, epochs)
    finally:
        it.close()


def _theirs(epochs=2, **kw):
    it = mx.io.ImageRecordIter(**kw)
    try:
        return _epochs(it, epochs)
    finally:
        it._prefetcher.close()


def _same(a, b):
    assert len(a) == len(b)
    for (xa, la, pa), (xb, lb, pb) in zip(a, b):
        assert xa.dtype == xb.dtype
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(la, lb)
        assert pa == pb


RANDOM = dict(data_shape=(3, 32, 32), batch_size=8, shuffle=True,
              rand_crop=True, rand_mirror=True, mean_r=123.68,
              mean_g=116.779, mean_b=103.939, seed=3)


def test_one_thread_with_crop_mirror_and_means_is_mxtpus(mt, rec):
    ours = _ours(mt, path_imgrec=rec, preprocess_threads=1, **RANDOM)
    _same(ours, _theirs(path_imgrec=rec, preprocess_threads=1, **RANDOM))
    assert [p for _, _, p in ours] == [0, 0, 2] * 2
    assert ours[0][0].shape == (8, 3, 32, 32)
    assert ours[0][0].dtype == np.float32


@pytest.mark.parametrize("threads", [8, 3])
def test_batches_do_not_depend_on_the_thread_count(mt, rec, threads):
    _same(_ours(mt, path_imgrec=rec, preprocess_threads=threads, **RANDOM),
          _ours(mt, path_imgrec=rec, preprocess_threads=1, **RANDOM))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(shuffle=True, seed=5, std_r=2.0, std_g=3.0, std_b=4.0,
         mean_r=1.0, mean_g=2.0, mean_b=3.0, scale=0.5),
    dict(round_batch=False),
    dict(data_shape=(3, 48, 44)),  # upscaled: the sources are 40x40
], ids=["plain", "shuffle_std_scale", "no_round", "upscale"])
def test_four_threads_without_random_augmentation_are_mxtpus(mt, rec, kw):
    args = dict(path_imgrec=rec, data_shape=(3, 32, 32), batch_size=8,
                preprocess_threads=4)
    args.update(kw)
    _same(_ours(mt, **args), _theirs(**args))


def test_sequential_reader_label_arrays_and_parts(mt, tmp_path):
    from mxtpu_torch import recordio
    path = str(tmp_path / "s.rec")
    w = recordio.MXRecordIO(path, "w")  # no .idx: read in file order
    rng = np.random.RandomState(1)
    for i in range(11):
        ok, buf = cv2.imencode(".png", rng.randint(0, 255, (36, 36, 3),
                                                   dtype=np.uint8))
        w.write(recordio.pack(recordio.IRHeader(0, [i, i + 0.5, -i], i, 0),
                              buf.tobytes()))
    w.close()
    kw = dict(path_imgrec=path, data_shape=(3, 30, 30), batch_size=4,
              label_width=3, rand_crop=True, preprocess_threads=1)
    ours = _ours(mt, **kw)
    _same(ours, _theirs(**kw))
    assert ours[0][1].shape == (4, 3)
    with pytest.raises(mt.MXNetError, match="idx"):
        mt.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 30, 30),
                              batch_size=4, shuffle=True)


def test_num_parts_are_mxtpus(mt, rec):
    parts = []
    for part in range(3):
        kw = dict(path_imgrec=rec, data_shape=(3, 32, 32), batch_size=4,
                  num_parts=3, part_index=part, preprocess_threads=2)
        ours = _ours(mt, epochs=1, **kw)
        _same(ours, _theirs(epochs=1, **kw))
        parts.append(np.concatenate([lab for _, lab, _ in ours]))
    assert [len(p) for p in parts] == [8, 8, 8]  # 7 records a part


def test_augmenter_chain_path_is_mxtpus(mt, rec, tmp_path):
    """``resize`` (and an ``aug_list``) take the augmenter chain, which
    draws from Python's random; the port runs it in record order."""
    import random
    mean = np.random.RandomState(0).rand(3, 32, 32).astype(np.float32)
    mt.nd.save(str(tmp_path / "mean.nd"),
               {"mean_img": mt.nd.array(mean, ctx=mt.cpu())})
    kw = dict(path_imgrec=rec, data_shape=(3, 32, 32), batch_size=8,
              resize=36, rand_crop=True, rand_mirror=True,
              mean_img=str(tmp_path / "mean.nd"), preprocess_threads=1)
    random.seed(4)
    ours = _ours(mt, **kw)
    random.seed(4)
    _same(ours, _theirs(**kw))
    random.seed(4)
    _same(_ours(mt, **dict(kw, preprocess_threads=6)), ours)
    augs = [mt.image.CenterCropAug((32, 32)), mt.image.CastAug()]
    got = _ours(mt, epochs=1, path_imgrec=rec, data_shape=(3, 32, 32),
                batch_size=8, aug_list=augs)
    want = _theirs(epochs=1, path_imgrec=rec, data_shape=(3, 32, 32),
                   batch_size=8, aug_list=[mx.image.CenterCropAug((32, 32)),
                                           mx.image.CastAug()])
    _same(got, want)


def test_uint8_iterator_is_mxtpus_and_the_float_pixels(mt, rec):
    kw = dict(path_imgrec=rec, data_shape=(3, 32, 32), batch_size=8,
              rand_crop=True, rand_mirror=True, shuffle=True,
              preprocess_threads=1)
    it = mt.io.ImageRecordUInt8Iter(**kw)
    assert it.provide_data[0].dtype == np.uint8
    ours = _epochs(it)
    it.close()
    theirs = mx.io.ImageRecordUInt8Iter(**kw)
    want = _epochs(theirs)
    theirs._prefetcher.close()
    _same(ours, want)
    floats = _ours(mt, **kw)
    for (a, la, _), (b, lb, _) in zip(ours, floats):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a.astype(np.float32), b)
        np.testing.assert_array_equal(la, lb)
    with pytest.raises(mt.MXNetError, match="uint8"):
        mt.io.ImageRecordUInt8Iter(mean_r=1.0, **kw)
    for name in ("ImageRecordIter", "ImageRecordUInt8Iter",
                 "ImageRecordIter_v1", "ImageRecordUInt8Iter_v1"):
        made = mt.io.create_iterator(name, **kw)
        assert made.next().data[0].shape == (8, 3, 32, 32)
        made.close()


def test_det_record_iter_is_mxtpus(mt, tmp_path):
    import random
    path = mt.test_utils.make_det_rec(str(tmp_path / "d.rec"), 10, edge=48,
                                      num_classes=3)
    kw = dict(path_imgrec=path, data_shape=(3, 40, 40), batch_size=4,
              shuffle=True, mean_pixels=(123, 117, 104),
              rand_mirror_prob=0.5, rand_crop_prob=0.5, rand_pad_prob=0.5)
    random.seed(2)
    it = mt.io.ImageDetRecordIter(**kw)
    ours = _epochs(it)
    assert it.provide_label[0].shape == (4, 16, 5) and it.object_width == 5
    it.close()
    random.seed(2)
    _same(ours, _epochs(mx.io.ImageDetRecordIter(**kw)))
    for _, lab, _ in ours:
        boxes = lab[lab[..., 0] >= 0][:, 1:5]
        assert boxes.size and boxes.min() >= 0.0 and boxes.max() <= 1.0
    padded = mt.io.create_iterator("ImageDetRecordIter",
                                   label_pad_width=30, **kw)
    assert padded.provide_label[0].shape == (4, 6, 5)
    padded.close()


def test_reset_mid_epoch_draws_as_if_nothing_ran_ahead(mt, rec):
    """Whether the prefetcher made at most 2 or about 9 of the epoch's 11
    batches ahead before a reset, the next epoch's crops are the same."""
    runs = []
    for buffer, wait in ((1, 0.0), (8, 0.5)):
        it = mt.io.ImageRecordIter(path_imgrec=rec, prefetch_buffer=buffer,
                                   preprocess_threads=2,
                                   **dict(RANDOM, batch_size=2))
        first = it.next().data[0].asnumpy()
        time.sleep(wait)  # let the producer fill its queue
        it.reset()
        runs.append([first] + [b.data[0].asnumpy() for b in it])
        it.close()
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


def _chain_iter(mt, rec, path, **kw):
    """A port iterator whose augmenter chain draws from Python's random:
    ``resize`` on ImageRecordIter, or ImageDetRecordIter."""
    if path == "resize":
        return mt.io.ImageRecordIter(
            path_imgrec=rec, data_shape=(3, 32, 32), batch_size=2,
            resize=36, rand_crop=True, rand_mirror=True, shuffle=True,
            preprocess_threads=2, **kw)
    det = mt.test_utils.make_det_rec(rec[:-4] + "_det.rec", 22, edge=48,
                                     num_classes=3)
    return mt.io.ImageDetRecordIter(
        path_imgrec=det, data_shape=(3, 40, 40), batch_size=2,
        shuffle=True, rand_mirror_prob=0.5, rand_crop_prob=0.5,
        rand_pad_prob=0.5, **kw)


def _pairs(it, n=None):
    out = []
    for b in it:
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy()))
        if n is not None and len(out) == n:
            break
    return out


@pytest.mark.parametrize("path", ["resize", "det"])
def test_chain_reset_mid_epoch_draws_as_if_nothing_ran_ahead(mt, rec, path):
    """The augmenter chains rewind at a reset as the fast path's crops
    do: a producer that ran ahead by 0 or ~9 batches changes nothing."""
    import random
    runs = []
    for buffer, wait in ((1, 0.0), (8, 0.5)):
        random.seed(7)
        it = _chain_iter(mt, rec, path, prefetch_buffer=buffer)
        first = _pairs(it, 1)
        time.sleep(wait)  # let the producer fill its queue
        it.reset()
        runs.append(first + _pairs(it))
        it.close()
    assert len(runs[0]) == len(runs[1]) == 12
    for (xa, la), (xb, lb) in zip(*runs):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(la, lb)


@pytest.mark.parametrize("path", ["resize", "det"])
def test_chain_draws_leave_the_callers_random_alone(mt, rec, path):
    """The producer thread draws from the iterator's own generators: the
    caller's draws from Python's and numpy's global generators during an
    epoch change no batch, and the iterator moves neither of them."""
    import random
    runs = []
    for interleave in (False, True):
        random.seed(11)
        np.random.seed(11)
        it = _chain_iter(mt, rec, path, prefetch_buffer=2)
        py0, np0 = random.getstate(), np.random.get_state()[1].copy()
        got, mine = [], []
        for epoch in range(2):
            if epoch:
                it.reset()
            for b in it:
                got.append((b.data[0].asnumpy(), b.label[0].asnumpy()))
                if interleave:
                    mine.append((random.random(), np.random.rand()))
        it.close()
        if interleave:
            random.setstate(py0)
            np.random.seed(11)
            assert mine == [(random.random(), np.random.rand())
                            for _ in mine]
        else:
            assert random.getstate() == py0
            np.testing.assert_array_equal(np.random.get_state()[1], np0)
        runs.append(got)
    assert len(runs[0]) == len(runs[1]) == 22
    for (xa, la), (xb, lb) in zip(*runs):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(la, lb)


def test_close_is_idempotent_and_final(mt, rec):
    it = mt.io.ImageRecordIter(path_imgrec=rec, data_shape=(3, 32, 32),
                               batch_size=8)
    it.next()
    it.close()
    it.close()
    with pytest.raises(mt.MXNetError, match="closed"):
        it.next()
    with pytest.raises(mt.MXNetError, match="closed"):
        it.reset()


def test_a_producer_error_surfaces_at_the_consumer(mt, tmp_path):
    from mxtpu_torch import recordio
    path = str(tmp_path / "bad.rec")
    w = recordio.MXIndexedRecordIO(str(tmp_path / "bad.idx"), path, "w")
    ok, buf = cv2.imencode(".jpg", np.zeros((40, 40, 3), np.uint8))
    for i in range(6):
        body = buf.tobytes() if i != 4 else b"not a jpeg"
        w.write_idx(i, recordio.pack(recordio.IRHeader(0, 0.0, i, 0), body))
    w.close()
    it = mt.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 32, 32),
                               batch_size=2)
    it.next()
    it.next()
    with pytest.raises(mt.MXNetError, match="cannot decode"):
        it.next()
    it.close()


_GC_SCRIPT = r"""
import gc, sys
sys.path.insert(0, %(repo)r)
import torch
torch.set_num_threads(1)
import mxtpu_torch as mt
gc.set_threshold(50, 2, 2)  # collections run often, on every thread
for _ in range(12):
    it = mt.io.ImageRecordIter(path_imgrec=%(rec)r, data_shape=(3, 32, 32),
                               batch_size=4, shuffle=True, rand_crop=True,
                               preprocess_threads=2, prefetch_buffer=2)
    it.myself = it  # only the GC can collect it
    it.next()
    del it
    for _ in range(15):
        gc.collect()
        junk = [[i] for i in range(500)]
print("survived")
"""


def test_dropped_mid_epoch_under_the_gc_in_a_subprocess(mt, rec):
    out = subprocess.run([sys.executable, "-c",
                          _GC_SCRIPT % {"repo": REPO, "rec": rec}],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("survived")


NAMES = {
    "io": ["ImageRecordIter", "ImageRecordUInt8Iter", "ImageRecordIter_v1",
           "ImageRecordUInt8Iter_v1", "ImageDetRecordIter", "ResizeIter",
           "CSVIter", "MNISTIter", "LibSVMIter", "create_iterator",
           "register_iter", "MXDataIter", "NDArrayIter"],
    "image_record": ["ImageRecordIter", "ImageDetRecordIter",
                     "ImageRecordUInt8Iter", "ImageRecordIter_v1",
                     "ImageRecordUInt8Iter_v1"],
    "recordio": ["MXRecordIO", "MXIndexedRecordIO", "pack", "unpack",
                 "pack_img", "unpack_img"],
    "image": list(mx.image.image.__all__) + [
        "ImageDetIter", "CreateDetAugmenter"],
    "image.detection": list(mx.image.detection.__all__) + [
        "CreateMultiRandCropAugmenter"],
    "metric": ["TopKAccuracy"],
    "nd": ["imread", "imresize", "imdecode"],
}


def _resolve(pkg, path):
    for part in path.split("."):
        pkg = getattr(pkg, part)
    return pkg


@pytest.mark.parametrize("path", sorted(NAMES))
def test_every_record_pipeline_name_has_mxtpus_signature(mt, path):
    import importlib
    theirs = importlib.import_module("mxtpu." + path) if path != "nd" \
        else mx.nd
    ours = _resolve(mt, path)
    for name in NAMES[path]:
        a, b = getattr(ours, name), getattr(theirs, name)
        if inspect.isclass(b):
            a, b = a.__init__, b.__init__
        assert inspect.signature(a) == inspect.signature(b), (path, name)
    if hasattr(theirs, "__all__"):
        assert set(theirs.__all__) <= set(dir(ours)), path


def test_train_imagenet_twin_on_packed_rec(mt, tmp_path):
    """Twin of tests/test_examples_gate.py::test_train_imagenet_on_packed_
    rec: a resnet-18 at 3x32x32, B=16, two epochs over a 96-record .rec,
    every line of train_imagenet.py:64-106 in the port's names, on the
    CPU; the Speedometer measures a throughput above 0."""
    sys.path.insert(0, REPO)
    import chip_smoke
    path = mt.test_utils.make_rec(str(tmp_path / "synth.rec"), 96, edge=40,
                                  num_classes=10)
    np.random.seed(0)
    mod, speeds, train, val = chip_smoke.train_imagenet_twin(
        mt, mt.cpu(), path, data_val=path, num_layers=18,
        image_shape=(3, 32, 32), num_classes=10, batch_size=16,
        num_epochs=2, kv_store="local", speedometer_period=2)
    train.close()
    val.close()
    assert speeds and speeds[-1] > 0, "no steady-state throughput measured"
    names = [n for n, _ in mod.score(mt.io.NDArrayIter(
        np.zeros((16, 3, 32, 32), np.float32), np.zeros(16, np.float32),
        batch_size=16), [mt.metric.Accuracy(),
                         mt.metric.TopKAccuracy(top_k=5)])]
    assert names == ["accuracy", "top_k_accuracy_5"]


def test_chip_smoke_records_iterator_gates_hold_on_the_cpu(mt, tmp_path,
                                                          monkeypatch):
    """chip_smoke's phase 13 packing and iterator gates at a tiny size:
    epochs at 1, 2 and 4 threads bit-identical, the first batch equal to
    its independent numpy decode, the tail's pad, the uint8 pixels."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    monkeypatch.setitem(cs.RESNET, "image_shape", (3, 32, 32))
    monkeypatch.setattr(cs, "RECORDS", dict(
        cs.RECORDS, train=24, val=14, edge=40, det=4, det_edge=48, batch=8,
        threads=(2, 4), tail_batch=6, uint8_batches=2))
    paths = cs.records_pack(mt, str(tmp_path), seed=1)
    assert paths["train"]["records"] == 24
    assert paths["det"]["bytes"] > 0
    res = cs.records_iterator(mt, paths, seed=1, card="cpu")
    assert res["decode_err"] == 0.0 and res["tail_pad"] == 4
    assert res["uint8_equal"] == [True, True]
    assert set(res["rates"]) == {1, 2, 4}
