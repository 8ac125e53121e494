"""The rest of the port's ``io`` and ``metric.TopKAccuracy`` against
mxtpu's: ``ResizeIter`` (and its checkpoint state), ``NDArrayIter``
with ``num_workers``, ``hard_reset``, ``close``, ``checkpoint_state``/
``restore_state``; ``MNISTIter`` over idx files the test writes,
``CSVIter``, ``LibSVMIter`` (csr and dense), ``MXDataIter`` and
``create_iterator``; ``TopKAccuracy`` on the host and through
``DeviceMetricAccum`` on the CPU, beside ``Accuracy`` in one composite.
"""
import gzip
import struct

import numpy as np
import pytest

import mxtpu as mx


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


def _dense(x):
    """numpy of an NDArray of either package (a csr batch's dense view)."""
    return x.asnumpy()


def _batches(it, epochs=1):
    out = []
    for epoch in range(epochs):
        if epoch:
            it.reset()
        for b in it:
            out.append(([_dense(d) for d in b.data],
                        [_dense(lab) for lab in b.label], b.pad))
    return out


def _same(a, b):
    assert len(a) == len(b)
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        for x, y in zip(da + la, db + lb):
            np.testing.assert_array_equal(x, np.asarray(y, x.dtype))
        assert pa == pb


def _arrays(n=23, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 3, 4).astype(np.float32),
            rng.randint(0, 5, n).astype(np.float32))


@pytest.mark.parametrize("size", [3, 7])
def test_resize_iter_is_mxtpus(mt, size):
    x, y = _arrays()
    ours = mt.io.ResizeIter(mt.io.NDArrayIter(x, y, batch_size=5), size)
    theirs = mx.io.ResizeIter(mx.io.NDArrayIter(x, y, batch_size=5), size)
    _same(_batches(ours, 3), _batches(theirs, 3))
    assert ours.provide_data[0].shape == (5, 3, 4)
    ours.reset()
    ours.next()
    state = ours.checkpoint_state()
    assert state["cur"] == 1
    want = ours.next().data[0].asnumpy()
    fresh = mt.io.ResizeIter(mt.io.NDArrayIter(x, y, batch_size=5), size)
    assert fresh.restore_state(state)
    np.testing.assert_array_equal(fresh.next().data[0].asnumpy(), want)
    assert not fresh.restore_state({"nothing": 1})


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_ndarray_iter_workers_match_the_plain_iterator(mt, handle):
    x, y = _arrays()
    plain = _batches(mt.io.NDArrayIter(x, y, batch_size=4,
                                       last_batch_handle=handle), 2)
    it = mt.io.NDArrayIter(x, y, batch_size=4, last_batch_handle=handle,
                           num_workers=2)
    _same(_batches(it, 2), plain)
    _same(plain, _batches(mx.io.NDArrayIter(x, y, batch_size=4,
                                            last_batch_handle=handle), 2))
    it.close()
    it.close()
    it.hard_reset()
    _same(_batches(it), _batches(mt.io.NDArrayIter(
        x, y, batch_size=4, last_batch_handle=handle)))


def test_ndarray_iter_checkpoint_state_is_mxtpus(mt):
    x, y = _arrays()
    np.random.seed(3)
    ours = mt.io.NDArrayIter(x, y, batch_size=4, shuffle=True)
    np.random.seed(3)
    theirs = mx.io.NDArrayIter(x, y, batch_size=4, shuffle=True)
    for it in (ours, theirs):
        it.next()
        it.next()
    a, b = ours.checkpoint_state(), theirs.checkpoint_state()
    assert a["cursor"] == b["cursor"] == 4
    np.testing.assert_array_equal(a["idx"], b["idx"])
    np.random.seed(9)  # a resumed process draws another permutation
    fresh = mt.io.NDArrayIter(x, y, batch_size=4, shuffle=True,
                              num_workers=1)
    assert fresh.restore_state(b)
    _same(_batches(fresh), _batches(ours))
    fresh.close()
    assert not fresh.restore_state({"cursor": 0, "idx": np.arange(3)})
    assert not fresh.restore_state(None)
    assert mt.io.DataIter().checkpoint_state() is None
    assert mt.io.DataIter().restore_state({}) is False


def _write_idx(path, arr, gz=False):
    head = struct.pack(">II", 0x803 if arr.ndim == 3 else 0x801,
                       arr.shape[0])
    if arr.ndim == 3:
        head += struct.pack(">II", *arr.shape[1:])
    opener = gzip.open if gz else open
    with opener(path, "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("kw", [dict(), dict(flat=True, shuffle=False),
                                dict(num_parts=2, part_index=1, seed=4)])
def test_mnist_iter_is_mxtpus(mt, tmp_path, kw):
    rng = np.random.RandomState(1)
    _write_idx(str(tmp_path / "img"), rng.randint(0, 255, (50, 28, 28)))
    _write_idx(str(tmp_path / "lab.gz"), rng.randint(0, 10, 50), gz=True)
    args = dict(image=str(tmp_path / "img"), label=str(tmp_path / "lab"),
                batch_size=8, **kw)
    ours = mt.io.MNISTIter(**args)
    _same(_batches(ours), _batches(mx.io.MNISTIter(**args)))
    assert ours.provide_data[0].shape == ((8, 784) if kw.get("flat")
                                          else (8, 1, 28, 28))
    with pytest.raises(mt.MXNetError, match="not found"):
        mt.io.MNISTIter(image=str(tmp_path / "none"), label=args["label"])


@pytest.mark.parametrize("round_batch", [True, False])
def test_csv_iter_is_mxtpus(mt, tmp_path, round_batch):
    rng = np.random.RandomState(2)
    np.savetxt(str(tmp_path / "d.csv"), rng.rand(13, 6), delimiter=",")
    np.savetxt(str(tmp_path / "l.csv"), rng.randint(0, 3, (13, 1)),
               delimiter=",")
    for extra in (dict(label_csv=str(tmp_path / "l.csv")), dict()):
        args = dict(data_csv=str(tmp_path / "d.csv"), data_shape=(2, 3),
                    batch_size=5, round_batch=round_batch, **extra)
        _same(_batches(mt.io.CSVIter(**args), 2),
              _batches(mx.io.CSVIter(**args), 2))


@pytest.mark.parametrize("dense", [False, True])
def test_libsvm_iter_is_mxtpus(mt, tmp_path, dense):
    lines = ["1 0:1.5 3:2", "0 2:0.5", "1", "0 1:1 4:-1 5:3", "1 5:7",
             "", "0 0:2 2:2"]
    (tmp_path / "x.svm").write_text("\n".join(lines) + "\n")
    args = dict(data_libsvm=str(tmp_path / "x.svm"), data_shape=(6,),
                batch_size=4, dense=dense)
    ours = mt.io.create_iterator("LibSVMIter", **args)
    _same(_batches(ours, 2), _batches(mx.io.LibSVMIter(**args), 2))
    if not dense:
        ours.reset()
        theirs = mx.io.LibSVMIter(**args)
        for mine, ref in zip(ours, theirs):
            x, y = mine.data[0], ref.data[0]
            assert isinstance(x, mt.nd.CSRNDArray) and x.stype == "csr"
            assert x.context == mt.cpu() and x.shape == y.shape
            for part in ("data", "indices", "indptr"):
                got, want = getattr(x, part), getattr(y, part)
                assert got.dtype == want.dtype, part
                np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
        wide = dict(args, batch_size=11)  # pad beyond the row count
        _same(_batches(mt.io.LibSVMIter(**wide)),
              _batches(mx.io.LibSVMIter(**wide)))


def test_create_iterator_and_mxdataiter(mt):
    x, y = _arrays()
    it = mt.io.MXDataIter(mt.io.NDArrayIter(x, y, batch_size=6))
    assert it.provide_data[0].shape == (6, 3, 4) and it.cursor == -6
    _same(_batches(it, 2), _batches(mx.io.MXDataIter(
        mx.io.NDArrayIter(x, y, batch_size=6)), 2))
    with pytest.raises(AttributeError):
        it.no_such_attribute
    with pytest.raises(mt.MXNetError, match="Cannot find"):
        mt.io.create_iterator("NoSuchIter")

    @mt.io.register_iter
    def TinyIter(batch_size=2):
        return mt.io.NDArrayIter(x[:4], y[:4], batch_size=batch_size)

    assert len(_batches(mt.io.create_iterator("tinyiter"))) == 2


def _scores(seed, n=37, classes=9):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, classes, n).astype(np.float32),
            rng.rand(n, classes).astype(np.float32))


@pytest.mark.parametrize("top_k", [2, 5, 12])
def test_top_k_accuracy_is_mxtpus(mt, top_k):
    ours = mt.metric.TopKAccuracy(top_k=top_k)
    theirs = mx.metric.TopKAccuracy(top_k=top_k)
    for seed in range(3):
        lab, pred = _scores(seed)
        ours.update([mt.nd.array(lab, ctx=mt.cpu())],
                    [mt.nd.array(pred, ctx=mt.cpu())])
        theirs.update([mx.nd.array(lab)], [mx.nd.array(pred)])
    assert ours.get() == theirs.get()
    assert ours.get()[0] == "top_k_accuracy_%d" % top_k
    assert (ours.sum_metric, ours.num_inst) == \
        (theirs.sum_metric, theirs.num_inst)
    assert isinstance(mt.metric.create("top_k_accuracy", top_k=3),
                      mt.metric.TopKAccuracy)
    with pytest.raises(AssertionError):
        mt.metric.TopKAccuracy(top_k=1)


def test_top_k_accuracy_on_the_device_accumulator(mt):
    """DeviceMetricAccum folds TopKAccuracy (beside Accuracy) into device
    sums on the pred's device (here the CPU): one host copy a sync, the
    host path's values."""
    import torch
    host = mt.metric.CompositeEvalMetric([mt.metric.Accuracy(),
                                          mt.metric.TopKAccuracy(top_k=3)])
    dev = mt.metric.CompositeEvalMetric([mt.metric.Accuracy(),
                                         mt.metric.TopKAccuracy(top_k=3)])
    accum = mt.metric.DeviceMetricAccum.wrap(dev)
    assert accum is not None
    for seed in range(4):
        lab, pred = _scores(seed + 10)
        pred[0, :] = 0.5  # ties rank the later index higher on both paths
        host.update([mt.nd.array(lab, ctx=mt.cpu())],
                    [mt.nd.array(pred, ctx=mt.cpu())])
        accum.update([torch.from_numpy(lab)], [torch.from_numpy(pred)])
    snap = accum.sync()
    assert accum.syncs == 1
    assert snap == host.get_name_value()
    for a, b in zip(host.metrics, dev.metrics):
        assert (a.sum_metric, a.num_inst) == (b.sum_metric, b.num_inst)
