"""Gluon's datasets in mxtpu_torch against mxtpu's, on files the tests
write (neither package downloads): MNIST and FashionMNIST from idx files
(raw and .gz), CIFAR10 from its pickled batches (the directory and the
tar.gz), ``RecordFileDataset`` and ``ImageRecordDataset`` over a ``.rec``
packed by ``test_utils.make_rec``, and ``ImageFolderDataset`` over a
folder of PNG and JPEG files. Each compares lengths, every item's image
(dtype, shape, bytes; a float transform's within 1e-6) and label,
``synsets``, a transform's result, and the error a missing file raises.

torch is imported lazily and pinned to one thread: several test workers
share the host."""
import gzip
import os
import pickle
import struct
import tarfile

import numpy as np
import pytest

import mxtpu


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


def _items(ds, n=None):
    """[(image as numpy, label)] of a dataset's first ``n`` items."""
    out = []
    for i in range(len(ds) if n is None else n):
        img, label = ds[i]
        out.append((img.asnumpy() if hasattr(img, "asnumpy") else
                    np.asarray(img), label))
    return out


def _same(got, want):
    assert len(got) == len(want)
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == wi.dtype and gi.shape == wi.shape
        if np.issubdtype(wi.dtype, np.floating):  # a transform's float32
            np.testing.assert_allclose(gi, wi, rtol=1e-6)
        else:
            np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(np.asarray(gl), np.asarray(wl))
        assert np.asarray(gl).dtype == np.asarray(wl).dtype


def _write_idx(root, base, n, seed, compress):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (n, 28, 28), dtype=np.uint8)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    opener = gzip.open if compress else open
    ext = ".gz" if compress else ""
    with opener(os.path.join(root, "%s-images-idx3-ubyte%s" % (base, ext)),
                "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
    with opener(os.path.join(root, "%s-labels-idx1-ubyte%s" % (base, ext)),
                "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())


@pytest.mark.parametrize("cls", ["MNIST", "FashionMNIST"])
def test_mnist_from_idx_files(mt, tmp_path, cls):
    root = str(tmp_path)
    _write_idx(root, "train", 7, seed=1, compress=False)
    _write_idx(root, "t10k", 5, seed=2, compress=True)
    for train in (True, False):
        want = getattr(mxtpu.gluon.data.vision, cls)(root, train=train)
        with mt.cpu():
            got = getattr(mt.gluon.data.vision, cls)(root, train=train)
            assert len(got) == len(want) == (7 if train else 5)
            _same(_items(got), _items(want))

    def transform(img, label):
        return img.astype("float32") / 255.0, label + 1

    want = mxtpu.gluon.data.vision.MNIST(root, transform=transform)
    with mt.cpu():
        got = mt.gluon.data.vision.MNIST(root, transform=transform)
        _same(_items(got, 3), _items(want, 3))
    empty = str(tmp_path / "empty")
    for pkg in (mxtpu, mt):
        with pytest.raises(pkg.MXNetError, match="not found"):
            getattr(pkg.gluon.data.vision, cls)(empty)


def _write_cifar(base, seed):
    os.makedirs(base)
    rng = np.random.RandomState(seed)
    for name, n in [("data_batch_%d" % i, 3) for i in range(1, 6)] + \
            [("test_batch", 4)]:
        batch = {"data": rng.randint(0, 256, (n, 3072), dtype=np.uint8),
                 "labels": [int(v) for v in rng.randint(0, 10, n)]}
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump(batch, f)


def test_cifar10_from_batches_and_from_the_tarball(mt, tmp_path):
    plain = tmp_path / "plain"
    _write_cifar(str(plain / "cifar-10-batches-py"), seed=3)
    tarred = tmp_path / "tarred"
    tarred.mkdir()
    with tarfile.open(str(tarred / "cifar-10-python.tar.gz"), "w:gz") as t:
        t.add(str(plain / "cifar-10-batches-py"), "cifar-10-batches-py")
    for root in (str(plain), str(tarred)):
        for train in (True, False):
            want = mxtpu.gluon.data.vision.CIFAR10(root, train=train)
            with mt.cpu():
                got = mt.gluon.data.vision.CIFAR10(root, train=train)
                assert len(got) == len(want) == (15 if train else 4)
                _same(_items(got), _items(want))
    for pkg in (mxtpu, mt):
        with pytest.raises(pkg.MXNetError, match="CIFAR10"):
            pkg.gluon.data.vision.CIFAR10(str(tmp_path / "none"))


def test_record_datasets_read_a_rec(mt, tmp_path):
    path = mt.test_utils.make_rec(str(tmp_path / "d.rec"), 6, edge=24,
                                  seed=4, num_classes=4)
    raw_w = mxtpu.gluon.data.RecordFileDataset(path)
    raw_g = mt.gluon.data.RecordFileDataset(path)
    assert len(raw_g) == len(raw_w) == 6
    assert [raw_g[i] for i in range(6)] == [raw_w[i] for i in range(6)]
    for flag in (1, 0):
        want = mxtpu.gluon.data.vision.ImageRecordDataset(path, flag=flag)
        with mt.cpu():
            got = mt.gluon.data.vision.ImageRecordDataset(path, flag=flag)
            assert len(got) == 6
            _same(_items(got), _items(want))

    def transform(img, label):
        return img[2:10, 4:20], label * 2

    want = mxtpu.gluon.data.vision.ImageRecordDataset(path,
                                                      transform=transform)
    with mt.cpu():
        got = mt.gluon.data.vision.ImageRecordDataset(path,
                                                      transform=transform)
        _same(_items(got), _items(want))


def test_image_folder_dataset(mt, tmp_path):
    import cv2
    rng = np.random.RandomState(5)
    layout = {"cat": ["a.png", "b.jpg", "notes.txt"], "dog": ["c.PNG"],
              "empty": []}
    for folder, names in layout.items():
        os.makedirs(str(tmp_path / folder))
        for name in names:
            p = str(tmp_path / folder / name)
            if name.endswith(".txt"):
                open(p, "w").write("not an image")
            else:
                cv2.imwrite(p, rng.randint(0, 256, (9, 13, 3),
                                           dtype=np.uint8))
    open(str(tmp_path / "stray.png"), "wb").write(b"")
    for flag in (1, 0):
        want = mxtpu.gluon.data.vision.ImageFolderDataset(str(tmp_path),
                                                          flag=flag)
        with mt.cpu():
            got = mt.gluon.data.vision.ImageFolderDataset(str(tmp_path),
                                                          flag=flag)
            assert got.synsets == want.synsets == ["cat", "dog", "empty"]
            assert got.items == want.items and len(got) == 3
            _same(_items(got), _items(want))
