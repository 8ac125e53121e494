"""Vision datasets: a copy of mxtpu/gluon/data/vision.py (parity:
python/mxnet/gluon/data/vision.py:59-235): MNIST, FashionMNIST, CIFAR10,
ImageRecordDataset and ImageFolderDataset. They read local files under
their root; nothing is downloaded."""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile

import numpy as _np

from ... import ndarray as nd
from ...base import MXNetError
from . import dataset


class _DownloadedDataset(dataset.Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        if not os.path.isdir(self._root):
            os.makedirs(self._root, exist_ok=True)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from local ubyte files (parity vision.py:59)."""

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True,
                 transform=None):
        self._base = "train" if train else "t10k"
        super().__init__(root, train, transform)

    def _get_data(self):
        img = os.path.join(self._root, "%s-images-idx3-ubyte" % self._base)
        lbl = os.path.join(self._root, "%s-labels-idx1-ubyte" % self._base)
        for p in (img, lbl):
            if not (os.path.exists(p) or os.path.exists(p + ".gz")):
                raise MXNetError(
                    "MNIST file %s not found (no network access; place the "
                    "ubyte files under %s)" % (p, self._root))

        def read(path, image):
            opener = gzip.open if not os.path.exists(path) else open
            real = path if os.path.exists(path) else path + ".gz"
            with opener(real, "rb") as f:
                if image:
                    _, n, r, c = struct.unpack(">IIII", f.read(16))
                    return _np.frombuffer(f.read(), dtype=_np.uint8).reshape(
                        n, r, c, 1)
                _, n = struct.unpack(">II", f.read(8))
                return _np.frombuffer(f.read(), dtype=_np.uint8).astype(
                    _np.int32)

        self._data = nd.array(read(img, True), dtype="uint8")
        self._label = read(lbl, False)


class FashionMNIST(MNIST):
    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR10 from the local python-pickle batches (parity vision.py:155)."""

    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True,
                 transform=None):
        super().__init__(root, train, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            batch = pickle.load(fin, encoding="latin1")
        data = batch["data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return data, _np.asarray(batch["labels"], dtype=_np.int32)

    def _get_data(self):
        base = os.path.join(self._root, "cifar-10-batches-py")
        if not os.path.isdir(base):
            tar = os.path.join(self._root, "cifar-10-python.tar.gz")
            if os.path.exists(tar):
                with tarfile.open(tar) as t:
                    t.extractall(self._root)
            else:
                raise MXNetError("CIFAR10 data not found under %s" % self._root)
        if self._train:
            files = ["data_batch_%d" % i for i in range(1, 6)]
        else:
            files = ["test_batch"]
        data, label = zip(*[self._read_batch(os.path.join(base, f))
                            for f in files])
        self._data = nd.array(_np.concatenate(data), dtype="uint8")
        self._label = _np.concatenate(label)


class ImageRecordDataset(dataset.RecordFileDataset):
    """Images packed in recordio (parity vision.py ImageRecordDataset)."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from ... import recordio
        record = super().__getitem__(idx)
        header, img = recordio.unpack_img(record, self._flag)
        img = nd.array(img, dtype="uint8")
        if self._transform is not None:
            return self._transform(img, header.label)
        return img, header.label


class ImageFolderDataset(dataset.Dataset):
    """Images laid out as root/<class-name>/<img> (parity gluon/data/
    vision.py:235): folder names become integer labels via ``synsets``."""

    def __init__(self, root, flag=1, transform=None):
        import os

        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = (".jpg", ".jpeg", ".png")
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for fname in sorted(os.listdir(path)):
                if fname.lower().endswith(self._exts):
                    self.items.append((os.path.join(path, fname), label))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        from ...image import image as _img

        path, label = self.items[idx]
        img = _img.imread(path, flag=self._flag)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label
