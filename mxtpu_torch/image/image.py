"""Image decode, transforms, augmenters and ImageIter.

Counterpart of ``mxtpu/image/image.py`` (parity: python/mxnet/image/
image.py: imdecode, resize_short, fixed_crop, random_crop, center_crop,
color_normalize, the ``*Aug`` classes, CreateAugmenter :719, ImageIter
:975), over cv2 and numpy on the host. Images are HWC until the batch is
assembled in NCHW; every NDArray made here lives on ``cpu()``, where the
port's iterators assemble batches (``Module`` copies them to its
device).

The random draws come from Python's ``random`` module, and numpy's global
RNG for ``LightingAug``, as in mxtpu and the reference: seeding both the
same way before a call gives mxtpu's result bit for bit. A record
iterator's producer thread draws from generators of its own instead
(``drawing_from``), so it never moves the caller's.
"""
from __future__ import annotations

import contextlib
import json
import os
import random as _pyrandom
import threading

import numpy as _np
import torch

from ..base import MXNetError
from ..context import cpu
from .. import io as _io
from .. import recordio as _rio
from ..ndarray import NDArray

__all__ = [
    "imdecode", "imread", "imresize", "copyMakeBorder", "scale_down",
    "resize_short", "fixed_crop", "random_crop", "center_crop",
    "color_normalize", "random_size_crop", "Augmenter", "ResizeAug",
    "ForceResizeAug", "RandomCropAug", "RandomSizedCropAug",
    "CenterCropAug", "RandomOrderAug", "BrightnessJitterAug",
    "ContrastJitterAug", "SaturationJitterAug", "HueJitterAug",
    "RandomGrayAug", "ColorJitterAug", "LightingAug", "ColorNormalizeAug",
    "HorizontalFlipAug", "CastAug", "CreateAugmenter", "ImageIter",
    "imdecode_np", "imresize_np",
]


class _Streams(threading.local):
    """The generators this thread's draws come from: Python's and numpy's
    global ones unless ``drawing_from`` put others in."""
    py = _pyrandom
    np = _np.random


_streams = _Streams()


@contextlib.contextmanager
def drawing_from(py, np_rs):
    """Within the block, this thread's augmenters and ImageIter's shuffle
    draw from ``py`` (a ``random.Random``) and ``np_rs`` (a numpy
    ``RandomState``); other threads keep theirs."""
    old = _streams.py, _streams.np
    _streams.py, _streams.np = py, np_rs
    try:
        yield
    finally:
        _streams.py, _streams.np = old


# numpy dtypes mxtpu's nd.array narrows when none is asked for (x64 off)
_NARROW = {_np.dtype("float64"): _np.dtype("float32"),
           _np.dtype("int64"): _np.dtype("int32")}


def _cv2():
    try:
        import cv2
    except ImportError as e:  # raise where an image op is called
        raise MXNetError("the image ops need cv2 (OpenCV)") from e
    return cv2


def _nd(arr, dtype=None):
    """A cpu() NDArray holding a copy of ``arr``: of ``dtype``, else of
    the array's own type, float64 and int64 narrowed as mxtpu does."""
    arr = _np.asarray(arr)
    dt = _np.dtype(dtype) if dtype is not None else \
        _NARROW.get(arr.dtype, arr.dtype)
    return NDArray(torch.from_numpy(_np.array(arr, dtype=dt, order="C")),
                   cpu())


def _as_np(img):
    """numpy of an image: of a cpu() NDArray a read-only view of its
    storage (the augmenters only read their input), else a copy."""
    if isinstance(img, NDArray):
        t = img._data.detach()
        if t.device.type != "cpu" or t.dtype == torch.bfloat16 or \
                t.layout != torch.strided:
            return img.asnumpy()
        view = t.numpy()
        view.flags.writeable = False
        return view
    return _np.asarray(img)


def imdecode_np(buf, flag=1, to_rgb=True):
    """Decode an encoded image straight to a numpy HWC uint8 array: the
    hot path of ImageRecordIter's decode pool."""
    cv2 = _cv2()
    img = cv2.imdecode(_np.frombuffer(bytes(buf), dtype=_np.uint8),
                       1 if flag else 0)
    if img is None:
        raise MXNetError("imdecode: cannot decode buffer")
    if flag and to_rgb:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if img.ndim == 2:
        img = img[:, :, None]
    return img


def imdecode(buf, flag=1, to_rgb=True, out=None):
    """Decode an encoded image to an HWC uint8 NDArray (parity op
    _cvimdecode); ``flag`` 1 colour, 0 grayscale."""
    arr = _nd(imdecode_np(buf, flag, to_rgb), dtype="uint8")
    if out is not None:
        out._data = arr._data
        return out
    return arr


def imread(filename, flag=1, to_rgb=True):
    """Read and decode an image file (parity op _cvimread)."""
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


def imresize_np(src, w, h, interp=1):
    """numpy to numpy resize to exactly (w, h)."""
    return _cv2().resize(src, (int(w), int(h)), interpolation=int(interp))


def imresize(src, w, h, interp=1):
    """Resize to exactly (w, h) (parity op _cvimresize)."""
    img = _as_np(src)
    out = imresize_np(img, w, h, interp)
    if out.ndim == 2:
        out = out[:, :, None]
    return _nd(out, dtype=img.dtype)


def copyMakeBorder(src, top, bot, left, right, border_type=0, value=0.0):
    """Pad an image (parity op _cvcopyMakeBorder)."""
    img = _as_np(src)
    out = _cv2().copyMakeBorder(img, top, bot, left, right, border_type,
                                value=value)
    if out.ndim == 2:
        out = out[:, :, None]
    return _nd(out, dtype=img.dtype)


def scale_down(src_size, size):
    """Scale (w, h) down to fit ``src_size``, keeping the aspect."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def resize_short(src, size, interp=2):
    """Resize so that the shorter edge is ``size``."""
    img = _as_np(src)
    h, w = img.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(img, new_w, new_h, interp=interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    img = _as_np(src)
    out = img[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        return imresize(out, size[0], size[1], interp=interp)
    return _nd(out, dtype=img.dtype)


def random_crop(src, size, interp=2):
    img = _as_np(src)
    h, w = img.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = _streams.py.randint(0, w - new_w)
    y0 = _streams.py.randint(0, h - new_h)
    out = fixed_crop(img, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    img = _as_np(src)
    h, w = img.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(img, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    img = _as_np(src).astype(_np.float32)
    mean = _as_np(mean) if mean is not None else None
    if mean is not None:
        img = img - mean
    if std is not None:
        img = img / _as_np(std)
    return _nd(img)


def random_size_crop(src, size, min_area, ratio, interp=2):
    """A crop of random area and aspect, resized to ``size``."""
    img = _as_np(src)
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = _streams.py.uniform(min_area, 1.0) * area
        log_ratio = (_np.log(ratio[0]), _np.log(ratio[1]))
        aspect = _np.exp(_streams.py.uniform(*log_ratio))
        new_w = int(round((target_area * aspect) ** 0.5))
        new_h = int(round((target_area / aspect) ** 0.5))
        if new_w <= w and new_h <= h:
            x0 = _streams.py.randint(0, w - new_w)
            y0 = _streams.py.randint(0, h - new_h)
            out = fixed_crop(img, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(img, size, interp)


class Augmenter:
    """Base augmenter: ``aug(src)`` returns a list of images."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__, self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return [resize_short(src, self.size, self.interp)]


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return [imresize(src, self.size[0], self.size[1], self.interp)]


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return [random_crop(src, self.size, self.interp)[0]]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, min_area, ratio, interp=2):
        super().__init__(size=size, min_area=min_area, ratio=ratio,
                         interp=interp)
        self.size = size
        self.min_area = min_area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return [random_size_crop(src, self.size, self.min_area, self.ratio,
                                 self.interp)[0]]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return [center_crop(src, self.size, self.interp)[0]]


class RandomOrderAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        srcs = [src]
        ts = list(self.ts)
        _streams.py.shuffle(ts)
        for t in ts:
            srcs = [out for s in srcs for out in t(s)]
        return srcs


_GRAY = _np.array([[[0.299, 0.587, 0.114]]], _np.float32)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + _streams.py.uniform(-self.brightness, self.brightness)
        return [_nd(_as_np(src).astype(_np.float32) * alpha)]


class ContrastJitterAug(Augmenter):
    _coef = _GRAY

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        img = _as_np(src).astype(_np.float32)
        alpha = 1.0 + _streams.py.uniform(-self.contrast, self.contrast)
        gray = (img * self._coef).sum() * (3.0 / img.size)
        return [_nd(img * alpha + gray * (1.0 - alpha))]


class SaturationJitterAug(Augmenter):
    _coef = _GRAY

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        img = _as_np(src).astype(_np.float32)
        alpha = 1.0 + _streams.py.uniform(-self.saturation, self.saturation)
        gray = (img * self._coef).sum(axis=2, keepdims=True)
        return [_nd(img * alpha + gray * (1.0 - alpha))]


class HueJitterAug(Augmenter):
    """A random hue rotation in YIQ space."""

    _u = _np.array([[0.299, 0.587, 0.114],
                    [0.596, -0.274, -0.321],
                    [0.211, -0.523, 0.311]], _np.float32)
    _v = _np.array([[1.0, 0.956, 0.621],
                    [1.0, -0.272, -0.647],
                    [1.0, -1.107, 1.705]], _np.float32)

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue

    def __call__(self, src):
        img = _as_np(src).astype(_np.float32)
        alpha = _streams.py.uniform(-self.hue, self.hue)
        a = _np.pi * alpha
        rot = _np.array([[1, 0, 0],
                         [0, _np.cos(a), -_np.sin(a)],
                         [0, _np.sin(a), _np.cos(a)]], _np.float32)
        t = self._v.T @ rot @ self._u.T
        return [_nd(img @ t.astype(_np.float32))]


class RandomGrayAug(Augmenter):
    """With probability ``p``, the image as 3-channel grayscale."""

    _coef = _GRAY

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _streams.py.random() < self.p:
            img = _as_np(src).astype(_np.float32)
            gray = (img * self._coef).sum(axis=2, keepdims=True)
            return [_nd(_np.broadcast_to(gray, img.shape))]
        return [src if isinstance(src, NDArray) else _nd(src)]


class ColorJitterAug(RandomOrderAug):
    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    """PCA lighting noise, drawn from numpy's RNG (``_streams.np``)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = _np.asarray(eigval, _np.float32)
        self.eigvec = _np.asarray(eigvec, _np.float32)

    def __call__(self, src):
        alpha = _streams.np.normal(0, self.alphastd, size=(3,))
        rgb = _np.dot(self.eigvec * alpha, self.eigval)
        return [_nd(_as_np(src).astype(_np.float32) + rgb)]


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__()
        self.mean = None if mean is None else _np.asarray(mean, _np.float32)
        self.std = None if std is None else _np.asarray(std, _np.float32)

    def __call__(self, src):
        return [color_normalize(src, self.mean, self.std)]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _streams.py.random() < self.p:
            return [_nd(_as_np(src)[:, ::-1])]
        return [_nd(_as_np(src))]


class CastAug(Augmenter):
    def __call__(self, src):
        return [_nd(_as_np(src).astype(_np.float32))]


_PCA_EIGVAL = _np.array([55.46, 4.794, 1.148])
_PCA_EIGVEC = _np.array([[-0.5675, 0.7192, 0.4009],
                         [-0.5808, -0.0045, -0.8140],
                         [-0.5836, -0.6948, 0.4203]])


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, pca_noise=0, inter_method=2):
    """The standard augmenter chain (parity image.py CreateAugmenter:719)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, 0.3,
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if pca_noise > 0:
        auglist.append(LightingAug(pca_noise, _PCA_EIGVAL, _PCA_EIGVEC))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    elif mean is not None:
        mean = _np.asarray(mean)
        assert mean.shape[0] in [1, 3]
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    elif std is not None:
        std = _np.asarray(std)
        assert std.shape[0] in [1, 3]
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter(_io.DataIter):
    """Image iterator over a ``.rec`` file or an image list (parity
    image.py ImageIter:975): ``path_imgrec`` (with its ``.idx`` when
    there is one), or ``path_imglist``/``imglist`` with ``path_root``;
    ``shuffle`` (Python's ``random``, at each reset), ``num_parts``/
    ``part_index`` and an augmenter chain. Batches come out NCHW on
    cpu(), the tail batch zero-filled with its ``pad``."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 path_imgidx=None, shuffle=False, part_index=0, num_parts=1,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        assert len(data_shape) == 3 and data_shape[0] in (1, 3)
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.seq = None
        self.imgrec = None
        self.imglist = None
        if path_imgrec is not None:
            guess = os.path.splitext(path_imgrec)[0] + ".idx"
            if path_imgidx is None and os.path.exists(guess):
                path_imgidx = guess
            if path_imgidx is not None:
                self.imgrec = _rio.MXIndexedRecordIO(path_imgidx,
                                                     path_imgrec, "r")
                self.seq = list(self.imgrec.keys)
            else:
                self.imgrec = _rio.MXRecordIO(path_imgrec, "r")
        elif path_imglist is not None:
            found, seq = {}, []
            with open(path_imglist) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    label = _np.array([float(x) for x in parts[1:-1]],
                                      dtype=_np.float32)
                    key = int(parts[0])
                    found[key] = (label, parts[-1])
                    seq.append(key)
            self.imglist = found
            self.seq = seq
        elif imglist is not None:
            found, seq = {}, []
            for i, (label, fname) in enumerate(imglist):
                label = _np.array(label, dtype=_np.float32).reshape(-1)
                found[i] = (label, fname)
                seq.append(i)
            self.imglist = found
            self.seq = seq
        else:
            raise MXNetError(
                "ImageIter needs path_imgrec, path_imglist, or imglist")
        self.path_root = path_root
        if self.seq is not None and num_parts > 1:
            part = len(self.seq) // num_parts
            self.seq = self.seq[part * part_index:part * (part_index + 1)]
        self.shuffle = shuffle
        self.auglist = CreateAugmenter(data_shape, **kwargs) \
            if aug_list is None else aug_list
        self.provide_data = [_io.DataDesc(data_name,
                                          (batch_size,) + self.data_shape)]
        if label_width > 1:
            self.provide_label = [_io.DataDesc(label_name,
                                               (batch_size, label_width))]
        else:
            self.provide_label = [_io.DataDesc(label_name, (batch_size,))]
        self.cur = 0
        self.reset()

    def reset(self):
        if self.shuffle and self.seq is not None:
            _streams.py.shuffle(self.seq)
        if self.imgrec is not None and self.seq is None:
            self.imgrec.reset()
        self.cur = 0

    def next_sample(self):
        """(label, decoded HWC image) of the next sample."""
        flag = 1 if self.data_shape[0] == 3 else 0  # grayscale for C=1
        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.imgrec is not None:
                header, img = _rio.unpack(self.imgrec.read_idx(idx))
                return header.label, imdecode(img, flag=flag)
            label, fname = self.imglist[idx]
            return label, imread(os.path.join(self.path_root or "", fname),
                                 flag=flag)
        s = self.imgrec.read()
        if s is None:
            raise StopIteration
        header, img = _rio.unpack(s)
        return header.label, imdecode(img, flag=flag)

    def next(self):
        batch_size = self.batch_size
        c, h, w = self.data_shape
        batch_data = _np.zeros((batch_size, h, w, c), dtype=_np.float32)
        batch_label = _np.zeros((batch_size, self.label_width),
                                dtype=_np.float32)
        i = 0
        try:
            while i < batch_size:
                label, img = self.next_sample()
                arr = _as_np(img)
                for aug in self.auglist:
                    arr = _as_np(aug(arr)[0])
                if arr.shape[:2] != (h, w):
                    raise MXNetError(
                        "ImageIter: augmented image %s != data_shape %s; add "
                        "a resize/crop augmenter" % (arr.shape, (h, w)))
                batch_data[i] = arr.reshape(h, w, c)
                batch_label[i] = _np.asarray(label, _np.float32).reshape(
                    -1)[:self.label_width]
                i += 1
        except StopIteration:
            if i == 0:
                raise
        return _io.DataBatch(
            data=[_nd(batch_data.transpose(0, 3, 1, 2))],
            label=[_nd(batch_label[:, 0] if self.label_width == 1
                       else batch_label)],
            pad=batch_size - i, index=None)
