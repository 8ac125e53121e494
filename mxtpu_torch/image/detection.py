"""Detection image pipeline: box-aware augmenters and ImageDetIter.

Counterpart of ``mxtpu/image/detection.py``. Parity:
python/mxnet/image/detection.py (DetBorrowAug, DetRandomSelectAug,
DetHorizontalFlipAug, DetRandomCropAug, DetRandomPadAug,
CreateDetAugmenter, ImageDetIter) and the native detection augmenter chain
src/io/image_det_aug_default.cc.

Label convention (same as the reference's .lst/.rec detection format):
per-image label = [header_width, object_width, extra..., obj0, obj1, ...]
where each object is [id, xmin, ymin, xmax, ymax, extra...] with
coordinates normalized to [0, 1]. The iterator reshapes that into a padded
(max_objects, object_width) matrix per image, padding with -1 rows.

The random draws come from Python's ``random`` module, as in mxtpu (or
the generator ``image.drawing_from`` put in on this thread); batches are
cpu() NDArrays.
"""
from __future__ import annotations

import json

import numpy as _np

from ..base import MXNetError
from .. import io as _io
from . import image as _img

__all__ = ["DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
           "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
           "CreateDetAugmenter", "ImageDetIter",
           "CreateMultiRandCropAugmenter"]


class DetAugmenter:
    """Base detection augmenter: __call__(src_hwc, label) -> (src, label)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__, self._kwargs])

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Apply an image-only augmenter, passing the label through."""

    def __init__(self, augmenter):
        super().__init__(augmenter=augmenter.__class__.__name__)
        self.augmenter = augmenter

    def __call__(self, src, label):
        return _img._as_np(self.augmenter(src)[0]), label


class DetRandomSelectAug(DetAugmenter):
    """Randomly pick one of aug_list (or none) per sample."""

    def __init__(self, aug_list, skip_prob=0.0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = aug_list
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if _img._streams.py.random() < self.skip_prob or not self.aug_list:
            return src, label
        return _img._streams.py.choice(self.aug_list)(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if _img._streams.py.random() < self.p:
            src = _img._as_np(src)[:, ::-1].copy()
            label = label.copy()
            valid = label[:, 0] >= 0
            xmin = 1.0 - label[valid, 3]
            xmax = 1.0 - label[valid, 1]
            label[valid, 1] = xmin
            label[valid, 3] = xmax
        return src, label


class DetRandomCropAug(DetAugmenter):
    """Random crop keeping enough object coverage (parity detection.py
    DetRandomCropAug; constraints mirror SSD data augmentation)."""

    def __init__(self, min_object_covered=0.1, aspect_ratio_range=(0.75,
                 1.33), area_range=(0.05, 1.0), max_attempts=50):
        super().__init__(min_object_covered=min_object_covered)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts

    def __call__(self, src, label):
        src = _img._as_np(src)
        h, w = src.shape[:2]
        for _ in range(self.max_attempts):
            area = _img._streams.py.uniform(*self.area_range) * h * w
            ratio = _img._streams.py.uniform(*self.aspect_ratio_range)
            cw = int(round((area * ratio) ** 0.5))
            ch = int(round((area / ratio) ** 0.5))
            if cw > w or ch > h or cw <= 0 or ch <= 0:
                continue
            x0 = _img._streams.py.randint(0, w - cw)
            y0 = _img._streams.py.randint(0, h - ch)
            new_label = self._update_labels(label, (x0 / w, y0 / h,
                                                    (x0 + cw) / w,
                                                    (y0 + ch) / h))
            if new_label is not None:
                return src[y0:y0 + ch, x0:x0 + cw], new_label
        return src, label

    def _update_labels(self, label, crop):
        cx0, cy0, cx1, cy1 = crop
        cw, chh = cx1 - cx0, cy1 - cy0
        out = label.copy()
        valid_rows = []
        for i in range(label.shape[0]):
            if label[i, 0] < 0:
                continue
            x0, y0, x1, y1 = label[i, 1:5]
            # intersection with crop
            ix0, iy0 = max(x0, cx0), max(y0, cy0)
            ix1, iy1 = min(x1, cx1), min(y1, cy1)
            inter = max(ix1 - ix0, 0) * max(iy1 - iy0, 0)
            box_area = max(x1 - x0, 0) * max(y1 - y0, 0)
            if box_area <= 0 or inter / box_area < self.min_object_covered:
                continue
            out[i, 1] = (ix0 - cx0) / cw
            out[i, 2] = (iy0 - cy0) / chh
            out[i, 3] = (ix1 - cx0) / cw
            out[i, 4] = (iy1 - cy0) / chh
            valid_rows.append(out[i].copy())
        if not valid_rows:
            return None
        res = _np.full_like(label, -1.0)
        for i, row in enumerate(valid_rows):
            res[i] = row
        return res


class DetRandomPadAug(DetAugmenter):
    """Randomly expand the canvas and place the image inside (zoom-out)."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=50,
                 pad_val=(127.5, 127.5, 127.5)):
        super().__init__(area_range=area_range)
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val

    def __call__(self, src, label):
        src = _img._as_np(src)
        h, w, c = src.shape
        for _ in range(self.max_attempts):
            scale = _img._streams.py.uniform(*self.area_range)
            ratio = _img._streams.py.uniform(*self.aspect_ratio_range)
            nw = int(round(w * (scale * ratio) ** 0.5))
            nh = int(round(h * (scale / ratio) ** 0.5))
            if nw < w or nh < h:
                continue
            x0 = _img._streams.py.randint(0, nw - w)
            y0 = _img._streams.py.randint(0, nh - h)
            canvas = _np.full((nh, nw, c),
                              _np.asarray(self.pad_val)[:c],
                              dtype=src.dtype)
            canvas[y0:y0 + h, x0:x0 + w] = src
            out = label.copy()
            valid = out[:, 0] >= 0
            out[valid, 1] = (out[valid, 1] * w + x0) / nw
            out[valid, 2] = (out[valid, 2] * h + y0) / nh
            out[valid, 3] = (out[valid, 3] * w + x0) / nw
            out[valid, 4] = (out[valid, 4] * h + y0) / nh
            return canvas, out
        return src, label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, pca_noise=0,
                       hue=0, inter_method=2, min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), max_attempts=50,
                       pad_val=(127, 127, 127)):
    """Standard detection chain (parity detection.py CreateDetAugmenter)."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(_img.ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered, aspect_ratio_range,
                                (area_range[0], min(area_range[1], 1.0)),
                                max_attempts)
        auglist.append(DetRandomSelectAug([crop], 1 - rand_crop))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (max(area_range[0], 1.0), area_range[1]),
                              max_attempts, pad_val)
        auglist.append(DetRandomSelectAug([pad], 1 - rand_pad))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    # force to final size after geometric augs
    auglist.append(DetBorrowAug(_img.ForceResizeAug(
        (data_shape[2], data_shape[1]), inter_method)))
    auglist.append(DetBorrowAug(_img.CastAug()))
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(
            _img.ColorJitterAug(brightness, contrast, saturation)))
    if pca_noise > 0:
        auglist.append(DetBorrowAug(_img.LightingAug(
            pca_noise, _img._PCA_EIGVAL, _img._PCA_EIGVEC)))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(DetBorrowAug(_img.ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(_img.ImageIter):
    """Detection iterator (parity detection.py ImageDetIter)."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root=None, path_imgidx=None,
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, data_name="data", label_name="label",
                 **kwargs):
        if aug_list is None:
            aug_list = CreateDetAugmenter(data_shape, **kwargs)
        # strip det-aug kwargs before ImageIter sees them
        super().__init__(batch_size=batch_size, data_shape=data_shape,
                         path_imgrec=path_imgrec, path_imglist=path_imglist,
                         path_root=path_root, path_imgidx=path_imgidx,
                         shuffle=shuffle, part_index=part_index,
                         num_parts=num_parts, aug_list=[], imglist=imglist,
                         data_name=data_name, label_name=label_name)
        self.det_auglist = aug_list
        first = self._peek_label()
        self.max_objects, self.object_width = first
        self.provide_label = [_io.DataDesc(
            label_name, (batch_size, self.max_objects, self.object_width))]

    def _parse_label(self, raw):
        """Flat label -> (n_obj, object_width) normalized matrix."""
        raw = _np.asarray(raw, _np.float32).reshape(-1)
        if raw.size < 2:
            raise MXNetError("ImageDetIter: label too short")
        header_width = int(raw[0])
        obj_width = int(raw[1])
        assert obj_width >= 5, "object width must be >= 5"
        body = raw[header_width:]
        n = body.size // obj_width
        return body[:n * obj_width].reshape(n, obj_width)

    def _peek_label(self):
        self.reset()
        label, _ = self.next_sample()
        mat = self._parse_label(label)
        self.reset()
        # generous padding: some images have more objects than the first
        return max(mat.shape[0] * 2, 16), mat.shape[1]

    def reshape(self, data_shape=None, label_shape=None):
        if data_shape is not None:
            self.data_shape = tuple(data_shape)[-3:] \
                if len(data_shape) == 4 else tuple(data_shape)
            self.provide_data = [_io.DataDesc(
                self.provide_data[0].name,
                (self.batch_size,) + tuple(self.data_shape))]
        if label_shape is not None:
            self.max_objects = label_shape[-2]
            self.provide_label = [_io.DataDesc(
                self.provide_label[0].name,
                (self.batch_size, self.max_objects, self.object_width))]

    def next(self):
        batch_size = self.batch_size
        c, h, w = self.data_shape
        batch_data = _np.zeros((batch_size, h, w, c), dtype=_np.float32)
        batch_label = _np.full(
            (batch_size, self.max_objects, self.object_width), -1.0,
            dtype=_np.float32)
        i = 0
        try:
            while i < batch_size:
                raw_label, img = self.next_sample()
                arr = _img._as_np(img)
                mat = self._parse_label(raw_label)
                pad_mat = _np.full((self.max_objects, self.object_width),
                                   -1.0, _np.float32)
                n = min(mat.shape[0], self.max_objects)
                pad_mat[:n] = mat[:n]
                for aug in self.det_auglist:
                    arr, pad_mat = aug(arr, pad_mat)
                    arr = _img._as_np(arr)
                if arr.shape[:2] != (h, w):
                    raise MXNetError(
                        "ImageDetIter: augmented image %s != data_shape %s"
                        % (arr.shape, (h, w)))
                batch_data[i] = arr.reshape(h, w, c)
                batch_label[i] = pad_mat
                i += 1
        except StopIteration:
            if i == 0:
                raise
        pad = batch_size - i
        return _io.DataBatch(data=[_img._nd(batch_data.transpose(0, 3, 1,
                                                                  2))],
                             label=[_img._nd(batch_label)], pad=pad,
                             index=None)


def CreateMultiRandCropAugmenter(min_object_covered=0.1,
                                 aspect_ratio_range=(0.75, 1.33),
                                 area_range=(0.05, 1.0),
                                 min_eject_coverage=0.3, max_attempts=50,
                                 skip_prob=0):
    """Several DetRandomCropAug variants, one per entry when the numeric
    arguments are lists (parity detection.py:417 — the SSD multi-crop
    recipe builds one augmenter per coverage setting)."""
    del min_eject_coverage  # DetRandomCropAug folds ejection into its
    # coverage retry loop; kept in the signature for call parity.
    # Any scalar argument broadcasts to the longest list.
    lists = {}
    n = 1
    for name, val in [("min_object_covered", min_object_covered),
                      ("aspect_ratio_range", aspect_ratio_range),
                      ("area_range", area_range),
                      ("max_attempts", max_attempts)]:
        if isinstance(val, list):
            n = max(n, len(val))
        lists[name] = val
    augs = []
    for i in range(n):
        def pick(v):
            return v[i % len(v)] if isinstance(v, list) else v
        augs.append(DetRandomCropAug(
            min_object_covered=pick(lists["min_object_covered"]),
            aspect_ratio_range=pick(lists["aspect_ratio_range"]),
            area_range=pick(lists["area_range"]),
            max_attempts=pick(lists["max_attempts"])))
    del skip_prob
    return DetRandomSelectAug(augs, skip_prob=0) if len(augs) > 1 else augs[0]
