"""The port's image module (``mxtpu_torch/image``) against mxtpu's, bit
for bit: decode and resize over cv2, the crops and ``color_normalize``,
every augmenter and ``CreateAugmenter``'s chain, the detection
augmenters and ``CreateDetAugmenter``, ``ImageIter`` and
``ImageDetIter`` over a ``.rec`` and an image list, and ``nd.imread``/
``nd.imresize`` (twin of tests/test_image.py::test_nd_cv_ops). Random
augmenters draw from Python's ``random`` (and numpy's for
``LightingAug``), so each package's call is made after the same seeding
of both."""
import random

import numpy as np
import pytest

import mxtpu as mx
from mxtpu import image as mx_img
from mxtpu.image import detection as mx_det

cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _same(a, b):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _seeded(fn, seed):
    random.seed(seed)
    np.random.seed(seed)
    return fn()


def _image(seed=0, shape=(30, 26, 3)):
    return np.random.RandomState(seed).randint(0, 255, shape,
                                               dtype=np.uint8)


@pytest.mark.parametrize("ext", [".jpg", ".png"])
@pytest.mark.parametrize("flag,to_rgb", [(1, True), (1, False), (0, True)])
def test_imdecode_is_mxtpus(mt, ext, flag, to_rgb):
    ok, buf = cv2.imencode(ext, _image())
    assert ok
    ours = mt.image.imdecode(buf.tobytes(), flag=flag, to_rgb=to_rgb)
    _same(ours, mx_img.imdecode(buf.tobytes(), flag=flag, to_rgb=to_rgb))
    assert ours.context == mt.cpu()
    out = mt.nd.zeros((1,), ctx=mt.cpu())
    assert mt.image.imdecode(buf.tobytes(), out=out) is out
    with pytest.raises(mt.MXNetError, match="cannot decode"):
        mt.image.imdecode(b"not an image")


@pytest.mark.parametrize("interp", [0, 1, 2, 3, 4])
def test_imresize_and_borders_are_mxtpus(mt, interp):
    img = _image(1)
    _same(mt.image.imresize(img, 17, 11, interp=interp),
          mx_img.imresize(img, 17, 11, interp=interp))
    _same(mt.image.imresize(img.astype(np.float32), 40, 33, interp),
          mx_img.imresize(img.astype(np.float32), 40, 33, interp))
    _same(mt.image.copyMakeBorder(img, 1, 2, 3, 4, interp % 3, 7.0),
          mx_img.copyMakeBorder(img, 1, 2, 3, 4, interp % 3, 7.0))
    _same(mt.image.resize_short(img, 13 + interp, interp),
          mx_img.resize_short(img, 13 + interp, interp))


def test_crops_and_normalize_are_mxtpus(mt):
    img = _image(2, (41, 29, 3))
    for size in [(20, 20), (29, 41), (50, 12), (7, 30)]:
        assert mt.image.scale_down((29, 41), size) == \
            mx_img.scale_down((29, 41), size)
        a, ra = mt.image.center_crop(img, size)
        b, rb = mx_img.center_crop(img, size)
        _same(a, b)
        assert ra == rb
        for seed in range(3):
            (a, ra), (b, rb) = (_seeded(lambda m=m: m.random_crop(img, size),
                                        seed)
                                for m in (mt.image, mx_img))
            _same(a, b)
            assert ra == rb
            (a, ra), (b, rb) = (_seeded(
                lambda m=m: m.random_size_crop(img, size, 0.3,
                                               (0.75, 1.33)), seed)
                for m in (mt.image, mx_img))
            _same(a, b)
            assert ra == rb
    _same(mt.image.fixed_crop(img, 3, 4, 10, 12, (8, 8)),
          mx_img.fixed_crop(img, 3, 4, 10, 12, (8, 8)))
    _same(mt.image.fixed_crop(img, 3, 4, 10, 12),
          mx_img.fixed_crop(img, 3, 4, 10, 12))
    mean, std = np.array([120.0, 110, 100]), np.array([50.0, 60, 70])
    _same(mt.image.color_normalize(img, mean, std),
          mx_img.color_normalize(img, mean, std))
    _same(mt.image.color_normalize(img, mean), mx_img.color_normalize(img,
                                                                      mean))


_EIG = (np.array([55.46, 4.794, 1.148]),
        np.array([[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
                  [-0.5836, -0.6948, 0.4203]]))

AUGMENTERS = {
    "ResizeAug": lambda m: m.ResizeAug(16),
    "ForceResizeAug": lambda m: m.ForceResizeAug((20, 14)),
    "RandomCropAug": lambda m: m.RandomCropAug((16, 12)),
    "RandomSizedCropAug": lambda m: m.RandomSizedCropAug(
        (16, 16), 0.3, (0.75, 1.33)),
    "CenterCropAug": lambda m: m.CenterCropAug((16, 16)),
    "RandomOrderAug": lambda m: m.RandomOrderAug(
        [m.BrightnessJitterAug(0.3), m.ContrastJitterAug(0.3),
         m.HorizontalFlipAug(0.5)]),
    "BrightnessJitterAug": lambda m: m.BrightnessJitterAug(0.3),
    "ContrastJitterAug": lambda m: m.ContrastJitterAug(0.3),
    "SaturationJitterAug": lambda m: m.SaturationJitterAug(0.3),
    "HueJitterAug": lambda m: m.HueJitterAug(0.2),
    "RandomGrayAug": lambda m: m.RandomGrayAug(0.5),
    "ColorJitterAug": lambda m: m.ColorJitterAug(0.2, 0.2, 0.2),
    "LightingAug": lambda m: m.LightingAug(0.1, *_EIG),
    "ColorNormalizeAug": lambda m: m.ColorNormalizeAug(
        np.array([120.0, 110, 100]), np.array([50.0, 60, 70])),
    "HorizontalFlipAug": lambda m: m.HorizontalFlipAug(0.5),
    "CastAug": lambda m: m.CastAug(),
}


@pytest.mark.parametrize("name", sorted(AUGMENTERS))
def test_every_augmenter_is_mxtpus(mt, name):
    from mxtpu_torch.image import image as pt_img
    ours, theirs = AUGMENTERS[name](pt_img), AUGMENTERS[name](
        mx_img.image)
    assert ours.dumps() == theirs.dumps()
    for seed in range(4):
        for img in (_image(seed), _image(seed).astype(np.float32)):
            a = _seeded(lambda: ours(img), seed)
            b = _seeded(lambda: theirs(img), seed)
            assert len(a) == len(b)
            for x, y in zip(a, b):
                _same(x, y)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(resize=28, rand_crop=True, rand_mirror=True),
    dict(resize=28, rand_crop=True, rand_resize=True, rand_mirror=True,
         mean=True, std=True, brightness=0.1, contrast=0.1,
         saturation=0.1, pca_noise=0.05),
    dict(mean=np.array([1.0, 2.0, 3.0]), std=np.array([2.0])),
], ids=["plain", "crop_mirror", "everything", "arrays"])
def test_create_augmenter_chain_is_mxtpus(mt, kw):
    ours = mt.image.CreateAugmenter((3, 24, 24), **kw)
    theirs = mx_img.CreateAugmenter((3, 24, 24), **kw)
    assert [a.dumps() for a in ours] == [a.dumps() for a in theirs]
    img = _image(5, (40, 36, 3))
    for seed in range(3):
        outs = []
        for chain in (ours, theirs):
            def run(chain=chain):
                x = img
                for aug in chain:
                    x = aug(x)[0]
                return x
            outs.append(_seeded(run, seed))
        _same(*outs)
        assert outs[0].shape == (24, 24, 3)


def _boxes(n=3, width=5, seed=0):
    rng = np.random.RandomState(seed)
    lab = np.full((n + 2, width), -1.0, np.float32)
    for i in range(n):
        x0, y0 = rng.uniform(0.0, 0.5, 2)
        lab[i, :5] = [i % 3, x0, y0, x0 + rng.uniform(0.1, 0.5),
                      y0 + rng.uniform(0.1, 0.5)]
    return lab


DET_AUGMENTERS = {
    "DetBorrowAug": lambda m, i: m.DetBorrowAug(i.BrightnessJitterAug(0.2)),
    "DetRandomSelectAug": lambda m, i: m.DetRandomSelectAug(
        [m.DetHorizontalFlipAug(1.0), m.DetRandomCropAug()], 0.3),
    "DetHorizontalFlipAug": lambda m, i: m.DetHorizontalFlipAug(0.5),
    "DetRandomCropAug": lambda m, i: m.DetRandomCropAug(0.3),
    "DetRandomPadAug": lambda m, i: m.DetRandomPadAug(),
    "CreateMultiRandCropAugmenter": lambda m, i:
        m.CreateMultiRandCropAugmenter(min_object_covered=[0.1, 0.5],
                                       area_range=[(0.1, 1.0), (0.3, 1.0)]),
}


@pytest.mark.parametrize("name", sorted(DET_AUGMENTERS))
def test_every_det_augmenter_is_mxtpus(mt, name):
    from mxtpu_torch.image import detection as pt_det
    ours = DET_AUGMENTERS[name](pt_det, mt.image)
    theirs = DET_AUGMENTERS[name](mx_det, mx_img)
    for seed in range(6):
        img, lab = _image(seed, (32, 40, 3)), _boxes(seed=seed)
        (a, la), (b, lb) = (_seeded(lambda f=f: f(img, lab.copy()), seed)
                            for f in (ours, theirs))
        _same(a, b)
        np.testing.assert_array_equal(la, lb)


@pytest.mark.parametrize("kw", [
    dict(rand_mirror=True, mean=np.array([123.0, 117, 104])),
    dict(resize=48, rand_crop=0.5, rand_pad=0.5, rand_mirror=True,
         mean=True, std=True, brightness=0.1, contrast=0.1, saturation=0.1,
         pca_noise=0.05),
], ids=["ssd_train", "everything"])
def test_create_det_augmenter_chain_is_mxtpus(mt, kw):
    ours = mt.image.CreateDetAugmenter((3, 30, 30), **kw)
    theirs = mx_img.CreateDetAugmenter((3, 30, 30), **kw)
    assert [a.dumps() for a in ours] == [a.dumps() for a in theirs]
    for seed in range(4):
        outs = []
        for chain in (ours, theirs):
            def run(chain=chain):
                x, lab = _image(seed, (36, 44, 3)), _boxes(seed=seed)
                for aug in chain:
                    x, lab = aug(x, lab)
                return _np(x), lab
            outs.append(_seeded(run, seed))
        _same(outs[0][0], outs[1][0])
        np.testing.assert_array_equal(outs[0][1], outs[1][1])
        assert outs[0][0].shape == (30, 30, 3)


def _pack(tmp_path, rio, n=10, size=36, det=False, seed=0, name="d"):
    """A .rec/.idx of n PNG-lossless random images (labels scalar, or
    [2, 5, box] for det); returns the .rec path."""
    rng = np.random.RandomState(seed)
    rec_path = str(tmp_path / (name + ".rec"))
    rec = rio.MXIndexedRecordIO(str(tmp_path / (name + ".idx")), rec_path,
                                "w")
    for i in range(n):
        arr = rng.randint(0, 255, (size, size + 4, 3), dtype=np.uint8)
        ok, buf = cv2.imencode(".jpg", arr)
        label = [2, 5, float(i % 3)] + list(_boxes(1, seed=i)[0, 1:5]) \
            if det else float(i % 4)
        rec.write_idx(i, rio.pack(rio.IRHeader(0, label, i, 0),
                                  buf.tobytes()))
    rec.close()
    return rec_path


def _batches(it, epochs=2):
    out = []
    for epoch in range(epochs):
        if epoch:
            it.reset()
        for b in it:
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    return out


def _same_batches(a, b):
    assert len(a) == len(b)
    for (xa, la, pa), (xb, lb, pb) in zip(a, b):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(la, lb)
        assert pa == pb


@pytest.mark.parametrize("shuffle", [False, True])
def test_image_iter_over_a_rec_is_mxtpus(mt, tmp_path, shuffle):
    rec = _pack(tmp_path, mt.recordio)
    kw = dict(batch_size=4, data_shape=(3, 24, 24), path_imgrec=rec,
              shuffle=shuffle, rand_crop=True, rand_mirror=True, mean=True)
    ours = _seeded(lambda: _batches(mt.image.ImageIter(**kw)), 3)
    theirs = _seeded(lambda: _batches(mx_img.ImageIter(**kw)), 3)
    _same_batches(ours, theirs)
    assert [p for _, _, p in ours] == [0, 0, 2] * 2


def test_image_iter_over_a_list_is_mxtpus(mt, tmp_path):
    rng = np.random.RandomState(4)
    lines = []
    for i in range(5):
        cv2.imwrite(str(tmp_path / ("%d.png" % i)),
                    rng.randint(0, 255, (20, 30, 3), dtype=np.uint8))
        lines.append("%d\t%d\t%d\t%d.png" % (i, i, i + 1, i))
    (tmp_path / "x.lst").write_text("\n".join(lines) + "\n")
    for kw in (dict(path_imglist=str(tmp_path / "x.lst")),
               dict(imglist=[([i, i + 1], "%d.png" % i) for i in range(5)])):
        kw.update(batch_size=2, data_shape=(3, 16, 16), label_width=2,
                  path_root=str(tmp_path), rand_crop=True)
        _same_batches(_seeded(lambda: _batches(mt.image.ImageIter(**kw)), 1),
                      _seeded(lambda: _batches(mx_img.ImageIter(**kw)), 1))
    gray = dict(batch_size=2, data_shape=(1, 16, 16), num_parts=2,
                part_index=1, path_imglist=str(tmp_path / "x.lst"),
                path_root=str(tmp_path))
    _same_batches(_batches(mt.image.ImageIter(**gray)),
                  _batches(mx_img.ImageIter(**gray)))
    with pytest.raises(mt.MXNetError, match="needs"):
        mt.image.ImageIter(2, (3, 8, 8))


def test_image_det_iter_is_mxtpus(mt, tmp_path):
    rec = _pack(tmp_path, mt.recordio, n=9, det=True)
    kw = dict(batch_size=4, data_shape=(3, 28, 28), path_imgrec=rec,
              shuffle=True, rand_crop=0.5, rand_pad=0.5, rand_mirror=True,
              mean=True)
    ours = _seeded(lambda: mt.image.ImageDetIter(**kw), 7)
    theirs = _seeded(lambda: mx_img.ImageDetIter(**kw), 7)
    assert ours.provide_label[0].shape == theirs.provide_label[0].shape \
        == (4, 16, 5)
    _same_batches(_seeded(lambda: _batches(ours), 8),
                  _seeded(lambda: _batches(theirs), 8))
    ours.reshape(label_shape=(4, 6, 5))
    assert ours.provide_label[0].shape == (4, 6, 5)


def test_nd_imread_and_imresize(mt, tmp_path):
    """Twin of tests/test_image.py::test_nd_cv_ops."""
    arr = (np.random.RandomState(0).rand(8, 8, 3) * 255).astype("uint8")
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, arr)
    out = mt.nd.imread(path)
    assert out.shape == (8, 8, 3)
    _same(out, mx.nd.imread(path))
    small = mt.nd.imresize(out, 4, 4)
    assert small.shape == (4, 4, 3)
    _same(small, mx.nd.imresize(mx.nd.imread(path), 4, 4))
    _same(mt.nd.imdecode(open(path, "rb").read()), arr[:, :, ::-1])
