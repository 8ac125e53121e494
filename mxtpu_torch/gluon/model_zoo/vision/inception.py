"""Inception V3: a copy of mxtpu/gluon/model_zoo/vision/inception.py
(parity: python/mxnet/gluon/model_zoo/vision/inception.py).

Input contract matches the reference: 299x299 images."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn


def _make_basic_conv(**kwargs):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(use_bias=False, **kwargs))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


def _make_branch(use_pool, *conv_settings):
    out = nn.HybridSequential(prefix="")
    if use_pool == "avg":
        out.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(nn.MaxPool2D(pool_size=3, strides=2))
    setting_names = ["channels", "kernel_size", "strides", "padding"]
    for setting in conv_settings:
        kwargs = {}
        for i, value in enumerate(setting):
            if value is not None:
                kwargs[setting_names[i]] = value
        out.add(_make_basic_conv(**kwargs))
    return out


class _Concurrent(HybridBlock):
    """Run child branches on the same input, concat along channels."""

    def __init__(self, branches, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.branches = nn.HybridSequential(prefix="")
            for b in branches:
                self.branches.add(b)

    def hybrid_forward(self, F, x):
        outs = [b(x) for b in self.branches._children]
        return F.concat(*outs, dim=1)


def _make_A(pool_features, prefix):
    return _Concurrent([
        _make_branch(None, (64, 1, None, None)),
        _make_branch(None, (48, 1, None, None), (64, 5, None, 2)),
        _make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                     (96, 3, None, 1)),
        _make_branch("avg", (pool_features, 1, None, None)),
    ], prefix=prefix)


def _make_B(prefix):
    return _Concurrent([
        _make_branch(None, (384, 3, 2, None)),
        _make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                     (96, 3, 2, None)),
        _make_branch("max"),
    ], prefix=prefix)


def _make_C(channels_7x7, prefix):
    return _Concurrent([
        _make_branch(None, (192, 1, None, None)),
        _make_branch(None, (channels_7x7, 1, None, None),
                     (channels_7x7, (1, 7), None, (0, 3)),
                     (192, (7, 1), None, (3, 0))),
        _make_branch(None, (channels_7x7, 1, None, None),
                     (channels_7x7, (7, 1), None, (3, 0)),
                     (channels_7x7, (1, 7), None, (0, 3)),
                     (channels_7x7, (7, 1), None, (3, 0)),
                     (192, (1, 7), None, (0, 3))),
        _make_branch("avg", (192, 1, None, None)),
    ], prefix=prefix)


def _make_D(prefix):
    return _Concurrent([
        _make_branch(None, (192, 1, None, None), (320, 3, 2, None)),
        _make_branch(None, (192, 1, None, None),
                     (192, (1, 7), None, (0, 3)),
                     (192, (7, 1), None, (3, 0)),
                     (192, 3, 2, None)),
        _make_branch("max"),
    ], prefix=prefix)


class _InceptionE(HybridBlock):
    """Block E: branches themselves fork into parallel 1x3/3x1 convs."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.b1 = _make_branch(None, (320, 1, None, None))
            self.b2_stem = _make_basic_conv(channels=384, kernel_size=1)
            self.b2_a = _make_basic_conv(channels=384, kernel_size=(1, 3),
                                         padding=(0, 1))
            self.b2_b = _make_basic_conv(channels=384, kernel_size=(3, 1),
                                         padding=(1, 0))
            self.b3_stem = nn.HybridSequential(prefix="")
            self.b3_stem.add(_make_basic_conv(channels=448, kernel_size=1))
            self.b3_stem.add(_make_basic_conv(channels=384, kernel_size=3,
                                              padding=1))
            self.b3_a = _make_basic_conv(channels=384, kernel_size=(1, 3),
                                         padding=(0, 1))
            self.b3_b = _make_basic_conv(channels=384, kernel_size=(3, 1),
                                         padding=(1, 0))
            self.b4 = _make_branch("avg", (192, 1, None, None))

    def hybrid_forward(self, F, x):
        o1 = self.b1(x)
        s2 = self.b2_stem(x)
        o2 = F.concat(self.b2_a(s2), self.b2_b(s2), dim=1)
        s3 = self.b3_stem(x)
        o3 = F.concat(self.b3_a(s3), self.b3_b(s3), dim=1)
        o4 = self.b4(x)
        return F.concat(o1, o2, o3, o4, dim=1)


class Inception3(HybridBlock):
    """Inception V3 (Szegedy et al. 2015), 299x299 input."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(_make_basic_conv(channels=32, kernel_size=3,
                                               strides=2))
            self.features.add(_make_basic_conv(channels=32, kernel_size=3))
            self.features.add(_make_basic_conv(channels=64, kernel_size=3,
                                               padding=1))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_basic_conv(channels=80, kernel_size=1))
            self.features.add(_make_basic_conv(channels=192, kernel_size=3))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_A(32, "A1_"))
            self.features.add(_make_A(64, "A2_"))
            self.features.add(_make_A(64, "A3_"))
            self.features.add(_make_B("B_"))
            self.features.add(_make_C(128, "C1_"))
            self.features.add(_make_C(160, "C2_"))
            self.features.add(_make_C(160, "C3_"))
            self.features.add(_make_C(192, "C4_"))
            self.features.add(_make_D("D_"))
            self.features.add(_InceptionE(prefix="E1_"))
            self.features.add(_InceptionE(prefix="E2_"))
            self.features.add(nn.AvgPool2D(pool_size=8))
            self.features.add(nn.Dropout(0.5))
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


def inception_v3(pretrained=False, ctx=None, **kwargs):
    net = Inception3(**kwargs)
    if pretrained:
        from ..model_store import load_pretrained
        load_pretrained(net, "inceptionv3", ctx)
    return net
