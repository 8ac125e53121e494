"""SqueezeNet 1.0/1.1: a copy of mxtpu/gluon/model_zoo/vision/squeezenet.py
(parity: python/mxnet/gluon/model_zoo/vision/squeezenet.py)."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels):
    out = nn.HybridSequential(prefix="")
    out.add(_make_fire_conv(squeeze_channels, 1))
    paths = _FireExpand(expand1x1_channels, expand3x3_channels)
    out.add(paths)
    return out


def _make_fire_conv(channels, kernel_size, padding=0):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(channels, kernel_size, padding=padding))
    out.add(nn.Activation("relu"))
    return out


class _FireExpand(HybridBlock):
    """Parallel 1x1 + 3x3 expand paths, channel-concatenated."""

    def __init__(self, expand1x1_channels, expand3x3_channels, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.p1 = _make_fire_conv(expand1x1_channels, 1)
            self.p3 = _make_fire_conv(expand3x3_channels, 3, padding=1)

    def hybrid_forward(self, F, x):
        return F.concat(self.p1(x), self.p3(x), dim=1)


class SqueezeNet(HybridBlock):
    """SqueezeNet (Iandola et al. 2016): fire modules (squeeze 1x1 then
    parallel 1x1/3x3 expands) and a fully-convolutional classifier head."""

    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        assert version in ("1.0", "1.1")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if version == "1.0":
                self.features.add(nn.Conv2D(96, kernel_size=7, strides=2))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(64, 256, 256))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_make_fire(64, 256, 256))
            else:
                self.features.add(nn.Conv2D(64, kernel_size=3, strides=2))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(64, 256, 256))
                self.features.add(_make_fire(64, 256, 256))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.HybridSequential(prefix="")
            self.output.add(nn.Conv2D(classes, kernel_size=1))
            self.output.add(nn.Activation("relu"))
            self.output.add(nn.GlobalAvgPool2D())
            self.output.add(nn.Flatten())

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


def get_squeezenet(version, pretrained=False, ctx=None, **kwargs):
    net = SqueezeNet(version, **kwargs)
    if pretrained:
        from ..model_store import load_pretrained
        load_pretrained(net, "squeezenet%s" % version, ctx)
    return net


def squeezenet1_0(**kwargs):
    return get_squeezenet("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return get_squeezenet("1.1", **kwargs)
