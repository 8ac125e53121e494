"""MobileNet v1 (multiplier 1.0/0.75/0.5/0.25): a copy of
mxtpu/gluon/model_zoo/vision/mobilenet.py (parity:
python/mxnet/gluon/model_zoo/vision/mobilenet.py)."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn


def _add_conv(out, channels=1, kernel=1, stride=1, pad=0, num_group=1):
    out.add(nn.Conv2D(channels, kernel, stride, pad, groups=num_group,
                      use_bias=False))
    out.add(nn.BatchNorm())
    out.add(nn.Activation("relu"))


def _add_conv_dw(out, dw_channels, channels, stride):
    """Depthwise 3x3 + pointwise 1x1 separable pair."""
    _add_conv(out, dw_channels, kernel=3, stride=stride, pad=1,
              num_group=dw_channels)
    _add_conv(out, channels)


class MobileNet(HybridBlock):
    """MobileNet v1 (Howard et al. 2017): depthwise-separable convolutions
    with a global width multiplier."""

    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            _add_conv(self.features, int(32 * multiplier), kernel=3,
                      stride=2, pad=1)
            dw_channels = [int(x * multiplier) for x in
                           [32, 64] + [128] * 2 + [256] * 2 +
                           [512] * 6 + [1024]]
            channels = [int(x * multiplier) for x in
                        [64] + [128] * 2 + [256] * 2 + [512] * 6 +
                        [1024] * 2]
            strides = [1, 2, 1, 2, 1, 2] + [1] * 5 + [2, 1]
            for dwc, c, s in zip(dw_channels, channels, strides):
                _add_conv_dw(self.features, dwc, c, s)
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


def get_mobilenet(multiplier, pretrained=False, ctx=None, **kwargs):
    net = MobileNet(multiplier, **kwargs)
    if pretrained:
        from ..model_store import load_pretrained
        version_suffix = ("%.2f" % multiplier).rstrip("0").rstrip(".")
        load_pretrained(net, "mobilenet%s" % version_suffix, ctx)
    return net


def mobilenet1_0(**kwargs):
    return get_mobilenet(1.0, **kwargs)


def mobilenet0_75(**kwargs):
    return get_mobilenet(0.75, **kwargs)


def mobilenet0_5(**kwargs):
    return get_mobilenet(0.5, **kwargs)


def mobilenet0_25(**kwargs):
    return get_mobilenet(0.25, **kwargs)
