"""AlexNet: a copy of mxtpu/gluon/model_zoo/vision/alexnet.py (parity:
python/mxnet/gluon/model_zoo/vision/alexnet.py)."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn


class AlexNet(HybridBlock):
    """AlexNet classifier (Krizhevsky et al. 2012), gluon model-zoo layout:
    5 convs + 3 pools, then two dropout-regularized 4096-wide dense
    layers."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(64, kernel_size=11, strides=4,
                                        padding=2, activation="relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(nn.Conv2D(192, kernel_size=5, padding=2,
                                        activation="relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(nn.Conv2D(384, kernel_size=3, padding=1,
                                        activation="relu"))
            self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                        activation="relu"))
            self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                        activation="relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(nn.Flatten())
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


def alexnet(pretrained=False, ctx=None, **kwargs):
    net = AlexNet(**kwargs)
    if pretrained:
        from ..model_store import load_pretrained
        load_pretrained(net, "alexnet", ctx)
    return net
