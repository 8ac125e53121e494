"""GoogLeNet / Inception-v1 symbol: a copy of ``mxtpu/models/googlenet.py``
(parity role: example/image-classification/symbols/googlenet.py — "Going
Deeper with Convolutions", Szegedy et al. 2014). The inception block
concatenates a 1x1 branch, reduced 3x3 and 5x5 branches, and a pooled
projection; no BatchNorm, so no fused BatchNorm->ReLU site."""
from .. import symbol as sym


def _conv(x, filters, kernel, name, stride=(1, 1), pad=(0, 0)):
    x = sym.Convolution(x, num_filter=filters, kernel=kernel, stride=stride,
                        pad=pad, name="conv_" + name)
    return sym.Activation(x, act_type="relu", name="relu_" + name)


def _inception(x, c1, r3, c3, r5, c5, proj, name):
    branches = [
        _conv(x, c1, (1, 1), name + "_1x1"),
        _conv(_conv(x, r3, (1, 1), name + "_3x3r"), c3, (3, 3),
              name + "_3x3", pad=(1, 1)),
        _conv(_conv(x, r5, (1, 1), name + "_5x5r"), c5, (5, 5),
              name + "_5x5", pad=(2, 2)),
        _conv(sym.Pooling(x, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                          pool_type="max"), proj, (1, 1), name + "_proj"),
    ]
    return sym.Concat(*branches, dim=1, name=name + "_concat")


# (c1, r3, c3, r5, c5, proj) per inception block, paper table 1
_BLOCKS = [
    ("3a", 64, 96, 128, 16, 32, 32), ("3b", 128, 128, 192, 32, 96, 64),
    ("pool", 0, 0, 0, 0, 0, 0),
    ("4a", 192, 96, 208, 16, 48, 64), ("4b", 160, 112, 224, 24, 64, 64),
    ("4c", 128, 128, 256, 24, 64, 64), ("4d", 112, 144, 288, 32, 64, 64),
    ("4e", 256, 160, 320, 32, 128, 128),
    ("pool", 0, 0, 0, 0, 0, 0),
    ("5a", 256, 160, 320, 32, 128, 128), ("5b", 384, 192, 384, 48, 128, 128),
]


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable("data")
    x = _conv(data, 64, (7, 7), "1", stride=(2, 2), pad=(3, 3))
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                    pool_type="max")
    x = _conv(x, 64, (1, 1), "2r")
    x = _conv(x, 192, (3, 3), "2", pad=(1, 1))
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                    pool_type="max")
    for spec in _BLOCKS:
        if spec[0] == "pool":
            x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                            pool_type="max")
        else:
            name, c1, r3, c3, r5, c5, proj = spec
            x = _inception(x, c1, r3, c3, r5, c5, proj, "in" + name)
    x = sym.Pooling(x, kernel=(7, 7), stride=(1, 1), pool_type="avg",
                    global_pool=True)
    x = sym.Flatten(x)
    x = sym.FullyConnected(x, num_hidden=num_classes, name="fc")
    return sym.SoftmaxOutput(x, name="softmax")
