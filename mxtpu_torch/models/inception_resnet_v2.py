"""Inception-ResNet-v2 symbol: a copy of
``mxtpu/models/inception_resnet_v2.py`` (parity: example/image-
classification/symbols/inception-resnet-v2.py — Szegedy et al. 2016, the
residual variant). Residual scaling 0.17/0.10/0.20 per the paper keeps
the pre-activation sums stable."""
from .. import symbol as sym


def conv(data, num_filter, kernel, stride, pad, name, act=True):
    c = sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, no_bias=True,
                        name=name + "_conv")
    b = sym.BatchNorm(c, fix_gamma=False, eps=1e-3, momentum=0.9,
                      name=name + "_bn")
    if not act:
        return b
    return sym.Activation(b, act_type="relu", name=name + "_relu")


def stem(data):
    x = conv(data, 32, (3, 3), (2, 2), (0, 0), "stem1")
    x = conv(x, 32, (3, 3), (1, 1), (0, 0), "stem2")
    x = conv(x, 64, (3, 3), (1, 1), (1, 1), "stem3")
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = conv(x, 80, (1, 1), (1, 1), (0, 0), "stem4")
    x = conv(x, 192, (3, 3), (1, 1), (0, 0), "stem5")
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    # mixed 5b: 96 + 64 + 96 + 64 = 320 ch
    b0 = conv(x, 96, (1, 1), (1, 1), (0, 0), "m5b_b0")
    b1 = conv(x, 48, (1, 1), (1, 1), (0, 0), "m5b_b1a")
    b1 = conv(b1, 64, (5, 5), (1, 1), (2, 2), "m5b_b1b")
    b2 = conv(x, 64, (1, 1), (1, 1), (0, 0), "m5b_b2a")
    b2 = conv(b2, 96, (3, 3), (1, 1), (1, 1), "m5b_b2b")
    b2 = conv(b2, 96, (3, 3), (1, 1), (1, 1), "m5b_b2c")
    p = sym.Pooling(x, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                    pool_type="avg")
    b3 = conv(p, 64, (1, 1), (1, 1), (0, 0), "m5b_b3")
    return sym.Concat(b0, b1, b2, b3, dim=1)


def block35(x, name, in_ch=320, scale=0.17):
    """Inception-ResNet-A: 35x35 residual block."""
    b0 = conv(x, 32, (1, 1), (1, 1), (0, 0), name + "_b0")
    b1 = conv(x, 32, (1, 1), (1, 1), (0, 0), name + "_b1a")
    b1 = conv(b1, 32, (3, 3), (1, 1), (1, 1), name + "_b1b")
    b2 = conv(x, 32, (1, 1), (1, 1), (0, 0), name + "_b2a")
    b2 = conv(b2, 48, (3, 3), (1, 1), (1, 1), name + "_b2b")
    b2 = conv(b2, 64, (3, 3), (1, 1), (1, 1), name + "_b2c")
    mixed = sym.Concat(b0, b1, b2, dim=1)
    up = sym.Convolution(mixed, num_filter=in_ch, kernel=(1, 1),
                         stride=(1, 1), pad=(0, 0), name=name + "_up")
    return sym.Activation(x + up * scale, act_type="relu",
                          name=name + "_relu")


def reduction_a(x, name):
    p = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    b1 = conv(x, 384, (3, 3), (2, 2), (0, 0), name + "_b1")
    b2 = conv(x, 256, (1, 1), (1, 1), (0, 0), name + "_b2a")
    b2 = conv(b2, 256, (3, 3), (1, 1), (1, 1), name + "_b2b")
    b2 = conv(b2, 384, (3, 3), (2, 2), (0, 0), name + "_b2c")
    return sym.Concat(p, b1, b2, dim=1)  # 320+384+384 = 1088


def block17(x, name, in_ch=1088, scale=0.10):
    """Inception-ResNet-B: 17x17 residual block."""
    b0 = conv(x, 192, (1, 1), (1, 1), (0, 0), name + "_b0")
    b1 = conv(x, 128, (1, 1), (1, 1), (0, 0), name + "_b1a")
    b1 = conv(b1, 160, (1, 7), (1, 1), (0, 3), name + "_b1b")
    b1 = conv(b1, 192, (7, 1), (1, 1), (3, 0), name + "_b1c")
    mixed = sym.Concat(b0, b1, dim=1)
    up = sym.Convolution(mixed, num_filter=in_ch, kernel=(1, 1),
                         stride=(1, 1), pad=(0, 0), name=name + "_up")
    return sym.Activation(x + up * scale, act_type="relu",
                          name=name + "_relu")


def reduction_b(x, name):
    p = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    b1 = conv(x, 256, (1, 1), (1, 1), (0, 0), name + "_b1a")
    b1 = conv(b1, 384, (3, 3), (2, 2), (0, 0), name + "_b1b")
    b2 = conv(x, 256, (1, 1), (1, 1), (0, 0), name + "_b2a")
    b2 = conv(b2, 288, (3, 3), (2, 2), (0, 0), name + "_b2b")
    b3 = conv(x, 256, (1, 1), (1, 1), (0, 0), name + "_b3a")
    b3 = conv(b3, 288, (3, 3), (1, 1), (1, 1), name + "_b3b")
    b3 = conv(b3, 320, (3, 3), (2, 2), (0, 0), name + "_b3c")
    return sym.Concat(p, b1, b2, b3, dim=1)  # 1088+384+288+320 = 2080


def block8(x, name, in_ch=2080, scale=0.20, act=True):
    """Inception-ResNet-C: 8x8 residual block."""
    b0 = conv(x, 192, (1, 1), (1, 1), (0, 0), name + "_b0")
    b1 = conv(x, 192, (1, 1), (1, 1), (0, 0), name + "_b1a")
    b1 = conv(b1, 224, (1, 3), (1, 1), (0, 1), name + "_b1b")
    b1 = conv(b1, 256, (3, 1), (1, 1), (1, 0), name + "_b1c")
    mixed = sym.Concat(b0, b1, dim=1)
    up = sym.Convolution(mixed, num_filter=in_ch, kernel=(1, 1),
                         stride=(1, 1), pad=(0, 0), name=name + "_up")
    out = x + up * scale
    if act:
        return sym.Activation(out, act_type="relu", name=name + "_relu")
    return out


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable("data")
    x = stem(data)
    for i in range(10):
        x = block35(x, "ira%d" % (i + 1))
    x = reduction_a(x, "ra")
    for i in range(20):
        x = block17(x, "irb%d" % (i + 1))
    x = reduction_b(x, "rb")
    for i in range(9):
        x = block8(x, "irc%d" % (i + 1))
    x = block8(x, "irc10", act=False)
    x = conv(x, 1536, (1, 1), (1, 1), (0, 0), "conv_final")
    pool = sym.Pooling(x, global_pool=True, kernel=(8, 8), pool_type="avg",
                       name="global_pool")
    flat = sym.Flatten(pool)
    drop = sym.Dropout(flat, p=0.2, name="dropout")
    fc = sym.FullyConnected(drop, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc, name="softmax")
