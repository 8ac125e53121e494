"""Inception-v4 symbol: a copy of ``mxtpu/models/inception_v4.py`` (parity:
example/image-classification/symbols/inception-v4.py — Szegedy et al.
2016, the pure-Inception variant): the paper's stem / 4xA / reduction-A
/ 7xB / reduction-B / 3xC layout, every branch conv+BN+relu feeding one
Concat."""
from .. import symbol as sym


def conv(data, num_filter, kernel, stride, pad, name):
    c = sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, no_bias=True,
                        name=name + "_conv")
    b = sym.BatchNorm(c, fix_gamma=False, eps=1e-3, momentum=0.9,
                      name=name + "_bn")
    return sym.Activation(b, act_type="relu", name=name + "_relu")


def stem(data):
    x = conv(data, 32, (3, 3), (2, 2), (0, 0), "stem1")
    x = conv(x, 32, (3, 3), (1, 1), (0, 0), "stem2")
    x = conv(x, 64, (3, 3), (1, 1), (1, 1), "stem3")
    p1 = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    c1 = conv(x, 96, (3, 3), (2, 2), (0, 0), "stem4")
    x = sym.Concat(p1, c1, dim=1)
    a = conv(x, 64, (1, 1), (1, 1), (0, 0), "stem5a1")
    a = conv(a, 96, (3, 3), (1, 1), (0, 0), "stem5a2")
    b = conv(x, 64, (1, 1), (1, 1), (0, 0), "stem5b1")
    b = conv(b, 64, (7, 1), (1, 1), (3, 0), "stem5b2")
    b = conv(b, 64, (1, 7), (1, 1), (0, 3), "stem5b3")
    b = conv(b, 96, (3, 3), (1, 1), (0, 0), "stem5b4")
    x = sym.Concat(a, b, dim=1)
    c2 = conv(x, 192, (3, 3), (2, 2), (0, 0), "stem6")
    p2 = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    return sym.Concat(c2, p2, dim=1)  # 384 ch


def block_a(x, name):
    p = sym.Pooling(x, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                    pool_type="avg")
    b0 = conv(p, 96, (1, 1), (1, 1), (0, 0), name + "_b0")
    b1 = conv(x, 96, (1, 1), (1, 1), (0, 0), name + "_b1")
    b2 = conv(x, 64, (1, 1), (1, 1), (0, 0), name + "_b2a")
    b2 = conv(b2, 96, (3, 3), (1, 1), (1, 1), name + "_b2b")
    b3 = conv(x, 64, (1, 1), (1, 1), (0, 0), name + "_b3a")
    b3 = conv(b3, 96, (3, 3), (1, 1), (1, 1), name + "_b3b")
    b3 = conv(b3, 96, (3, 3), (1, 1), (1, 1), name + "_b3c")
    return sym.Concat(b0, b1, b2, b3, dim=1)  # 384


def reduction_a(x, name):
    p = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    b1 = conv(x, 384, (3, 3), (2, 2), (0, 0), name + "_b1")
    b2 = conv(x, 192, (1, 1), (1, 1), (0, 0), name + "_b2a")
    b2 = conv(b2, 224, (3, 3), (1, 1), (1, 1), name + "_b2b")
    b2 = conv(b2, 256, (3, 3), (2, 2), (0, 0), name + "_b2c")
    return sym.Concat(p, b1, b2, dim=1)  # 1024


def block_b(x, name):
    p = sym.Pooling(x, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                    pool_type="avg")
    b0 = conv(p, 128, (1, 1), (1, 1), (0, 0), name + "_b0")
    b1 = conv(x, 384, (1, 1), (1, 1), (0, 0), name + "_b1")
    b2 = conv(x, 192, (1, 1), (1, 1), (0, 0), name + "_b2a")
    b2 = conv(b2, 224, (1, 7), (1, 1), (0, 3), name + "_b2b")
    b2 = conv(b2, 256, (7, 1), (1, 1), (3, 0), name + "_b2c")
    b3 = conv(x, 192, (1, 1), (1, 1), (0, 0), name + "_b3a")
    b3 = conv(b3, 192, (1, 7), (1, 1), (0, 3), name + "_b3b")
    b3 = conv(b3, 224, (7, 1), (1, 1), (3, 0), name + "_b3c")
    b3 = conv(b3, 224, (1, 7), (1, 1), (0, 3), name + "_b3d")
    b3 = conv(b3, 256, (7, 1), (1, 1), (3, 0), name + "_b3e")
    return sym.Concat(b0, b1, b2, b3, dim=1)  # 1024


def reduction_b(x, name):
    p = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    b1 = conv(x, 192, (1, 1), (1, 1), (0, 0), name + "_b1a")
    b1 = conv(b1, 192, (3, 3), (2, 2), (0, 0), name + "_b1b")
    b2 = conv(x, 256, (1, 1), (1, 1), (0, 0), name + "_b2a")
    b2 = conv(b2, 256, (1, 7), (1, 1), (0, 3), name + "_b2b")
    b2 = conv(b2, 320, (7, 1), (1, 1), (3, 0), name + "_b2c")
    b2 = conv(b2, 320, (3, 3), (2, 2), (0, 0), name + "_b2d")
    return sym.Concat(p, b1, b2, dim=1)  # 1536


def block_c(x, name):
    p = sym.Pooling(x, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                    pool_type="avg")
    b0 = conv(p, 256, (1, 1), (1, 1), (0, 0), name + "_b0")
    b1 = conv(x, 256, (1, 1), (1, 1), (0, 0), name + "_b1")
    b2 = conv(x, 384, (1, 1), (1, 1), (0, 0), name + "_b2")
    b2a = conv(b2, 256, (1, 3), (1, 1), (0, 1), name + "_b2a")
    b2b = conv(b2, 256, (3, 1), (1, 1), (1, 0), name + "_b2b")
    b3 = conv(x, 384, (1, 1), (1, 1), (0, 0), name + "_b3")
    b3 = conv(b3, 448, (1, 3), (1, 1), (0, 1), name + "_b3a")
    b3 = conv(b3, 512, (3, 1), (1, 1), (1, 0), name + "_b3b")
    b3a = conv(b3, 256, (3, 1), (1, 1), (1, 0), name + "_b3c")
    b3b = conv(b3, 256, (1, 3), (1, 1), (0, 1), name + "_b3d")
    return sym.Concat(b0, b1, b2a, b2b, b3a, b3b, dim=1)  # 1536


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable("data")
    x = stem(data)
    for i in range(4):
        x = block_a(x, "a%d" % (i + 1))
    x = reduction_a(x, "ra")
    for i in range(7):
        x = block_b(x, "b%d" % (i + 1))
    x = reduction_b(x, "rb")
    for i in range(3):
        x = block_c(x, "c%d" % (i + 1))
    pool = sym.Pooling(x, global_pool=True, kernel=(8, 8), pool_type="avg",
                       name="global_pool")
    flat = sym.Flatten(pool)
    drop = sym.Dropout(flat, p=0.2, name="dropout")
    fc = sym.FullyConnected(drop, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc, name="softmax")
