"""Inception-v3 symbol: a copy of ``mxtpu/models/inception_v3.py``
(parity role: example/image-classification/symbols/inception-v3.py —
"Rethinking the Inception Architecture", Szegedy et al. 2015): 5x5-
factorized A modules, 7x7 asymmetric B modules, expanded-filter-bank C
modules, with BN after every convolution (299x299 input); each BN->ReLU
pair runs as one epilogue step at inference."""
from .. import symbol as sym


def _conv(x, filters, kernel, name, stride=(1, 1), pad=(0, 0)):
    x = sym.Convolution(x, num_filter=filters, kernel=kernel, stride=stride,
                        pad=pad, no_bias=True, name=name + "_conv")
    x = sym.BatchNorm(x, fix_gamma=False, name=name + "_bn")
    return sym.Activation(x, act_type="relu", name=name + "_relu")


def _module_a(x, pool_proj, name):
    """Fig 5: 1x1 / 5x5 / double-3x3 / pooled-projection branches."""
    b1 = _conv(x, 64, (1, 1), name + "_b1")
    b5 = _conv(_conv(x, 48, (1, 1), name + "_b5r"), 64, (5, 5),
               name + "_b5", pad=(2, 2))
    b3 = _conv(x, 64, (1, 1), name + "_b3r")
    b3 = _conv(b3, 96, (3, 3), name + "_b3a", pad=(1, 1))
    b3 = _conv(b3, 96, (3, 3), name + "_b3b", pad=(1, 1))
    bp = sym.Pooling(x, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="avg")
    bp = _conv(bp, pool_proj, (1, 1), name + "_bp")
    return sym.Concat(b1, b5, b3, bp, dim=1, name=name)


def _reduction_a(x, name):
    b3 = _conv(x, 384, (3, 3), name + "_b3", stride=(2, 2))
    bd = _conv(x, 64, (1, 1), name + "_bdr")
    bd = _conv(bd, 96, (3, 3), name + "_bda", pad=(1, 1))
    bd = _conv(bd, 96, (3, 3), name + "_bdb", stride=(2, 2))
    bp = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    return sym.Concat(b3, bd, bp, dim=1, name=name)


def _module_b(x, c7, name):
    """Fig 6: 7x7 factorized into 1x7/7x1 chains."""
    b1 = _conv(x, 192, (1, 1), name + "_b1")
    b7 = _conv(x, c7, (1, 1), name + "_b7r")
    b7 = _conv(b7, c7, (1, 7), name + "_b7a", pad=(0, 3))
    b7 = _conv(b7, 192, (7, 1), name + "_b7b", pad=(3, 0))
    bd = _conv(x, c7, (1, 1), name + "_bdr")
    bd = _conv(bd, c7, (7, 1), name + "_bda", pad=(3, 0))
    bd = _conv(bd, c7, (1, 7), name + "_bdb", pad=(0, 3))
    bd = _conv(bd, c7, (7, 1), name + "_bdc", pad=(3, 0))
    bd = _conv(bd, 192, (1, 7), name + "_bdd", pad=(0, 3))
    bp = sym.Pooling(x, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="avg")
    bp = _conv(bp, 192, (1, 1), name + "_bp")
    return sym.Concat(b1, b7, bd, bp, dim=1, name=name)


def _reduction_b(x, name):
    b3 = _conv(x, 192, (1, 1), name + "_b3r")
    b3 = _conv(b3, 320, (3, 3), name + "_b3", stride=(2, 2))
    b7 = _conv(x, 192, (1, 1), name + "_b7r")
    b7 = _conv(b7, 192, (1, 7), name + "_b7a", pad=(0, 3))
    b7 = _conv(b7, 192, (7, 1), name + "_b7b", pad=(3, 0))
    b7 = _conv(b7, 192, (3, 3), name + "_b7c", stride=(2, 2))
    bp = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    return sym.Concat(b3, b7, bp, dim=1, name=name)


def _module_c(x, name):
    """Fig 7: expanded filter bank — 3x3 split into parallel 1x3 + 3x1."""
    b1 = _conv(x, 320, (1, 1), name + "_b1")
    b3 = _conv(x, 384, (1, 1), name + "_b3r")
    b3 = sym.Concat(_conv(b3, 384, (1, 3), name + "_b3a", pad=(0, 1)),
                    _conv(b3, 384, (3, 1), name + "_b3b", pad=(1, 0)),
                    dim=1)
    bd = _conv(x, 448, (1, 1), name + "_bdr")
    bd = _conv(bd, 384, (3, 3), name + "_bda", pad=(1, 1))
    bd = sym.Concat(_conv(bd, 384, (1, 3), name + "_bdb", pad=(0, 1)),
                    _conv(bd, 384, (3, 1), name + "_bdc", pad=(1, 0)),
                    dim=1)
    bp = sym.Pooling(x, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="avg")
    bp = _conv(bp, 192, (1, 1), name + "_bp")
    return sym.Concat(b1, b3, bd, bp, dim=1, name=name)


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable("data")
    x = _conv(data, 32, (3, 3), "stem1", stride=(2, 2))
    x = _conv(x, 32, (3, 3), "stem2")
    x = _conv(x, 64, (3, 3), "stem3", pad=(1, 1))
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = _conv(x, 80, (1, 1), "stem4")
    x = _conv(x, 192, (3, 3), "stem5")
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = _module_a(x, 32, "mixed_a1")
    x = _module_a(x, 64, "mixed_a2")
    x = _module_a(x, 64, "mixed_a3")
    x = _reduction_a(x, "mixed_ra")
    x = _module_b(x, 128, "mixed_b1")
    x = _module_b(x, 160, "mixed_b2")
    x = _module_b(x, 160, "mixed_b3")
    x = _module_b(x, 192, "mixed_b4")
    x = _reduction_b(x, "mixed_rb")
    x = _module_c(x, "mixed_c1")
    x = _module_c(x, "mixed_c2")
    x = sym.Pooling(x, kernel=(8, 8), pool_type="avg", global_pool=True)
    x = sym.Flatten(x)
    x = sym.FullyConnected(x, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(x, name="softmax")
