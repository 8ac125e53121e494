"""MobileNet v1 symbol: a copy of ``mxtpu/models/mobilenet.py`` (parity:
example/image-classification/symbols/mobilenet.py); the depthwise stage
is Convolution with ``num_group`` == channels."""
from .. import symbol as sym


def conv_bn(data, num_filter, kernel, stride, pad, name, num_group=1):
    conv = sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                           stride=stride, pad=pad, num_group=num_group,
                           no_bias=True, name=name)
    bn = sym.BatchNorm(conv, fix_gamma=False, eps=2e-5, momentum=0.9,
                       name=name + "_bn")
    return sym.Activation(bn, act_type="relu", name=name + "_relu")


def separable(data, in_ch, out_ch, stride, name):
    """Depthwise 3x3 (groups == channels) + pointwise 1x1."""
    dw = conv_bn(data, in_ch, (3, 3), stride, (1, 1), name + "_dw",
                 num_group=in_ch)
    return conv_bn(dw, out_ch, (1, 1), (1, 1), (0, 0), name + "_pw")


def get_symbol(num_classes=1000, multiplier=1.0, **kwargs):
    def ch(n):
        return max(int(n * multiplier), 8)

    data = sym.Variable("data")
    body = conv_bn(data, ch(32), (3, 3), (2, 2), (1, 1), "conv1")
    cfg = [
        # (in, out, stride)
        (32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
        (256, 256, 1), (256, 512, 2),
        (512, 512, 1), (512, 512, 1), (512, 512, 1), (512, 512, 1),
        (512, 512, 1),
        (512, 1024, 2), (1024, 1024, 1),
    ]
    for i, (cin, cout, s) in enumerate(cfg):
        body = separable(body, ch(cin), ch(cout), (s, s), "sep%d" % (i + 1))
    pool = sym.Pooling(body, global_pool=True, kernel=(7, 7),
                       pool_type="avg", name="pool")
    flat = sym.Flatten(pool)
    fc = sym.FullyConnected(flat, num_hidden=num_classes, name="fc")
    return sym.SoftmaxOutput(fc, name="softmax")
