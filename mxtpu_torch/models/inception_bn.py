"""Inception-BN symbol: a copy of ``mxtpu/models/inception_bn.py``
(parity role: example/image-classification/symbols/inception-bn.py)."""
from .. import symbol as sym


def _conv_factory(data, num_filter, kernel, stride=(1, 1), pad=(0, 0),
                  name=None, suffix=""):
    conv = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                           stride=stride, pad=pad,
                           name="conv_%s%s" % (name, suffix))
    bn = sym.BatchNorm(data=conv, name="bn_%s%s" % (name, suffix))
    act = sym.Activation(data=bn, act_type="relu",
                         name="relu_%s%s" % (name, suffix))
    return act


def _inception_a(data, num_1x1, num_3x3red, num_3x3, num_d3x3red, num_d3x3,
                 pool, proj, name):
    c1x1 = _conv_factory(data, num_1x1, (1, 1), name="%s_1x1" % name)
    c3x3r = _conv_factory(data, num_3x3red, (1, 1),
                          name="%s_3x3" % name, suffix="_reduce")
    c3x3 = _conv_factory(c3x3r, num_3x3, (3, 3), pad=(1, 1),
                         name="%s_3x3" % name)
    cd3x3r = _conv_factory(data, num_d3x3red, (1, 1),
                           name="%s_double_3x3" % name, suffix="_reduce")
    cd3x3 = _conv_factory(cd3x3r, num_d3x3, (3, 3), pad=(1, 1),
                          name="%s_double_3x3_0" % name)
    cd3x3 = _conv_factory(cd3x3, num_d3x3, (3, 3), pad=(1, 1),
                          name="%s_double_3x3_1" % name)
    pooling = sym.Pooling(data=data, kernel=(3, 3), stride=(1, 1),
                          pad=(1, 1), pool_type=pool,
                          name="%s_pool_%s_pool" % (pool, name))
    cproj = _conv_factory(pooling, proj, (1, 1), name="%s_proj" % name)
    return sym.Concat(c1x1, c3x3, cd3x3, cproj,
                      name="ch_concat_%s_chconcat" % name)


def _inception_b(data, num_3x3red, num_3x3, num_d3x3red, num_d3x3, name):
    c3x3r = _conv_factory(data, num_3x3red, (1, 1),
                          name="%s_3x3" % name, suffix="_reduce")
    c3x3 = _conv_factory(c3x3r, num_3x3, (3, 3), pad=(1, 1), stride=(2, 2),
                         name="%s_3x3" % name)
    cd3x3r = _conv_factory(data, num_d3x3red, (1, 1),
                           name="%s_double_3x3" % name, suffix="_reduce")
    cd3x3 = _conv_factory(cd3x3r, num_d3x3, (3, 3), pad=(1, 1),
                          name="%s_double_3x3_0" % name)
    cd3x3 = _conv_factory(cd3x3, num_d3x3, (3, 3), pad=(1, 1),
                          stride=(2, 2), name="%s_double_3x3_1" % name)
    pooling = sym.Pooling(data=data, kernel=(3, 3), stride=(2, 2),
                          pad=(1, 1), pool_type="max",
                          name="max_pool_%s_pool" % name)
    return sym.Concat(c3x3, cd3x3, pooling,
                      name="ch_concat_%s_chconcat" % name)


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable("data")
    conv1 = _conv_factory(data, 64, (7, 7), stride=(2, 2), pad=(3, 3),
                          name="conv1")
    pool1 = sym.Pooling(data=conv1, kernel=(3, 3), stride=(2, 2),
                        pool_type="max")
    conv2r = _conv_factory(pool1, 64, (1, 1), name="conv2red")
    conv2 = _conv_factory(conv2r, 192, (3, 3), pad=(1, 1), name="conv2")
    pool2 = sym.Pooling(data=conv2, kernel=(3, 3), stride=(2, 2),
                        pool_type="max")
    in3a = _inception_a(pool2, 64, 64, 64, 64, 96, "avg", 32, "3a")
    in3b = _inception_a(in3a, 64, 64, 96, 64, 96, "avg", 64, "3b")
    in3c = _inception_b(in3b, 128, 160, 64, 96, "3c")
    in4a = _inception_a(in3c, 224, 64, 96, 96, 128, "avg", 128, "4a")
    in4b = _inception_a(in4a, 192, 96, 128, 96, 128, "avg", 128, "4b")
    in4c = _inception_a(in4b, 160, 128, 160, 128, 160, "avg", 128, "4c")
    in4d = _inception_a(in4c, 96, 128, 192, 160, 192, "avg", 128, "4d")
    in4e = _inception_b(in4d, 128, 192, 192, 256, "4e")
    in5a = _inception_a(in4e, 352, 192, 320, 160, 224, "avg", 128, "5a")
    in5b = _inception_a(in5a, 352, 192, 320, 192, 224, "max", 128, "5b")
    avg = sym.Pooling(data=in5b, kernel=(7, 7), stride=(1, 1),
                      pool_type="avg")
    flatten = sym.Flatten(data=avg)
    fc1 = sym.FullyConnected(data=flatten, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc1, name="softmax")
