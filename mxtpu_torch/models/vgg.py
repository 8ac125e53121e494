"""VGG symbol: a copy of ``mxtpu/models/vgg.py`` (parity role:
example/image-classification/symbols/vgg.py)."""
from .. import symbol as sym

_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
         13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
         16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
         19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


def get_symbol(num_classes=1000, num_layers=16, batch_norm=False, **kwargs):
    if num_layers not in _spec:
        raise ValueError("vgg num_layers must be one of %s" % list(_spec))
    layers, filters = _spec[num_layers]
    net = sym.Variable("data")
    for i, num in enumerate(layers):
        for j in range(num):
            net = sym.Convolution(data=net, kernel=(3, 3), pad=(1, 1),
                                  num_filter=filters[i],
                                  name="conv%d_%d" % (i + 1, j + 1))
            if batch_norm:
                net = sym.BatchNorm(data=net,
                                    name="bn%d_%d" % (i + 1, j + 1))
            net = sym.Activation(data=net, act_type="relu")
        net = sym.Pooling(data=net, pool_type="max", kernel=(2, 2),
                          stride=(2, 2))
    net = sym.Flatten(data=net)
    net = sym.FullyConnected(data=net, num_hidden=4096, name="fc6")
    net = sym.Activation(data=net, act_type="relu")
    net = sym.Dropout(data=net, p=0.5)
    net = sym.FullyConnected(data=net, num_hidden=4096, name="fc7")
    net = sym.Activation(data=net, act_type="relu")
    net = sym.Dropout(data=net, p=0.5)
    net = sym.FullyConnected(data=net, num_hidden=num_classes, name="fc8")
    return sym.SoftmaxOutput(data=net, name="softmax")
