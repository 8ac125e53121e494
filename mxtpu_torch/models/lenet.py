"""LeNet symbol: a copy of ``mxtpu/models/lenet.py`` (parity:
example/image-classification/symbols/lenet.py)."""
from .. import symbol as sym


def get_symbol(num_classes=10, add_stn=False, **kwargs):
    data = sym.Variable("data")
    conv1 = sym.Convolution(data, kernel=(5, 5), num_filter=20, name="conv1")
    tanh1 = sym.Activation(conv1, act_type="tanh")
    pool1 = sym.Pooling(tanh1, pool_type="max", kernel=(2, 2), stride=(2, 2))
    conv2 = sym.Convolution(pool1, kernel=(5, 5), num_filter=50, name="conv2")
    tanh2 = sym.Activation(conv2, act_type="tanh")
    pool2 = sym.Pooling(tanh2, pool_type="max", kernel=(2, 2), stride=(2, 2))
    flatten = sym.Flatten(pool2)
    fc1 = sym.FullyConnected(flatten, num_hidden=500, name="fc1")
    tanh3 = sym.Activation(fc1, act_type="tanh")
    fc2 = sym.FullyConnected(tanh3, num_hidden=num_classes, name="fc2")
    return sym.SoftmaxOutput(fc2, name="softmax")
