"""ResNet v1 (post-activation) symbol: a copy of
``mxtpu/models/resnet_v1.py`` (parity: example/image-classification/
symbols/resnet-v1.py), conv-bn-relu with the relu after the residual join."""
from .. import symbol as sym


def residual_unit_v1(data, num_filter, stride, dim_match, name,
                     bottle_neck=True, bn_mom=0.9):
    if bottle_neck:
        conv1 = sym.Convolution(data, num_filter=num_filter // 4,
                                kernel=(1, 1), stride=stride, pad=(0, 0),
                                no_bias=True, name=name + "_conv1")
        bn1 = sym.BatchNorm(conv1, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, name=name + "_bn1")
        act1 = sym.Activation(bn1, act_type="relu", name=name + "_relu1")
        conv2 = sym.Convolution(act1, num_filter=num_filter // 4,
                                kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                                no_bias=True, name=name + "_conv2")
        bn2 = sym.BatchNorm(conv2, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, name=name + "_bn2")
        act2 = sym.Activation(bn2, act_type="relu", name=name + "_relu2")
        conv3 = sym.Convolution(act2, num_filter=num_filter, kernel=(1, 1),
                                stride=(1, 1), pad=(0, 0), no_bias=True,
                                name=name + "_conv3")
        bn3 = sym.BatchNorm(conv3, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, name=name + "_bn3")
        if dim_match:
            shortcut = data
        else:
            sc = sym.Convolution(data, num_filter=num_filter, kernel=(1, 1),
                                 stride=stride, no_bias=True,
                                 name=name + "_sc")
            shortcut = sym.BatchNorm(sc, fix_gamma=False, eps=2e-5,
                                     momentum=bn_mom, name=name + "_sc_bn")
        return sym.Activation(bn3 + shortcut, act_type="relu",
                              name=name + "_relu")
    conv1 = sym.Convolution(data, num_filter=num_filter, kernel=(3, 3),
                            stride=stride, pad=(1, 1), no_bias=True,
                            name=name + "_conv1")
    bn1 = sym.BatchNorm(conv1, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                        name=name + "_bn1")
    act1 = sym.Activation(bn1, act_type="relu", name=name + "_relu1")
    conv2 = sym.Convolution(act1, num_filter=num_filter, kernel=(3, 3),
                            stride=(1, 1), pad=(1, 1), no_bias=True,
                            name=name + "_conv2")
    bn2 = sym.BatchNorm(conv2, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                        name=name + "_bn2")
    if dim_match:
        shortcut = data
    else:
        sc = sym.Convolution(data, num_filter=num_filter, kernel=(1, 1),
                             stride=stride, no_bias=True, name=name + "_sc")
        shortcut = sym.BatchNorm(sc, fix_gamma=False, eps=2e-5,
                                 momentum=bn_mom, name=name + "_sc_bn")
    return sym.Activation(bn2 + shortcut, act_type="relu",
                          name=name + "_relu")


def get_symbol(num_classes=1000, num_layers=50, image_shape=(3, 224, 224),
               bn_mom=0.9, **kwargs):
    (nchannel, height, width) = image_shape
    if height <= 32:
        num_stages = 3
        if (num_layers - 2) % 9 == 0 and num_layers >= 164:
            units = [(num_layers - 2) // 9] * num_stages
            filter_list = [16, 64, 128, 256]
            bottle_neck = True
        else:
            units = [(num_layers - 2) // 6] * num_stages
            filter_list = [16, 16, 32, 64]
            bottle_neck = False
    else:
        num_stages = 4
        stage_units = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3],
                       50: [3, 4, 6, 3], 101: [3, 4, 23, 3],
                       152: [3, 8, 36, 3], 200: [3, 24, 36, 3]}
        if num_layers not in stage_units:
            raise ValueError("no resnet-v1-%d configuration" % num_layers)
        units = stage_units[num_layers]
        if num_layers >= 50:
            filter_list = [64, 256, 512, 1024, 2048]
            bottle_neck = True
        else:
            filter_list = [64, 64, 128, 256, 512]
            bottle_neck = False

    data = sym.Variable("data")
    if height <= 32:
        body = sym.Convolution(data, num_filter=filter_list[0],
                               kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                               no_bias=True, name="conv0")
    else:
        body = sym.Convolution(data, num_filter=filter_list[0],
                               kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                               no_bias=True, name="conv0")
        body = sym.BatchNorm(body, fix_gamma=False, eps=2e-5,
                             momentum=bn_mom, name="bn0")
        body = sym.Activation(body, act_type="relu", name="relu0")
        body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           pool_type="max")
    for i in range(num_stages):
        stride = (1, 1) if i == 0 else (2, 2)
        body = residual_unit_v1(body, filter_list[i + 1], stride, False,
                                "stage%d_unit1" % (i + 1), bottle_neck,
                                bn_mom)
        for j in range(units[i] - 1):
            body = residual_unit_v1(body, filter_list[i + 1], (1, 1), True,
                                    "stage%d_unit%d" % (i + 1, j + 2),
                                    bottle_neck, bn_mom)
    pool = sym.Pooling(body, global_pool=True, kernel=(7, 7),
                       pool_type="avg", name="pool1")
    flat = sym.Flatten(pool)
    fc = sym.FullyConnected(flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc, name="softmax")
