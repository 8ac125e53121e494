"""ResNeXt symbol: a copy of ``mxtpu/models/resnext.py`` (parity:
example/image-classification/symbols/resnext.py); the cardinality-grouped
3x3 is Convolution's ``num_group``."""
from .. import symbol as sym


def resnext_unit(data, num_filter, stride, dim_match, name, num_group=32,
                 bottle_neck=True, bn_mom=0.9):
    """Post-activation (v1-style) unit: conv-bn-relu x3 + identity join,
    grouped middle conv (cardinality)."""
    if bottle_neck:
        mid = max(num_filter // 2, num_group)
        conv1 = sym.Convolution(data, num_filter=mid, kernel=(1, 1),
                                stride=(1, 1), pad=(0, 0), no_bias=True,
                                name=name + "_conv1")
        bn1 = sym.BatchNorm(conv1, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, name=name + "_bn1")
        act1 = sym.Activation(bn1, act_type="relu", name=name + "_relu1")
        conv2 = sym.Convolution(act1, num_filter=mid, num_group=num_group,
                                kernel=(3, 3), stride=stride, pad=(1, 1),
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


def resnext(units, num_stages, filter_list, num_classes, image_shape,
            num_group=32, bottle_neck=True, bn_mom=0.9):
    data = sym.Variable("data")
    (nchannel, height, width) = image_shape
    data = sym.BatchNorm(data, fix_gamma=True, eps=2e-5, momentum=bn_mom,
                         name="bn_data")
    if height <= 32:  # cifar-style stem
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
        body = resnext_unit(body, filter_list[i + 1], stride, False,
                            "stage%d_unit1" % (i + 1), num_group,
                            bottle_neck, bn_mom)
        for j in range(units[i] - 1):
            body = resnext_unit(body, filter_list[i + 1], (1, 1), True,
                                "stage%d_unit%d" % (i + 1, j + 2),
                                num_group, bottle_neck, bn_mom)
    pool = sym.Pooling(body, global_pool=True, kernel=(7, 7),
                       pool_type="avg", name="pool1")
    flat = sym.Flatten(pool)
    fc = sym.FullyConnected(flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc, name="softmax")


def get_symbol(num_classes=1000, num_layers=50, image_shape=(3, 224, 224),
               num_group=32, **kwargs):
    """ResNeXt-{26,50,101,152} (ImageNet shapes) or the cifar variants."""
    (nchannel, height, width) = image_shape
    if height <= 32:
        num_stages = 3
        if (num_layers - 2) % 9 == 0 and num_layers >= 29:
            per_stage = (num_layers - 2) // 9
            units = [per_stage] * num_stages
            filter_list = [16, 64, 128, 256]
            bottle_neck = True
        else:
            per_stage = (num_layers - 2) // 6
            units = [per_stage] * num_stages
            filter_list = [16, 16, 32, 64]
            bottle_neck = False
    else:
        num_stages = 4
        filter_list = [64, 256, 512, 1024, 2048]
        bottle_neck = True
        stage_units = {26: [2, 2, 2, 2], 38: [3, 3, 3, 3],
                       50: [3, 4, 6, 3], 101: [3, 4, 23, 3],
                       152: [3, 8, 36, 3]}
        if num_layers not in stage_units:
            raise ValueError("no resnext-%d configuration" % num_layers)
        units = stage_units[num_layers]
    return resnext(units, num_stages, filter_list, num_classes, image_shape,
                   num_group=num_group, bottle_neck=bottle_neck, **kwargs)
