"""SSD single-shot detector symbols (config 5 of BASELINE.json): a copy
of ``mxtpu/models/ssd.py``, with the same node names, so parameters
cross between the packages by name (``convert.params_from_mxtpu``).

A reduced-VGG backbone (or the ``tiny`` one of the CPU gates),
multi-scale conv heads emitting per-anchor class scores and box offsets,
anchors from ``contrib.MultiBoxPrior``, training targets from
``contrib.MultiBoxTarget`` and decoded detections from
``contrib.MultiBoxDetection`` (``ops/contrib.py``; the detection's
suppression sweep is the hand-written kernel ``csrc/multibox_nms.cu`` on
the card). The executor walks the graph eagerly: the convolutions go to
cuDNN and the MultiBox ops to torch's library ops around that kernel.
"""
from __future__ import annotations

from .. import symbol as sym

__all__ = ["get_symbol_train", "get_symbol", "default_spec"]


def _conv_act(data, name, num_filter, kernel=(3, 3), pad=(1, 1),
              stride=(1, 1)):
    c = sym.Convolution(data, num_filter=num_filter, kernel=kernel, pad=pad,
                        stride=stride, name="%s_conv" % name)
    return sym.Activation(c, act_type="relu", name="%s_relu" % name)


def _vgg_reduced(data):
    """Compact VGG-style backbone; returns the two base feature maps."""
    x = data
    filters = [(64, 2), (128, 2), (256, 3)]
    for b, (nf, reps) in enumerate(filters):
        for r in range(reps):
            x = _conv_act(x, "b%d_%d" % (b, r), nf)
        x = sym.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2),
                        name="pool%d" % b)
    # conv4 block -> first detection source
    for r in range(3):
        x = _conv_act(x, "b3_%d" % r, 512)
    relu4_3 = x
    x = sym.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2),
                    name="pool4")
    for r in range(3):
        x = _conv_act(x, "b4_%d" % r, 512)
    # fc6/fc7 as convs (reference: VGG16_reduced dilated fc6)
    x = _conv_act(x, "fc6", 1024)
    x = _conv_act(x, "fc7", 1024, kernel=(1, 1), pad=(0, 0))
    return relu4_3, x


def _extra_layers(x, specs):
    """Progressively smaller feature maps for large-object anchors."""
    outs = []
    for i, nf in enumerate(specs):
        x = _conv_act(x, "extra%d_1" % i, nf // 2, kernel=(1, 1), pad=(0, 0))
        x = _conv_act(x, "extra%d_2" % i, nf, kernel=(3, 3), pad=(1, 1),
                      stride=(2, 2))
        outs.append(x)
    return outs


def default_spec(num_scales=6):
    """(sizes, ratios) per scale, mirroring example/ssd/symbol_factory.py."""
    sizes = [[0.1, 0.141], [0.2, 0.272], [0.37, 0.447], [0.54, 0.619],
             [0.71, 0.79], [0.88, 0.961]]
    ratios = [[1, 2, 0.5]] * 2 + [[1, 2, 0.5, 3, 1.0 / 3]] * 4
    return sizes[:num_scales], ratios[:num_scales]


def _multibox_layer(from_layers, num_classes, sizes, ratios, clip=False):
    """Attach cls/loc conv heads + anchor generators to each feature map
    (parity example/ssd/symbol/common.py:286 multibox_layer)."""
    cls_preds, loc_preds, anchors = [], [], []
    num_cls_channels = num_classes + 1
    for i, layer in enumerate(from_layers):
        size, ratio = sizes[i], ratios[i]
        num_anchors = len(size) + len(ratio) - 1
        loc = sym.Convolution(layer, num_filter=num_anchors * 4,
                              kernel=(3, 3), pad=(1, 1),
                              name="loc_pred%d_conv" % i)
        # (N, A*4, H, W) -> (N, H, W, A*4) -> (N, -1)
        loc = sym.transpose(loc, axes=(0, 2, 3, 1))
        loc_preds.append(sym.Flatten(loc))
        cls = sym.Convolution(layer, num_filter=num_anchors * num_cls_channels,
                              kernel=(3, 3), pad=(1, 1),
                              name="cls_pred%d_conv" % i)
        cls = sym.transpose(cls, axes=(0, 2, 3, 1))
        cls_preds.append(sym.Flatten(cls))
        anchors.append(sym.Reshape(
            sym.contrib.MultiBoxPrior(layer, sizes=tuple(size),
                                      ratios=tuple(ratio), clip=clip,
                                      name="anchors%d" % i),
            shape=(1, -1, 4)))
    loc_preds = sym.Concat(*loc_preds, dim=1, name="multibox_loc_pred")
    cls_concat = sym.Concat(*cls_preds, dim=1)
    # (N, A*(C+1)) -> (N, C+1, A): class axis second for SoftmaxOutput
    cls_preds_s = sym.Reshape(cls_concat, shape=(0, -1, num_cls_channels))
    cls_preds_s = sym.transpose(cls_preds_s, axes=(0, 2, 1))
    anchor_boxes = sym.Concat(*anchors, dim=1, name="multibox_anchors")
    return loc_preds, cls_preds_s, anchor_boxes


def _tiny_backbone(data):
    """Small backbone for smoke tests / CPU gates (role of the reference's
    lighter --network choices in example/ssd/symbol_factory.py)."""
    x = data
    for b, nf in enumerate((32, 64)):
        x = _conv_act(x, "t%d" % b, nf)
        x = sym.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2),
                        name="tpool%d" % b)
    x = _conv_act(x, "t2", 128)
    first = x
    x = sym.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2),
                    name="tpool2")
    x = _conv_act(x, "t3", 128)
    return first, x


def _build_features(data, num_scales, network="vgg16_reduced"):
    if network == "tiny":
        first, second = _tiny_backbone(data)
        extra_filters = [128, 128, 128, 128]
    else:
        first, second = _vgg_reduced(data)
        extra_filters = [512, 256, 256, 256]
    extras = _extra_layers(second, extra_filters[:max(0, num_scales - 2)])
    return [first, second] + extras


def get_symbol_train(num_classes=20, num_scales=6, nms_thresh=0.5,
                     force_suppress=False, nms_topk=400, clip=False,
                     network="vgg16_reduced"):
    """Training symbol: outputs [cls_prob, loc_loss, cls_label, det]
    (parity example/ssd/symbol/symbol_builder.py get_symbol_train)."""
    data = sym.Variable("data")
    label = sym.Variable("label")
    layers = _build_features(data, num_scales, network=network)
    sizes, ratios = default_spec(num_scales)
    loc_preds, cls_preds, anchor_boxes = _multibox_layer(
        layers, num_classes, sizes, ratios, clip=clip)

    tmp = sym.contrib.MultiBoxTarget(
        anchor_boxes, label, cls_preds, overlap_threshold=0.5,
        ignore_label=-1, negative_mining_ratio=3.0,
        minimum_negative_samples=0, negative_mining_thresh=0.5,
        variances=(0.1, 0.1, 0.2, 0.2), name="multibox_target")
    loc_target, loc_target_mask, cls_target = tmp[0], tmp[1], tmp[2]

    cls_prob = sym.SoftmaxOutput(cls_preds, cls_target,
                                 ignore_label=-1, use_ignore=True,
                                 multi_output=True, normalization="valid",
                                 name="cls_prob")
    loc_diff = loc_target_mask * (loc_preds - loc_target)
    loc_loss_ = sym.smooth_l1(loc_diff, scalar=1.0, name="loc_loss_")
    loc_loss = sym.MakeLoss(loc_loss_, grad_scale=1.0,
                            normalization="valid", name="loc_loss")

    cls_label = sym.MakeLoss(cls_target, grad_scale=0, name="cls_label")
    det = sym.contrib.MultiBoxDetection(
        cls_prob, loc_preds, anchor_boxes, name="detection",
        nms_threshold=nms_thresh, force_suppress=force_suppress,
        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=nms_topk)
    det = sym.MakeLoss(det, grad_scale=0, name="det_out")
    return sym.Group([cls_prob, loc_loss, cls_label, det])


def get_symbol(num_classes=20, num_scales=6, nms_thresh=0.5,
               force_suppress=False, nms_topk=400, clip=False,
               network="vgg16_reduced"):
    """Inference symbol: detections (N, A, 6) [cls, score, x1,y1,x2,y2]."""
    data = sym.Variable("data")
    layers = _build_features(data, num_scales, network=network)
    sizes, ratios = default_spec(num_scales)
    loc_preds, cls_preds, anchor_boxes = _multibox_layer(
        layers, num_classes, sizes, ratios, clip=clip)
    cls_prob = sym.softmax(cls_preds, axis=1, name="cls_prob")
    return sym.contrib.MultiBoxDetection(
        cls_prob, loc_preds, anchor_boxes, name="detection",
        nms_threshold=nms_thresh, force_suppress=force_suppress,
        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=nms_topk)
