"""The Faster R-CNN: the two-stage detector of MXNet's example/rcnn, in
two configurations.

The port's copy of ``examples/rcnn/train_end2end.py`` (``make_batch``,
``ProposalTarget``/``ProposalTargetProp``, ``build_train_symbol``,
``build_test_symbol``, ``evaluate``, ``_iou``, ``_bbox_transform``,
``_bbox_decode``), which imports ``mxtpu`` and cannot be imported by the
port. Every function takes one of ``CONFIGS``:

- ``"example"``: that file's own values (3x64x64 images, the three-conv
  backbone at stride 8, anchors of scales (2, 3) and ratio 1, 8 ROIs an
  image, Adam in its ``main``). With it the graph, the parameter names
  and the data draws are the file's, so a run here equals mxtpu's.
- ``"vgg16"``: the widths of MXNet v0.11's
  ``example/rcnn/rcnn/symbol/symbol_vgg.py`` (``get_vgg_train``,
  ``get_vgg_test``) with ``example/rcnn/rcnn/config.py``'s defaults:
  VGG16's conv1_1-conv5_3 with four 2x2 max pools (feature stride 16),
  ``rpn_conv_3x3`` 512, anchors of scales (8, 16, 32) x ratios (0.5, 1,
  2), Proposal at 12,000 / 2,000 candidates in training and 6,000 / 300
  in test with threshold 0.7 and ``rpn_min_size`` 16, 256 RPN anchors an
  image, 128 ROIs an image with a quarter foreground, 21 classes,
  ROIPooling 7x7 at 1/16, fc6 and fc7 of 4096 with ReLU and Dropout 0.5,
  and images of 600x1000, two a batch. ``FIXED_PARAMS`` (conv1, conv2)
  are held fixed in training, as the reference holds them.

Cuts against the reference, both configurations: the images are
synthetic, one painted box each (VOC is not in the repository); the RPN
labels come from the example's numpy assignment (positives IoU > 0.5 and
each box's best anchor, negatives IoU < 0.3), sampled to ``rpn_batch``
anchors an image for ``"vgg16"``; the stage-2 targets are not normalised
by the reference's means and deviations; the RPN class scores go through
``softmax`` over the (N, 2, A*H*W) view, as the example's, where the
reference's ``SoftmaxActivation(mode="channel")`` takes the (N, 2, A*H,
W) view (the same numbers), and Proposal's inputs pass ``BlockGrad``, as
the example's (the reference's Proposal backward writes zeros).
"""
from __future__ import annotations

import numpy as np

from .. import io
from .. import ndarray as nd
from .. import operator
from .. import symbol as sym
from ..ops.spatial import _gen_anchors

__all__ = ["CONFIGS", "num_anchors", "feature_shape", "all_anchors",
           "make_batch", "ProposalTarget", "ProposalTargetProp",
           "build_train_symbol", "build_test_symbol", "evaluate",
           "data_shapes", "label_shapes", "fixed_params", "batch_of",
           "FIXED_PARAMS", "DATA_NAMES", "LABEL_NAMES"]

CONFIGS = {
    "example": dict(image=(64, 64), stride=8, scales=(2.0, 3.0),
                    ratios=(1.0,), num_classes=3, backbone="example",
                    rpn_conv=64, rois_per_img=8, fg_fraction=0.5,
                    pre_nms_train=0, post_nms_train=16, pre_nms_test=0,
                    post_nms_test=8, nms_threshold=0.7, rpn_min_size=4,
                    pooled=(4, 4), fc=(128,), dropout=0.0, rpn_batch=None,
                    rpn_grad_scale=None),
    "vgg16": dict(image=(600, 1000), stride=16, scales=(8.0, 16.0, 32.0),
                  ratios=(0.5, 1.0, 2.0), num_classes=20, backbone="vgg16",
                  widths=(64, 128, 256, 512, 512), depths=(2, 2, 3, 3, 3),
                  rpn_conv=512, rois_per_img=128, fg_fraction=0.25,
                  pre_nms_train=12000, post_nms_train=2000,
                  pre_nms_test=6000, post_nms_test=300, nms_threshold=0.7,
                  rpn_min_size=16, pooled=(7, 7), fc=(4096, 4096),
                  dropout=0.5, rpn_batch=256, rpn_grad_scale=1.0 / 256),
}
#: the reference's config.FIXED_PARAMS for VGG16: held fixed in training
FIXED_PARAMS = ("conv1", "conv2")
DATA_NAMES = ("data", "im_info")
LABEL_NAMES = ("rpn_label", "rpn_bbox_target", "rpn_bbox_weight",
               "gt_boxes")


def num_anchors(cfg):
    return len(cfg["scales"]) * len(cfg["ratios"])


def feature_shape(cfg):
    """(height, width) of the feature map the RPN sees: the example's
    image over its stride; VGG16's after four 2x2 pools (floor)."""
    h, w = cfg["image"]
    if cfg["backbone"] == "example":
        return h // cfg["stride"], w // cfg["stride"]
    for _ in range(4):
        h, w = h // 2, w // 2
    return h, w


def all_anchors(cfg):
    """(A*H*W, 4) pixel anchors in label order a*H*W + y*W + x, the order
    rpn_cls_score reshaped to (2, A, H, W) flattens to."""
    base = _gen_anchors(cfg["stride"], cfg["scales"], cfg["ratios"])
    fh, fw = feature_shape(cfg)
    s = cfg["stride"]
    sy, sx = np.meshgrid(np.arange(fh) * s, np.arange(fw) * s,
                         indexing="ij")
    shifts = np.stack([sx, sy, sx, sy], axis=-1).astype(np.float32)
    out = base[:, None, None, :] + shifts[None]
    return out.reshape(-1, 4).astype(np.float32)


def _iou(boxes, gt):
    """boxes (K,4), gt (4,) -> (K,) IoU with the +1 width convention."""
    ix1 = np.maximum(boxes[:, 0], gt[0])
    iy1 = np.maximum(boxes[:, 1], gt[1])
    ix2 = np.minimum(boxes[:, 2], gt[2])
    iy2 = np.minimum(boxes[:, 3], gt[3])
    iw = np.maximum(ix2 - ix1 + 1, 0)
    ih = np.maximum(iy2 - iy1 + 1, 0)
    inter = iw * ih
    area = ((boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
            + (gt[2] - gt[0] + 1) * (gt[3] - gt[1] + 1) - inter)
    return inter / np.maximum(area, 1e-6)


def _bbox_transform(anchors, gt):
    """Encode gt (4,) against anchors (K,4) -> (K,4) [dx,dy,dw,dh]."""
    aw = anchors[:, 2] - anchors[:, 0] + 1
    ah = anchors[:, 3] - anchors[:, 1] + 1
    acx = anchors[:, 0] + 0.5 * (aw - 1)
    acy = anchors[:, 1] + 0.5 * (ah - 1)
    gw = gt[2] - gt[0] + 1
    gh = gt[3] - gt[1] + 1
    gcx = gt[0] + 0.5 * (gw - 1)
    gcy = gt[1] + 0.5 * (gh - 1)
    return np.stack([(gcx - acx) / aw, (gcy - acy) / ah,
                     np.log(gw / aw), np.log(gh / ah)], axis=-1)


def _bbox_decode(rois, deltas):
    """Decode stage-2 deltas (K,4) against roi boxes (K,4)."""
    w = rois[:, 2] - rois[:, 0] + 1
    h = rois[:, 3] - rois[:, 1] + 1
    cx = rois[:, 0] + 0.5 * (w - 1)
    cy = rois[:, 1] + 0.5 * (h - 1)
    pcx = deltas[:, 0] * w + cx
    pcy = deltas[:, 1] * h + cy
    pw = np.exp(deltas[:, 2]) * w
    ph = np.exp(deltas[:, 3]) * h
    return np.stack([pcx - 0.5 * (pw - 1), pcy - 0.5 * (ph - 1),
                     pcx + 0.5 * (pw - 1), pcy + 0.5 * (ph - 1)], axis=-1)


def make_batch(rng, n, cfg=None):
    """Returns data (N,3,H,W), im_info (N,3), rpn_label (N, A*h*w),
    rpn_bbox_target (N,4A,h,w), rpn_bbox_weight, gt_boxes (N,1,5) px.

    One box an image, painted in channel ``class % 3`` at 1 - 0.1 *
    (class // 3) over noise (the example's images and draws when its
    classes are the three channels)."""
    cfg = cfg or CONFIGS["example"]
    H, W = cfg["image"]
    fh, fw = feature_shape(cfg)
    A = num_anchors(cfg)
    anchors = all_anchors(cfg)
    x = rng.rand(n, 3, H, W).astype(np.float32) * 0.1
    gt = np.zeros((n, 1, 5), np.float32)
    lab = np.full((n, A * fh * fw), -1.0, np.float32)
    btgt = np.zeros((n, 4 * A, fh, fw), np.float32)
    bwt = np.zeros_like(btgt)
    for b in range(n):
        cls = rng.randint(0, cfg["num_classes"])
        cx, cy = rng.uniform(0.3, 0.7, 2) * np.array([W, H])
        half = rng.uniform(7.0, 12.0, 2) * np.array([W / 64, H / 64])
        x1, y1 = max(cx - half[0], 1), max(cy - half[1], 1)
        x2, y2 = min(cx + half[0], W - 2), min(cy + half[1], H - 2)
        x[b, cls % 3, int(y1):int(y2), int(x1):int(x2)] = \
            1.0 - 0.1 * (cls // 3)
        gt[b, 0] = [cls, x1, y1, x2, y2]
        ious = _iou(anchors, gt[b, 0, 1:])
        pos = ious > 0.5
        pos[np.argmax(ious)] = True
        neg = ious < 0.3
        if cfg["rpn_batch"] is None:
            # the example: ~3 negatives a positive, the rest ignored
            lab[b, pos] = 1.0
            neg_idx = np.where(neg & ~pos)[0]
            keep = rng.permutation(neg_idx)[:max(3 * int(pos.sum()), 6)]
            lab[b, keep] = 0.0
        else:  # at most half positives, negatives fill rpn_batch
            pos_idx = rng.permutation(np.where(pos)[0])
            pos_idx = pos_idx[:cfg["rpn_batch"] // 2]
            pos = np.zeros_like(pos)
            pos[pos_idx] = True
            lab[b, pos] = 1.0
            neg_idx = np.where(neg & ~pos)[0]
            keep = rng.permutation(neg_idx)[:cfg["rpn_batch"] - len(pos_idx)]
            lab[b, keep] = 0.0
        tgt = _bbox_transform(anchors, gt[b, 0, 1:])
        idx = np.where(pos)[0]
        a, rem = np.divmod(idx, fh * fw)
        fy, fx = np.divmod(rem, fw)
        view_t = btgt[b].reshape(A, 4, fh, fw)
        view_w = bwt[b].reshape(A, 4, fh, fw)
        view_t[a, :, fy, fx] = tgt[idx]
        view_w[a, :, fy, fx] = 1.0
    info = np.tile(np.array([H, W, 1.0], np.float32), (n, 1))
    return x, info, lab, btgt, bwt, gt


class ProposalTarget(operator.CustomOp):
    """Stage-2 target assignment (the reference's rcnn
    proposal_target.py): sample ``rois_per_img`` proposals an image (the
    ground-truth box joins the candidates so positives always exist), at
    most ``fg_fraction`` of them with IoU > 0.5, label each by IoU, and
    emit per-class box targets."""

    def __init__(self, num_classes, rois_per_img, fg_fraction):
        self.num_classes = num_classes
        self.rois_per_img = rois_per_img
        self.fg_fraction = fg_fraction

    def forward(self, is_train, req, in_data, out_data, aux):
        rois = in_data[0].asnumpy()        # (N*POST, 5)
        gts = in_data[1].asnumpy()         # (N, 1, 5)
        n = gts.shape[0]
        R = self.rois_per_img
        K1 = self.num_classes + 1
        n_fg = int(R * self.fg_fraction)
        out_rois = np.zeros((n * R, 5), np.float32)
        labels = np.zeros((n * R,), np.float32)
        btgt = np.zeros((n * R, 4 * K1), np.float32)
        bwt = np.zeros_like(btgt)
        per_img = rois.reshape(n, -1, 5)
        for b in range(n):
            cand = np.concatenate([per_img[b][:, 1:], gts[b, :, 1:]])
            ious = _iou(cand, gts[b, 0, 1:])
            order = np.argsort(-ious)
            fg = order[ious[order] > 0.5][:n_fg]
            bg = order[ious[order] <= 0.5][:R - len(fg)]
            pick = np.concatenate([fg, bg])
            if len(pick) < R:              # degenerate: repeat best
                pick = np.resize(pick, R)
            sel = cand[pick]
            out_rois[b * R:(b + 1) * R, 0] = b
            out_rois[b * R:(b + 1) * R, 1:] = sel
            cls = int(gts[b, 0, 0]) + 1
            is_fg = ious[pick] > 0.5
            labels[b * R:(b + 1) * R] = np.where(is_fg, cls, 0)
            tgt = _bbox_transform(sel, gts[b, 0, 1:])
            for i in np.where(is_fg)[0]:
                btgt[b * R + i, 4 * cls:4 * cls + 4] = tgt[i]
                bwt[b * R + i, 4 * cls:4 * cls + 4] = 1.0
        for i, arr in enumerate([out_rois, labels, btgt, bwt]):
            self.assign(out_data[i], req[i], arr)

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        for i in range(len(in_grad)):
            self.assign(in_grad[i], req[i],
                        np.zeros(in_grad[i].shape, np.float32))


@operator.register("proposal_target")
class ProposalTargetProp(operator.CustomOpProp):
    """Its kwargs (strings, as a custom op's are) default to the
    example's values."""

    def __init__(self, num_classes="3", rois_per_img="8",
                 fg_fraction="0.5"):
        super().__init__(need_top_grad=False)
        self.num_classes = int(num_classes)
        self.rois_per_img = int(rois_per_img)
        self.fg_fraction = float(fg_fraction)

    def list_arguments(self):
        return ["rois", "gt_boxes"]

    def list_outputs(self):
        return ["rois_out", "label", "bbox_target", "bbox_weight"]

    def infer_shape(self, in_shape):
        R = in_shape[1][0] * self.rois_per_img
        K1 = self.num_classes + 1
        return in_shape, [[R, 5], [R], [R, 4 * K1], [R, 4 * K1]], []

    def create_operator(self, ctx, shapes, dtypes):
        return ProposalTarget(self.num_classes, self.rois_per_img,
                              self.fg_fraction)


def _backbone(cfg, data):
    if cfg["backbone"] == "example":
        body = sym.Convolution(data, num_filter=16, kernel=(3, 3),
                               pad=(1, 1), name="conv1")
        body = sym.Activation(body, act_type="relu")
        body = sym.Pooling(body, kernel=(2, 2), stride=(2, 2),
                           pool_type="max")
        body = sym.Convolution(body, num_filter=32, kernel=(3, 3),
                               pad=(1, 1), name="conv2")
        body = sym.Activation(body, act_type="relu")
        body = sym.Pooling(body, kernel=(2, 2), stride=(2, 2),
                           pool_type="max")
        body = sym.Convolution(body, num_filter=32, kernel=(3, 3),
                               pad=(1, 1), stride=(2, 2), name="conv3")
        return sym.Activation(body, act_type="relu")
    body = data
    for i, (width, depth) in enumerate(zip(cfg["widths"], cfg["depths"])):
        for j in range(depth):
            body = sym.Convolution(body, num_filter=width, kernel=(3, 3),
                                   pad=(1, 1),
                                   name="conv%d_%d" % (i + 1, j + 1))
            body = sym.Activation(body, act_type="relu",
                                  name="relu%d_%d" % (i + 1, j + 1))
        if i < 4:  # no pool5: conv5_3 is the shared map, stride 16
            body = sym.Pooling(body, kernel=(2, 2), stride=(2, 2),
                               pool_type="max", name="pool%d" % (i + 1))
    return body


def _rpn_heads(cfg, feat):
    A = num_anchors(cfg)
    name = "rpn_conv" if cfg["backbone"] == "example" else "rpn_conv_3x3"
    rpn = sym.Convolution(feat, num_filter=cfg["rpn_conv"], kernel=(3, 3),
                          pad=(1, 1), name=name)
    rpn = sym.Activation(rpn, act_type="relu")
    score = sym.Convolution(rpn, num_filter=2 * A, kernel=(1, 1),
                            name="rpn_cls_score")
    bbox = sym.Convolution(rpn, num_filter=4 * A, kernel=(1, 1),
                           name="rpn_bbox_pred")
    return score, bbox


def _proposal_rois(cfg, score, bbox, im_info, train):
    """softmax the RPN scores and run Proposal (MultiProposal over the
    batch) on grad-blocked inputs."""
    A = num_anchors(cfg)
    fh, fw = feature_shape(cfg)
    prob = sym.Reshape(score, shape=(0, 2, -1))
    prob = sym.softmax(prob, axis=1)
    prob = sym.Reshape(prob, shape=(0, 2 * A, fh, fw))
    pre = cfg["pre_nms_train" if train else "pre_nms_test"] or A * fh * fw
    post = cfg["post_nms_train" if train else "post_nms_test"]
    return sym.contrib.Proposal(
        sym.BlockGrad(prob), sym.BlockGrad(bbox), im_info,
        feature_stride=cfg["stride"], scales=cfg["scales"],
        ratios=cfg["ratios"], rpn_pre_nms_top_n=pre,
        rpn_post_nms_top_n=post, threshold=cfg["nms_threshold"],
        rpn_min_size=cfg["rpn_min_size"])


def _stage2_heads(cfg, feat, rois):
    pooled = sym.ROIPooling(feat, rois, pooled_size=cfg["pooled"],
                            spatial_scale=1.0 / cfg["stride"])
    body = sym.Flatten(pooled)
    for i, width in enumerate(cfg["fc"]):
        body = sym.FullyConnected(body, num_hidden=width,
                                  name="fc%d" % (i + 6))
        body = sym.Activation(body, act_type="relu")
        if cfg["dropout"]:
            body = sym.Dropout(body, p=cfg["dropout"])
    K1 = cfg["num_classes"] + 1
    cls_score = sym.FullyConnected(body, num_hidden=K1, name="cls_score")
    bbox_pred = sym.FullyConnected(body, num_hidden=4 * K1,
                                   name="bbox_pred")
    return cls_score, bbox_pred


def build_train_symbol(cfg=None):
    """Group([rpn_cls_prob, rpn_bbox_loss, cls_prob, bbox_loss])."""
    cfg = cfg or CONFIGS["example"]
    A = num_anchors(cfg)
    fh, fw = feature_shape(cfg)
    data = sym.Variable("data")
    im_info = sym.Variable("im_info")
    rpn_label = sym.Variable("rpn_label")
    rpn_bbox_target = sym.Variable("rpn_bbox_target")
    rpn_bbox_weight = sym.Variable("rpn_bbox_weight")
    gt_boxes = sym.Variable("gt_boxes")

    feat = _backbone(cfg, data)
    score, bbox = _rpn_heads(cfg, feat)

    score_2 = sym.Reshape(score, shape=(0, 2, -1))
    rpn_cls_loss = sym.SoftmaxOutput(
        score_2, rpn_label, multi_output=True, use_ignore=True,
        ignore_label=-1, normalization="valid", name="rpn_cls_prob")
    rpn_bbox_loss = sym.MakeLoss(
        sym.sum(sym.smooth_l1(rpn_bbox_weight * (bbox - rpn_bbox_target),
                              scalar=3.0)),
        grad_scale=cfg["rpn_grad_scale"] or 1.0 / (A * fh * fw),
        name="rpn_bbox_loss")

    rois = _proposal_rois(cfg, score, bbox, im_info, train=True)
    group = sym.Custom(rois, gt_boxes, op_type="proposal_target",
                       num_classes=cfg["num_classes"],
                       rois_per_img=cfg["rois_per_img"],
                       fg_fraction=cfg["fg_fraction"])
    rois_out, s2_label, s2_tgt, s2_wt = (group[0], group[1], group[2],
                                         group[3])

    cls_score, bbox_pred = _stage2_heads(cfg, feat, rois_out)
    cls_loss = sym.SoftmaxOutput(cls_score, s2_label,
                                 normalization="batch", name="cls_prob")
    bbox_loss = sym.MakeLoss(
        sym.sum(sym.smooth_l1(s2_wt * (bbox_pred - s2_tgt), scalar=1.0)),
        grad_scale=1.0 / cfg["rois_per_img"], name="bbox_loss")
    return sym.Group([rpn_cls_loss, rpn_bbox_loss, cls_loss, bbox_loss])


def build_test_symbol(cfg=None):
    """Group([rois, cls_prob, bbox_pred])."""
    cfg = cfg or CONFIGS["example"]
    data = sym.Variable("data")
    im_info = sym.Variable("im_info")
    feat = _backbone(cfg, data)
    score, bbox = _rpn_heads(cfg, feat)
    rois = _proposal_rois(cfg, score, bbox, im_info, train=False)
    cls_score, bbox_pred = _stage2_heads(cfg, feat, rois)
    cls_prob = sym.softmax(cls_score, axis=-1)
    return sym.Group([rois, cls_prob, bbox_pred])


def data_shapes(cfg, n):
    H, W = cfg["image"]
    return [("data", (n, 3, H, W)), ("im_info", (n, 3))]


def label_shapes(cfg, n):
    A = num_anchors(cfg)
    fh, fw = feature_shape(cfg)
    return [("rpn_label", (n, A * fh * fw)),
            ("rpn_bbox_target", (n, 4 * A, fh, fw)),
            ("rpn_bbox_weight", (n, 4 * A, fh, fw)),
            ("gt_boxes", (n, 1, 5))]


def fixed_params(cfg, symbol):
    """The arguments held fixed in training: VGG16's conv1_* and conv2_*
    (the reference's FIXED_PARAMS); none for the example."""
    if cfg["backbone"] == "example":
        return []
    return [n for n in symbol.list_arguments()
            if n.split("_")[0] in FIXED_PARAMS]


def batch_of(arrays, ctx=None):
    """A DataBatch of ``make_batch``'s arrays (data, im_info, then the
    four labels)."""
    x, info, lab, btgt, bwt, gt = arrays
    return io.DataBatch(
        data=[nd.array(x, ctx=ctx), nd.array(info, ctx=ctx)],
        label=[nd.array(v, ctx=ctx) for v in (lab, btgt, bwt, gt)],
        pad=0, index=None)


def evaluate(mod, rng, batches, batch_size, cfg=None):
    """Top-1 detection accuracy: the best-scored foreground ROI of each
    image must carry the right class and IoU > 0.5 after its box
    decode."""
    cfg = cfg or CONFIGS["example"]
    correct = total = 0
    R = cfg["post_nms_test"]
    K = cfg["num_classes"]
    for _ in range(batches):
        x, info, _, _, _, gt = make_batch(rng, batch_size, cfg)
        mod.forward(io.DataBatch(data=[nd.array(x), nd.array(info)],
                                 label=[], pad=0, index=None),
                    is_train=False)
        rois, prob, deltas = [o.asnumpy() for o in mod.get_outputs()]
        for b in range(batch_size):
            p = prob[b * R:(b + 1) * R]
            flat = np.argmax(p[:, 1:])
            ri, cls = divmod(int(flat), K)
            roi = rois[b * R + ri, 1:]
            d = deltas[b * R + ri, 4 * (cls + 1):4 * (cls + 2)]
            box = _bbox_decode(roi[None, :], d[None, :])[0]
            ok = (cls == int(gt[b, 0, 0]) and
                  _iou(box[None, :], gt[b, 0, 1:])[0] > 0.5)
            correct += int(ok)
            total += 1
    return correct / max(total, 1)
