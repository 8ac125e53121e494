"""The SSD example's data and metrics, for the port's tests and
``chip_smoke.py``.

The port's copy of ``examples/ssd/_synth.py`` (``make_batch``,
``SynthDetIter``: painted synthetic boxes, since VOC is not in the
repository), of ``examples/ssd/train.py:18-52`` (``MultiBoxMetric``,
the training metric pair) and of ``examples/ssd/evaluate.py:17-103``
(``MApMetric``, VOC-style mean average precision). Those files import
``mxtpu`` and cannot be imported by the port. The data and the metrics
are numpy on the host, as there; batches are cpu() NDArrays, as the
port's iterators assemble them (``io.py``). ``gate_twin`` runs
``tests/test_examples_gate.py::test_ssd_gate``'s train-then-evaluate
through the port on a given context, ``mining_margin`` measures how
near a hard-negative cut came to a tie, and ``nms_sets`` makes the
candidate sets that hold the suppression kernel to its plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import io
from .. import metric
from .. import ndarray as nd
from ..context import cpu

__all__ = ["make_batch", "SynthDetIter", "MultiBoxMetric", "MApMetric",
           "mining_margin", "gate_twin", "nms_sets"]


def make_batch(rng, batch_size, shape, num_classes, max_objs=8):
    """Returns (data (B, C, H, W), label (B, max_objs, 5)) numpy arrays:
    each image carries one bright rectangle whose class is its colour
    channel; label rows are [cls, x1, y1, x2, y2] in relative
    coordinates, unused rows -1."""
    c, h, w = shape
    x = rng.rand(batch_size, c, h, w).astype("float32") * 0.1
    lab = np.full((batch_size, max_objs, 5), -1.0, "float32")
    for b in range(batch_size):
        cls = rng.randint(0, min(num_classes, c))
        cx, cy = rng.uniform(0.35, 0.65, 2)
        # half-extents sized to the default anchor spec (sizes 0.1-0.45),
        # so matching clears the 0.5 IoU threshold and positives exist
        bw, bh = rng.uniform(0.1, 0.2, 2)
        x1, y1 = max(cx - bw, 0.02), max(cy - bh, 0.02)
        x2, y2 = min(cx + bw, 0.98), min(cy + bh, 0.98)
        # paint the object: bright block in its class channel
        x[b, cls % c, int(y1 * h):int(y2 * h), int(x1 * w):int(x2 * w)] = 1.0
        lab[b, 0] = [cls, x1, y1, x2, y2]
    return x, lab


class SynthDetIter(io.DataIter):
    """Fixed-size epoch of deterministic synthetic detection batches."""

    def __init__(self, batch_size, shape, num_classes, num_batches=4,
                 seed=0, max_objs=8):
        super().__init__(batch_size)
        self._shape = shape
        self._classes = num_classes
        self._num = num_batches
        self._seed = seed
        self._max_objs = max_objs
        self._i = 0
        self.provide_data = [io.DataDesc("data",
                                         (batch_size,) + tuple(shape))]
        self.provide_label = [io.DataDesc("label",
                                          (batch_size, max_objs, 5))]

    def reset(self):
        self._i = 0

    def next(self):
        if self._i >= self._num:
            raise StopIteration
        rng = np.random.RandomState(self._seed * 1000 + self._i)
        self._i += 1
        x, lab = make_batch(rng, self.batch_size, self._shape,
                            self._classes, self._max_objs)
        return io.DataBatch(
            data=[nd.array(x, ctx=cpu())], label=[nd.array(lab, ctx=cpu())],
            pad=0, index=None, provide_data=self.provide_data,
            provide_label=self.provide_label)


class MultiBoxMetric(metric.EvalMetric):
    """Train-time metric pair: cross-entropy over the anchors the target
    does not ignore, and the smooth-L1 location loss a positive anchor."""

    def __init__(self):
        super().__init__("MultiBox")
        self.num = 2
        self.name = ["CrossEntropy", "SmoothL1"]
        self.reset()

    def reset(self):
        self.num_inst = [0, 0]
        self.sum_metric = [0.0, 0.0]

    def update(self, labels, preds):
        cls_prob = preds[0].asnumpy()
        loc_loss = preds[1].asnumpy()
        cls_label = preds[2].asnumpy()
        valid = cls_label >= 0
        label = cls_label[valid].astype(int)
        flat = np.moveaxis(cls_prob, 1, -1).reshape(-1, cls_prob.shape[1])
        prob = flat[valid.reshape(-1)][np.arange(label.size), label]
        self.sum_metric[0] += (-np.log(np.maximum(prob, 1e-12))).sum()
        self.num_inst[0] += label.size
        self.sum_metric[1] += np.abs(loc_loss).sum()
        self.num_inst[1] += max((cls_label > 0).sum(), 1)

    def get(self):
        return (self.name,
                [s / max(n, 1) for s, n in zip(self.sum_metric,
                                               self.num_inst)])

    def get_name_value(self):
        names, values = self.get()
        return list(zip(names, values))


class MApMetric(metric.EvalMetric):
    """VOC mean average precision over detections (N, num_det, 6) rows
    [cls, score, x1, y1, x2, y2] (cls < 0: none) against labels
    (N, num_obj, >= 5) rows [cls, x1, y1, x2, y2] (cls < 0: none)."""

    def __init__(self, ovp_thresh=0.5, use_difficult=False, class_names=None,
                 pred_idx=0):
        self.ovp_thresh = ovp_thresh
        self.use_difficult = use_difficult
        self.class_names = class_names
        self.pred_idx = int(pred_idx)
        super().__init__("mAP")
        self.reset()

    def reset(self):
        # per-class list of (score, tp) plus gt counts
        self.records = {}
        self.gt_counts = {}
        self.num_inst = 0
        self.sum_metric = 0.0

    @staticmethod
    def _iou(box, boxes):
        ix1 = np.maximum(box[0], boxes[:, 0])
        iy1 = np.maximum(box[1], boxes[:, 1])
        ix2 = np.minimum(box[2], boxes[:, 2])
        iy2 = np.minimum(box[3], boxes[:, 3])
        iw = np.maximum(ix2 - ix1, 0)
        ih = np.maximum(iy2 - iy1, 0)
        inter = iw * ih
        a1 = (box[2] - box[0]) * (box[3] - box[1])
        a2 = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        union = a1 + a2 - inter
        return inter / np.maximum(union, 1e-12)

    def update(self, labels, preds):
        det = preds[self.pred_idx].asnumpy()
        lab = labels[0].asnumpy()
        for i in range(det.shape[0]):
            d = det[i]
            d = d[d[:, 0] >= 0]
            g = lab[i]
            g = g[g[:, 0] >= 0]
            for cls in np.unique(np.concatenate([d[:, 0], g[:, 0]])):
                cls = int(cls)
                dc = d[d[:, 0] == cls]
                gc = g[g[:, 0] == cls][:, 1:5]
                self.gt_counts[cls] = self.gt_counts.get(cls, 0) + len(gc)
                taken = np.zeros(len(gc), bool)
                order = np.argsort(-dc[:, 1])
                for j in order:
                    box = dc[j, 2:6]
                    if len(gc):
                        ious = self._iou(box, gc)
                        best = int(np.argmax(ious))
                        if ious[best] >= self.ovp_thresh and not taken[best]:
                            taken[best] = True
                            self.records.setdefault(cls, []).append(
                                (dc[j, 1], 1))
                            continue
                    self.records.setdefault(cls, []).append((dc[j, 1], 0))

    def get(self):
        aps = []
        for cls, count in self.gt_counts.items():
            if count == 0:
                continue
            recs = sorted(self.records.get(cls, []), reverse=True)
            if not recs:
                aps.append(0.0)
                continue
            tps = np.cumsum([r[1] for r in recs])
            fps = np.cumsum([1 - r[1] for r in recs])
            recall = tps / count
            precision = tps / np.maximum(tps + fps, 1e-12)
            # VOC-style interpolated AP (all points)
            ap = 0.0
            prev_r = 0.0
            for r, p in zip(recall, precision):
                ap += (r - prev_r) * np.max(
                    precision[recall >= r]) if r > prev_r else 0.0
                prev_r = r
            aps.append(ap)
        return "mAP", float(np.mean(aps)) if aps else 0.0


def mining_margin(anchors, label, cls_pred, cls_target, thresh=0.5):
    """How far the hard-negative cut of ``MultiBoxTarget`` was from a tie:
    over the batch, the least of (the lowest hardness among the eligible
    negatives kept) minus (the highest among the eligible ones dropped),
    hardness being the largest non-background logit of ``cls_pred`` (B,
    C+1, A) and eligible meaning no ground-truth box of ``label`` (B, G,
    5) overlaps the anchor at ``thresh``. inf where nothing eligible was
    dropped. Two runs whose logits differ by less than this keep the same
    negatives."""
    from ..ops.contrib import _box_iou_corner
    valid = label[:, :, 0] >= 0
    iou = _box_iou_corner(anchors[0], label[:, :, 1:5])
    iou = torch.where(valid.unsqueeze(1), iou, torch.full_like(iou, -1.0))
    eligible = (torch.amax(iou, dim=2) < thresh) & (cls_target <= 0)
    hard = torch.amax(cls_pred[:, 1:, :], dim=1).double()
    kept = eligible & (cls_target == 0)
    dropped = eligible & (cls_target < 0)
    inf = torch.full_like(hard, float("inf"))
    low = torch.where(kept, hard, inf).amin(dim=1)
    high = torch.where(dropped, hard, -inf).amax(dim=1)
    return float((low - high).min())


def _evaluate(mt, ctx, net, it, params=None):
    """examples/ssd/evaluate.py's loop: mAP of ``net``'s detections over
    ``it``, with ``params`` (arg params) or fresh default ones."""
    mod = mt.mod.Module(net, label_names=("label",), context=ctx)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
             for_training=False)
    if params is None:
        mod.init_params()
    else:
        mod.set_params(params, {}, allow_missing=True)
    m = MApMetric()
    for batch in it:
        mod.forward(batch, is_train=False)
        m.update(batch.label, mod.get_outputs())
    return m.get()[1]


def gate_twin(mt, ctx, prefix, batches=8, epochs=12, seed=2,
              arg_params=None):
    """``tests/test_examples_gate.py::test_ssd_gate`` on the port, on
    ``ctx``: the tiny net at 64x64 with 3 classes and 3 scales, mAP of the
    untrained net on 2 batches (seed 77), then examples/ssd/train.py's fit
    (B=8, SGD lr 0.05, momentum 0.9, wd 5e-4, Xavier, ``batches`` x
    ``epochs``, a checkpoint at ``prefix`` each epoch), then the mAP of
    the last checkpoint. ``arg_params`` (``{name: NDArray}``) replaces
    the Xavier draw. Returns the figures and whether the checkpoint
    reloads bit for bit."""
    from . import ssd
    common = dict(num_classes=3, num_scales=3, network="tiny")
    shape = (3, 64, 64)

    def held_out():
        return SynthDetIter(8, shape, 3, num_batches=2, seed=77)

    map_untrained = _evaluate(mt, ctx, ssd.get_symbol(**common), held_out())
    mt.random.seed(seed)
    np.random.seed(seed)
    train_metric = MultiBoxMetric()
    mod = mt.mod.Module(ssd.get_symbol_train(**common),
                        label_names=("label",), context=ctx)
    mod.fit(SynthDetIter(8, shape, 3, num_batches=batches, seed=0),
            num_epoch=epochs, eval_metric=train_metric, optimizer="sgd",
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9,
                              "wd": 5e-4},
            initializer=mt.initializer.Xavier(), arg_params=arg_params,
            epoch_end_callback=mt.callback.do_checkpoint(prefix))
    _, args, _ = mt.model.load_checkpoint(prefix, epochs)
    live = mod.get_params()[0]
    reload_ok = sorted(args) == sorted(live) and all(
        np.array_equal(args[k].asnumpy(), live[k].asnumpy()) for k in live)
    map_trained = _evaluate(mt, ctx, ssd.get_symbol(**common), held_out(),
                            args)
    names = dict(train_metric.get_name_value())
    return {"cross_entropy": names["CrossEntropy"],
            "smooth_l1": names["SmoothL1"], "map_untrained": map_untrained,
            "map_trained": map_trained, "reload_bit_exact": reload_ok}


def nms_sets(batch=32, k=400, seed=0):
    """Named candidate sets for the suppression sweep, as numpy float32
    ``(name, boxes (B, K, 4), scores (B, K), class ids (B, K), thresh,
    force_suppress)``, scores in descending order: random boxes of 3
    classes; one class with every box overlapping; pairs whose IoU is
    exactly the threshold or one step either side of it (dyadic
    heights, so the quotient is exact); -inf tails; force_suppress
    across classes; NaN coordinates; K = 37, 1,376 (``nms_topk`` -1 on
    the tiny net's anchors) and 1; and -inf and NaN scores between live
    ones, a whole 64-candidate tile of them included, which holds the
    kernel's bound on the live count to the alive test."""
    rng = np.random.RandomState(seed)

    def boxes(b, n, lo=0.02, hi=0.45):
        c = rng.uniform(0.1, 0.9, (b, n, 2))
        half = rng.uniform(lo, hi, (b, n, 2)) / 2
        return np.concatenate([c - half, c + half], -1).astype(np.float32)

    def scores(b, n):
        return -np.sort(-rng.rand(b, n), axis=1).astype(np.float32)

    def classes(b, n, c=3):
        return rng.randint(0, c, (b, n)).astype(np.float32)

    B, K = batch, k
    out = [("random", boxes(B, K), scores(B, K), classes(B, K), 0.5,
            False)]
    stack = np.broadcast_to(np.float32([0.2, 0.2, 0.6, 0.6]), (B, K, 4)) \
        + rng.rand(B, K, 4).astype(np.float32) * 0.04
    out.append(("one_class_overlapping", stack.astype(np.float32),
                scores(B, K), np.zeros((B, K), np.float32), 0.5, False))
    # [0, 0, 1, 1] beside [0, 0, 1, h]: IoU h, exact for dyadic h
    at = np.zeros((B, K, 4), np.float32)
    at[..., 2:] = 1.0
    h = np.float32([0.5, 0.5 + 2.0 ** -12, 0.5 - 2.0 ** -12, 1.0])
    at[..., 3] = h[rng.randint(0, 4, (B, K))]
    out.append(("at_threshold", at, scores(B, K),
                np.zeros((B, K), np.float32), 0.5, False))
    tail = scores(B, K)
    tail[:, int(K * 0.4):] = -np.inf
    out.append(("inf_tails", boxes(B, K), tail, classes(B, K), 0.45, False))
    out.append(("force_suppress", boxes(B, K), scores(B, K), classes(B, K),
                0.3, True))
    nan = boxes(B, K)
    nan[rng.rand(B, K, 4) < 0.01] = np.nan
    out.append(("nan_boxes", nan, scores(B, K), classes(B, K), 0.5, False))
    for n in (37, 1376, 1):
        out.append(("k%d" % n, boxes(B, n), scores(B, n), classes(B, n),
                    0.5, False))
    gaps = scores(B, K)
    dead = rng.rand(B, K)
    gaps[dead < 0.1] = -np.inf
    gaps[(dead >= 0.1) & (dead < 0.15)] = np.nan
    gaps[:, 64:128] = -np.inf
    out.append(("dead_between_live", boxes(B, K), gaps, classes(B, K), 0.5,
                False))
    return out
