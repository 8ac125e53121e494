"""Contrib operators of the SSD detector: the MultiBox trio and the
suppression sweep.

Counterpart of ``mxtpu/ops/contrib.py:1-292``: ``_box_iou_corner``
(:23), ``_contrib_MultiBoxPrior`` (:43-86: anchors, a pure function of
the feature map's shape), ``_contrib_MultiBoxTarget`` (:109-195: IoU
matching, the forced match of each ground-truth box's best anchor,
hard-negative mining and the location encoding) and
``_contrib_MultiBoxDetection`` (:237-284: decoding, the score sort, the
``nms_topk`` cut and the suppression sweep), each with its alias, arg
names and attr defaults. mxtpu vmaps each op over the batch; here the
batch is a dimension written out. The quantize, fft, CTC and
count_sketch ops of that module are ported with the rest of the op
library.

The sweep (``_nms_scan`` :214, an XLA ``lax.scan`` over the
score-sorted candidates) is ``nms_keep``: a hand-written CUDA kernel for
a CUDA tensor (``csrc/multibox_nms.cu``, one block an image) and
``nms_keep_reference``, a loop over the candidates vectorised over the
batch, for a CPU tensor. Nothing falls back: on the card the kernel runs
or the call raises. ``nms_keep.launches`` counts kernel launches.

The three ops are not differentiable (mxtpu's gradient sweep lists them
so, ``tests/test_op_gradient_sweep.py:290-292``): their inputs are
detached, and on meta tensors (shape inference) they return empty
outputs of the right shapes. Every sort is stable, as ``jnp.argsort``
is: ties (the candidates under the threshold at -inf, the anchors
ineligible as negatives at +inf) keep their index order.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as _np
import torch

from ..base import MXNetError
from .registry import register, set_replicas

__all__ = ["nms_keep", "nms_keep_reference", "nms_smem_bytes", "NMS_MAX_K",
           "NMS_MAX_SMEM", "detection_candidates"]

KERNEL = "multibox_nms"
# the kernel's bounds: alive words in two registers a lane (K <= 2048)
# and its shared memory within an H100 block's opt-in 227 KB
NMS_MAX_K = 2048
NMS_MAX_SMEM = 232448


# ------------------------------------------------------------------ box utils
def _box_iou_corner(a, b):
    """IoU between corner boxes, batched: a (..., A, 4), b (..., G, 4)
    -> (..., A, G), in mxtpu's order of operations (``max(., 0)``
    extents, ``area_a + area_b - inter``, ``inter / union`` where the
    union is positive, else 0)."""
    ax1, ay1, ax2, ay2 = [v.unsqueeze(-1) for v in a.unbind(-1)]
    bx1, by1, bx2, by2 = [v.unsqueeze(-2) for v in b.unbind(-1)]
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp(min=0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp(min=0)
    inter = iw * ih
    area_a = (ax2 - ax1).clamp(min=0) * (ay2 - ay1).clamp(min=0)
    area_b = (bx2 - bx1).clamp(min=0) * (by2 - by1).clamp(min=0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def _corners(anchors):
    """(width, height, centre x, centre y) of corner boxes (..., 4)."""
    x1, y1, x2, y2 = anchors.unbind(-1)
    return x2 - x1, y2 - y1, (x1 + x2) / 2, (y1 + y2) / 2


def _encode_loc(anchors, gt, variances):
    """Corner anchors (A, 4) and matched boxes (..., A, 4) -> location
    targets (..., A, 4) (mxtpu/ops/contrib.py:89)."""
    aw, ah, acx, acy = _corners(anchors)
    gw = (gt[..., 2] - gt[..., 0]).clamp(min=1e-8)
    gh = (gt[..., 3] - gt[..., 1]).clamp(min=1e-8)
    gcx = (gt[..., 0] + gt[..., 2]) / 2
    gcy = (gt[..., 1] + gt[..., 3]) / 2
    v0, v1, v2, v3 = [float(v) for v in variances]
    aw, ah = aw.clamp(min=1e-8), ah.clamp(min=1e-8)
    tx = (gcx - acx) / aw / v0
    ty = (gcy - acy) / ah / v1
    tw = torch.log(gw / aw) / v2
    th = torch.log(gh / ah) / v3
    return torch.stack([tx, ty, tw, th], dim=-1)


def _decode_loc(anchors, loc, variances):
    """Anchors (A, 4) and offsets (..., A, 4) -> corner boxes
    (mxtpu/ops/contrib.py:200)."""
    v0, v1, v2, v3 = [float(v) for v in variances]
    aw, ah, acx, acy = _corners(anchors)
    cx = loc[..., 0] * v0 * aw + acx
    cy = loc[..., 1] * v1 * ah + acy
    w = torch.exp(loc[..., 2] * v2) * aw / 2
    h = torch.exp(loc[..., 3] * v3) * ah / 2
    return torch.stack([cx - w, cy - h, cx + w, cy + h], dim=-1)


# ------------------------------------------------------------ MultiBoxPrior
def _multibox_prior(a, data):
    """Anchor boxes of one feature map ``data`` (N, C, H, W): (1,
    H*W*K, 4) corners with K = len(sizes) + len(ratios) - 1, bit for bit
    mxtpu's: half-extents ``s*sqrt(r)/2`` in float64 rounded to f32,
    centres ``(arange + offset) * step`` in f32."""
    _, _, H, W = data.shape
    sizes = [float(s) for s in a.sizes]
    ratios = [float(r) for r in a.ratios]
    if data.device.type == "meta":
        return torch.empty(1, H * W * (len(sizes) + len(ratios) - 1), 4,
                           device="meta")
    steps, offsets = a.steps, a.offsets
    step_y = float(steps[0]) if steps and float(steps[0]) > 0 else 1.0 / H
    step_x = float(steps[1]) if steps and float(steps[1]) > 0 else 1.0 / W
    dev, f32 = data.device, torch.float32

    def centres(n, off, step):
        return (torch.arange(n, dtype=f32, device=dev)
                + torch.tensor(off, dtype=f32, device=dev)) \
            * torch.tensor(step, dtype=f32, device=dev)

    cy, cx = centres(H, float(offsets[0]), step_y), \
        centres(W, float(offsets[1]), step_x)
    wh = [(s * _np.sqrt(ratios[0]) / 2, s / _np.sqrt(ratios[0]) / 2)
          for s in sizes]
    wh += [(sizes[0] * _np.sqrt(r) / 2, sizes[0] / _np.sqrt(r) / 2)
           for r in ratios[1:]]
    wh = torch.tensor(_np.asarray(wh, _np.float32), device=dev)  # (K, 2)
    cxg = cx.reshape(1, W, 1).expand(H, W, 1)
    cyg = cy.reshape(H, 1, 1).expand(H, W, 1)
    hw, hh = wh[:, 0], wh[:, 1]
    boxes = torch.stack([cxg - hw, cyg - hh, cxg + hw, cyg + hh], dim=-1)
    boxes = boxes.reshape(1, -1, 4)
    return boxes.clamp(0.0, 1.0) if a.clip else boxes


register("_contrib_MultiBoxPrior", _multibox_prior,
         attrs={"sizes": (1.0,), "ratios": (1.0,), "clip": False,
                "steps": (-1.0, -1.0), "offsets": (0.5, 0.5)},
         aliases=("MultiBoxPrior",))


# ------------------------------------------------------------ MultiBoxTarget
def _stable_rank(key):
    """Each element's place in the stable ascending order of ``key``
    along the last axis."""
    order = torch.sort(key, dim=-1, stable=True).indices
    pos = torch.arange(key.shape[-1], device=key.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, pos)


def _multibox_target(a, anchor, label, cls_pred):
    """anchor (1, A, 4), label (B, G, 5) rows [cls, x1, y1, x2, y2]
    (cls -1: padding), cls_pred (B, C+1, A) -> loc_target (B, A*4),
    loc_target_mask (B, A*4), cls_target (B, A)."""
    B, A = label.shape[0], anchor.shape[1]
    if anchor.device.type == "meta":
        return (torch.empty(B, A * 4, dtype=anchor.dtype, device="meta"),
                torch.empty(B, A * 4, dtype=anchor.dtype, device="meta"),
                torch.empty(B, A, dtype=anchor.dtype, device="meta"))
    anchors, label, cls_pred = anchor[0].detach(), label.detach(), \
        cls_pred.detach()
    G = label.shape[1]
    valid_gt = label[:, :, 0] >= 0  # (B, G)
    iou = _box_iou_corner(anchors, label[:, :, 1:5])  # (B, A, G)
    iou = torch.where(valid_gt.unsqueeze(1), iou, torch.full_like(iou, -1.0))
    best_anchor_per_gt = torch.argmax(iou, dim=1)  # (B, G), first max
    best_iou = torch.amax(iou, dim=2)  # (B, A)
    best_gt = torch.argmax(iou, dim=2)
    matched = best_iou > float(a.overlap_threshold)
    # each valid box claims its best anchor; where two claim one, the
    # later box wins (mxtpu's fori_loop): the largest valid g an anchor
    g_ids = torch.arange(G, device=label.device).expand(B, G)
    claim = torch.full((B, A), -1, dtype=torch.int64, device=label.device)
    claim.scatter_reduce_(1, best_anchor_per_gt,
                          torch.where(valid_gt, g_ids, -1), "amax")
    forced = claim >= 0
    matched = matched | forced
    match_gt = torch.where(forced, claim, best_gt)

    gt_cls = label[:, :, 0].to(torch.int32)
    cls_target = torch.where(matched, torch.gather(gt_cls, 1, match_gt) + 1,
                             0)
    ratio = float(a.negative_mining_ratio)
    if ratio > 0:
        num_pos = matched.sum(dim=1, keepdim=True).to(torch.float32)
        max_neg = torch.clamp(ratio * num_pos,
                              min=float(int(a.minimum_negative_samples)))
        # hardness: the largest non-background score; anchors matched or
        # overlapping a box at negative_mining_thresh are ineligible and
        # rank last, in index order
        neg_score = torch.amax(cls_pred[:, 1:, :], dim=1)  # (B, A)
        ineligible = matched | (best_iou >= float(a.negative_mining_thresh))
        neg_score = torch.where(ineligible, float("-inf"), neg_score)
        rank = _stable_rank(-neg_score)
        keep_neg = ~matched & (rank.to(torch.float32) < max_neg)
        ignore = ~matched & ~keep_neg
        cls_target = torch.where(ignore, int(a.ignore_label), cls_target)

    idx = match_gt.unsqueeze(-1).expand(B, A, 4)
    gt_boxes = torch.gather(label[:, :, 1:5], 1, idx)  # (B, A, 4)
    loc_t = _encode_loc(anchors, gt_boxes, a.variances)
    m = matched.unsqueeze(-1)
    loc_t = torch.where(m, loc_t, torch.zeros_like(loc_t))
    loc_mask = m.to(anchors.dtype).expand(B, A, 4)
    return (loc_t.reshape(B, -1), loc_mask.reshape(B, -1),
            cls_target.to(anchors.dtype))


register("_contrib_MultiBoxTarget", _multibox_target,
         arg_names=["anchor", "label", "cls_pred"],
         attrs={"overlap_threshold": 0.5, "ignore_label": -1.0,
                "negative_mining_ratio": -1.0,
                "negative_mining_thresh": 0.5,
                "minimum_negative_samples": 0,
                "variances": (0.1, 0.1, 0.2, 0.2)},
         num_outputs=3, aliases=("MultiBoxTarget",))


# ------------------------------------------------------------- suppression
def nms_keep_reference(boxes, scores, cls_id, thresh, force_suppress):
    """Plain version of the sweep (mxtpu/ops/contrib.py:214
    ``_nms_scan``), vectorised over the batch: boxes (B, K, 4), scores
    and class ids (B, K), sorted by score. Candidate i is kept when it is
    alive at its turn (alive at the start: score > -inf); a kept i clears
    every later j of its class (any class under ``force_suppress``) with
    IoU(i, j) > ``thresh``. Returns the keep mask (B, K), bool."""
    K = boxes.shape[1]
    iou = _box_iou_corner(boxes, boxes)  # (B, K, K)
    same = (cls_id.unsqueeze(2) == cls_id.unsqueeze(1)) | bool(force_suppress)
    later = torch.ones(K, K, dtype=torch.bool, device=boxes.device).triu(1)
    suppress = (iou > thresh) & same & later
    alive = scores > float("-inf")
    for i in range(K):
        alive = alive & ~(suppress[:, i, :] & alive[:, i:i + 1])
    return alive  # a kept candidate stays alive; a cleared one was not kept


def nms_smem_bytes(k):
    """Shared memory of the kernel at ``k`` candidates: the boxes and
    class ids, then the upper triangle of the "i clears j" bit matrix (row
    i keeps the words from i's own on: ``W - i//32`` of ``W = ceil(k/32)``),
    then the alive words."""
    w = (k + 31) // 32
    tri = sum(w - i // 32 for i in range(k))
    return 4 * (4 * k + k + tri + w)


def check_nms_inputs(boxes, scores, cls_id):
    """Raise MXNetError unless the inputs are what the kernel takes:
    float32, contiguous, boxes (B, K, 4), scores and class ids (B, K),
    all on one CUDA device, with K within the kernel's bounds."""
    if boxes.ndim != 3 or boxes.shape[2] != 4:
        raise MXNetError("multibox_nms kernel: boxes have shape %s, not "
                         "(B, K, 4)" % (tuple(boxes.shape),))
    for name, v in (("boxes", boxes), ("scores", scores),
                    ("cls_id", cls_id)):
        if v.dtype != torch.float32:
            raise MXNetError("multibox_nms kernel: %s has dtype %s; it "
                             "takes float32" % (name, v.dtype))
        if not v.is_contiguous():
            raise MXNetError("multibox_nms kernel: %s is not contiguous"
                             % name)
        if not v.is_cuda or v.device != boxes.device:
            raise MXNetError("multibox_nms kernel: %s is on %s; every input "
                             "must be on one CUDA device" % (name, v.device))
        if name != "boxes" and tuple(v.shape) != tuple(boxes.shape[:2]):
            raise MXNetError("multibox_nms kernel: %s has shape %s, not %s"
                             % (name, tuple(v.shape),
                                tuple(boxes.shape[:2])))
    k = boxes.shape[1]
    if k > NMS_MAX_K or nms_smem_bytes(k) > NMS_MAX_SMEM:
        raise MXNetError(
            "multibox_nms kernel: %d candidates need %d bytes of shared "
            "memory (at most %d candidates and %d bytes); lower nms_topk"
            % (k, nms_smem_bytes(k), NMS_MAX_K, NMS_MAX_SMEM))


_kernel_lock = threading.Lock()
_kernel_fn = None


def _kernel():
    global _kernel_fn
    with _kernel_lock:
        if _kernel_fn is None:
            from .. import build
            lib = build.load(KERNEL)
            fn = lib.multibox_nms
            fn.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            err = lib.multibox_nms_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _kernel_fn = (fn, err)
        return _kernel_fn


def _nms_cuda(boxes, scores, cls_id, thresh, force_suppress):
    check_nms_inputs(boxes, scores, cls_id)
    B, K = scores.shape
    keep = torch.empty((B, K), dtype=torch.bool, device=boxes.device)
    if B == 0 or K == 0:
        return keep
    fn, err = _kernel()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        rc = fn(boxes.data_ptr(), scores.data_ptr(), cls_id.data_ptr(),
                keep.data_ptr(), B, K, float(thresh),
                int(bool(force_suppress)), stream)
    if rc != 0:
        raise MXNetError("multibox_nms launch failed: %s (cuda error %d)"
                         % (err(rc).decode(), rc))
    with _kernel_lock:
        nms_keep.launches += 1
    return keep


def nms_keep(boxes, scores, cls_id, thresh, force_suppress=False):
    """The keep mask (B, K) of the greedy suppression sweep over
    score-sorted candidates (``nms_keep_reference`` says what it
    computes): the kernel on a CUDA tensor, the plain version on a CPU
    one."""
    if boxes.device.type == "cpu":
        return nms_keep_reference(boxes, scores, cls_id, thresh,
                                  force_suppress)
    if boxes.device.type == "meta":
        return torch.empty(scores.shape, dtype=torch.bool, device="meta")
    return _nms_cuda(boxes, scores, cls_id, thresh, force_suppress)


nms_keep.launches = 0


# --------------------------------------------------------- MultiBoxDetection
def detection_candidates(a, cls_prob, loc_pred, anchor):
    """The candidates the sweep takes (mxtpu/ops/contrib.py:240-259): the
    boxes decoded from ``loc_pred`` (B, A*4) on ``anchor`` (1, A, 4)
    (clipped under ``clip``), each anchor's best foreground class and its
    score from ``cls_prob`` (B, C+1, A), the scores at or under
    ``threshold`` set to -inf; then the stable descending sort and the
    ``nms_topk`` cut. Returns contiguous (boxes (B, K, 4), scores (B, K),
    class ids (B, K))."""
    B, A = cls_prob.shape[0], anchor.shape[1]
    anchors = anchor[0].detach()
    boxes = _decode_loc(anchors, loc_pred.detach().reshape(B, A, 4),
                        a.variances)
    if a.clip:
        boxes = boxes.clamp(0.0, 1.0)
    fg = cls_prob.detach()[:, 1:, :]
    score = torch.amax(fg, dim=1)
    cls_id = torch.argmax(fg, dim=1).to(fg.dtype)  # the first largest
    score = torch.where(score > float(a.threshold), score, float("-inf"))
    order = torch.sort(-score, dim=1, stable=True).indices
    topk = int(a.nms_topk)
    if 0 < topk < A:
        order = order[:, :topk]
    sb = torch.gather(boxes, 1, order.unsqueeze(-1).expand(-1, -1, 4))
    return (sb.contiguous(), torch.gather(score, 1, order).contiguous(),
            torch.gather(cls_id, 1, order).contiguous())


def _multibox_detection(a, cls_prob, loc_pred, anchor):
    """cls_prob (B, C+1, A), loc_pred (B, A*4), anchor (1, A, 4) ->
    (B, A, 6) rows [cls_id, score, x1, y1, x2, y2] in score order; a
    row not kept has cls_id -1 (and score 0 when it was under the
    threshold), and the rows past ``nms_topk`` are [-1, 0, 0, 0, 0, 0]."""
    B, A = cls_prob.shape[0], anchor.shape[1]
    if cls_prob.device.type == "meta":
        return torch.empty(B, A, 6, dtype=cls_prob.dtype, device="meta")
    sb, ss, sc = detection_candidates(a, cls_prob, loc_pred, anchor)
    keep = nms_keep(sb, ss, sc, float(a.nms_threshold),
                    bool(a.force_suppress))
    out_cls = torch.where(keep & (ss > float("-inf")), sc, -1.0)
    out_score = torch.where(keep & torch.isfinite(ss), ss, 0.0)
    out = torch.cat([out_cls.unsqueeze(-1), out_score.unsqueeze(-1), sb],
                    dim=-1)
    if out.shape[1] < A:  # back to A rows
        pad = out.new_zeros(B, A - out.shape[1], 6)
        pad[:, :, 0] = -1.0
        out = torch.cat([out, pad], dim=1)
    return out


register("_contrib_MultiBoxDetection", _multibox_detection,
         arg_names=["cls_prob", "loc_pred", "anchor"],
         attrs={"clip": True, "threshold": 0.01, "background_id": 0,
                "nms_threshold": 0.5, "force_suppress": False,
                "variances": (0.1, 0.1, 0.2, 0.2), "nms_topk": -1},
         aliases=("MultiBoxDetection",))


# ---------------------------------------------------------------- replicas
# anchors are the same on every replica; target matching and detection
# run each sample on its own
set_replicas(["_contrib_MultiBoxPrior", "MultiBoxPrior",
              "_contrib_MultiBoxTarget", "MultiBoxTarget",
              "_contrib_MultiBoxDetection", "MultiBoxDetection"])
