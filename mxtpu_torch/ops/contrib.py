"""Contrib operators: the SSD detector's MultiBox trio and suppression
sweep, quantize/dequantize, fft/ifft, count_sketch and CTCLoss.

Counterpart of ``mxtpu/ops/contrib.py:1-292``: ``_box_iou_corner``
(:23), ``_contrib_MultiBoxPrior`` (:43-86: anchors, a pure function of
the feature map's shape), ``_contrib_MultiBoxTarget`` (:109-195: IoU
matching, the forced match of each ground-truth box's best anchor,
hard-negative mining and the location encoding) and
``_contrib_MultiBoxDetection`` (:237-284: decoding, the score sort, the
``nms_topk`` cut and the suppression sweep), each with its alias, arg
names and attr defaults. mxtpu vmaps each op over the batch; here the
batch is a dimension written out. Then the rest of that module
(:298-483): ``_contrib_quantize``/``_contrib_dequantize``,
``_contrib_fft``/``_contrib_ifft``, ``_contrib_count_sketch`` and
``_contrib_CTCLoss`` with its aliases, each with mxtpu's gradient.

The sweep (``_nms_scan`` :214, an XLA ``lax.scan`` over the
score-sorted candidates) is ``nms_keep``: a hand-written CUDA kernel for
a CUDA tensor (``csrc/multibox_nms.cu``: the "i clears j" bit matrix
over the whole card into a scratch tensor, then a chunked sweep, one
block an image; ``nms_plan`` sizes both launches and the scratch) and
``nms_keep_reference``, a loop over the candidates vectorised over the
batch, for a CPU tensor. Nothing falls back: on the card the kernel runs
or the call raises. ``nms_keep.launches`` counts kernel launches.

CTC's recursion (``_ctc_loss_one`` :355, an XLA ``lax.scan`` over time
whose gradient is ``jax.grad`` of it) is the kernel pair of
``csrc/ctc_loss.cu`` for a CUDA tensor (``ctc_loss_fwd``: the loss and
every step's alpha, a block a sequence; ``ctc_loss_bwd``: the adjoint of
the scan over the stored alphas, then the frames' class sums and the
log-softmax's gradient in a second launch; each ``.launches`` counts its
calls) and ``ctc_loss_reference``, the scan as a loop over t with
autograd's gradient, for a CPU tensor. The log-softmax and the labels'
compaction (``ctc_labels``) run as torch ops before the launch.

The three MultiBox ops are not differentiable (mxtpu's gradient sweep
lists them so, ``tests/test_op_gradient_sweep.py:290-292``): their inputs are
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
from .registry import Required, int_convert, register, set_replicas

__all__ = ["nms_keep", "nms_keep_reference", "nms_plan",
           "detection_candidates", "ctc_loss", "ctc_labels",
           "ctc_loss_reference", "ctc_loss_fwd", "ctc_loss_bwd"]

KERNEL = "multibox_nms"
NMS_TILE = 64  # candidates a tile of the bit matrix, bits a word
NMS_SWEEP_THREADS = 1024
_MAX_IMAGE_BLOCKS = 65535  # a grid's y extent


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

    gt_cls = int_convert(label[:, :, 0])
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


def nms_plan(batch, k):
    """The kernel's launch plan for ``batch`` images of ``k`` candidates,
    as ``csrc/multibox_nms.cu`` takes it: ``tiles`` = ceil(k / 64) tiles
    of 64 candidates (and 64-bit words a row); the matrix launch's grid
    (``pairs`` = the tiles of the upper triangle, ``image_blocks``, the
    images a column of blocks, looped past 65,535) of 64-thread blocks;
    the sweep's grid, one block of 1,024 threads an image, with
    ``sweep_smem`` bytes of removed-mask; and the scratch bit matrix,
    ``scratch_shape`` (batch, tiles, k) int64 words of ``scratch_bytes``."""
    tiles = -(-k // NMS_TILE)
    pairs = tiles * (tiles + 1) // 2
    return {"tiles": tiles, "pairs": pairs,
            "image_blocks": min(batch, _MAX_IMAGE_BLOCKS),
            "matrix_blocks": pairs * batch, "matrix_threads": NMS_TILE,
            "sweep_blocks": batch, "sweep_threads": NMS_SWEEP_THREADS,
            "sweep_smem": 8 * tiles, "scratch_shape": (batch, tiles, k),
            "scratch_bytes": 8 * batch * tiles * k}


def check_nms_inputs(boxes, scores, cls_id):
    """Raise MXNetError unless the inputs are what the kernel takes:
    float32, contiguous, boxes (B, K, 4), scores and class ids (B, K),
    all on one CUDA device."""
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


_kernel_lock = threading.Lock()
_kernel_fn = None


def _kernel():
    global _kernel_fn
    with _kernel_lock:
        if _kernel_fn is None:
            from .. import build
            lib = build.load(KERNEL)
            fn = lib.multibox_nms
            fn.argtypes = [ctypes.c_void_p] * 5 + [
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
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
    plan = nms_plan(B, K)
    mask = torch.empty(plan["scratch_shape"], dtype=torch.int64,
                       device=boxes.device)
    fn, err = _kernel()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        rc = fn(boxes.data_ptr(), scores.data_ptr(), cls_id.data_ptr(),
                mask.data_ptr(), keep.data_ptr(), B, K, plan["tiles"],
                plan["pairs"], plan["image_blocks"], float(thresh),
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


# ------------------------------------------------------------- quantization
def _quantize(a, data, min_range, max_range):
    """float -> uint8 affine quantization (mxtpu/ops/contrib.py:298):
    ``clip(round((data - mn) * 255 / max(mx - mn, 1e-8)), 0, 255)``,
    rounding half to even; the range comes back as two (1,) outputs."""
    mn = min_range.reshape(())
    mx = max_range.reshape(())
    scale = 255.0 / torch.maximum(mx - mn, mx.new_tensor(1e-8))
    q = torch.clamp(torch.round((data - mn) * scale), 0, 255).to(
        torch.uint8)
    return q, mn.reshape(1), mx.reshape(1)


register("_contrib_quantize", _quantize,
         arg_names=["data", "min_range", "max_range"],
         attrs={"out_type": "uint8"}, num_outputs=3)


def _dequantize(a, data, min_range, max_range):
    """uint8 -> float32 (mxtpu/ops/contrib.py:313); the gradient reaches
    ``min_range`` and ``max_range`` through ``max(mx - mn, 1e-8)``."""
    mn = min_range.reshape(())
    mx = max_range.reshape(())
    scale = torch.maximum(mx - mn, mx.new_tensor(1e-8)) / 255.0
    return data.to(torch.float32) * scale + mn


register("_contrib_dequantize", _dequantize,
         arg_names=["data", "min_range", "max_range"],
         attrs={"out_type": "float32"})


# ---------------------------------------------------------------------- fft
def _fft(a, data):
    """FFT of real rows along the last axis, re/im interleaved: the last
    dimension doubles (mxtpu/ops/contrib.py:330)."""
    f = torch.fft.fft(data.to(torch.complex64), dim=-1)
    out = torch.stack([f.real, f.imag], dim=-1)
    return out.reshape(data.shape[:-1] + (2 * data.shape[-1],)).to(
        torch.float32)


register("_contrib_fft", _fft, attrs={"compute_size": 128})


def _ifft(a, data):
    """Interleaved re/im -> the real part of the inverse FFT, times n: the
    result is not normalized (mxtpu/ops/contrib.py:341)."""
    n = data.shape[-1] // 2
    c = data.reshape(data.shape[:-1] + (n, 2))
    out = torch.fft.ifft(torch.complex(c[..., 0], c[..., 1]), dim=-1)
    return (out.real * n).to(torch.float32)


register("_contrib_ifft", _ifft, attrs={"compute_size": 128})


# -------------------------------------------------------------- count_sketch
def _count_sketch(a, data, h, s):
    """``out[..., h[i]] += s[i] * data[..., i]`` (mxtpu/ops/contrib.py:467):
    ``h`` converted to int32 as XLA converts it (``int_convert``: NaN is
    0, out of range saturates), a negative index counted from the end, and
    an index outside [-out_dim, out_dim) dropped, as mxtpu's scatter
    does; repeated indices add."""
    out_dim = int(a.out_dim)
    idx = int_convert(h.reshape(-1)).to(torch.int64)
    idx = torch.where(idx < 0, idx + out_dim, idx)
    keep = (idx >= 0) & (idx < out_dim)
    contrib = data * s.reshape(-1)
    out = data.new_zeros(data.shape[:-1] + (out_dim,))
    if data.device.type == "meta":
        return out
    kept = keep.nonzero().reshape(-1)
    return out.index_add(-1, idx[kept], contrib.index_select(-1, kept))


register("_contrib_count_sketch", _count_sketch,
         arg_names=["data", "h", "s"],
         attrs={"out_dim": Required(int), "processing_batch_size": 32})


# ------------------------------------------------------------------ CTCLoss
CTC_KERNEL = "ctc_loss"
CTC_NEG = -1e30  # mxtpu's log-domain zero: finite, so -1e30 + x is -1e30


def ctc_labels(label, num_classes, blank_first, label_lengths=None):
    """mxtpu's label preparation (mxtpu/ops/contrib.py:370-383) for every
    sequence at once: labels (and ``label_lengths``) converted to int32
    as XLA converts them (``int_convert``), the valid ones (those below
    ``label_lengths`` where given, else above 0 with the blank first, or
    not negative with the blank last) moved to the front in order by a
    stable sort, then clipped to [0, C - 1]. Returns (labels (N, L)
    int32, the count of valid labels (N,) int32)."""
    lab = int_convert(label)
    L = lab.shape[1]
    if label_lengths is not None:
        valid = torch.arange(L, device=lab.device)[None, :] < \
            int_convert(label_lengths).reshape(-1, 1)
    elif blank_first:
        valid = lab > 0
    else:
        valid = lab >= 0
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    lab = torch.gather(lab, 1, order).clamp(0, num_classes - 1)
    return lab.contiguous(), valid.sum(1).to(torch.int32)


def ctc_extended(lab, n_lab, blank):
    """The extended label [blank, l1, blank, l2, ..., blank] (N, S), the
    states a sequence reaches (N, S) and the skip transitions allowed
    (N, S): s - 2 -> s where ext[s] is not the blank and differs from
    ext[s - 2]."""
    N, L = lab.shape
    S = 2 * L + 1
    ext = torch.full((N, S), blank, dtype=torch.int64, device=lab.device)
    ext[:, 1::2] = lab.to(torch.int64)
    s_idx = torch.arange(S, device=lab.device)
    s_valid = s_idx[None, :] < 2 * n_lab.to(torch.int64)[:, None] + 1
    ext_m2 = torch.cat([torch.full((N, 2), blank, dtype=torch.int64,
                                   device=lab.device), ext[:, :-2]], 1)
    can_skip = (ext != blank) & (ext != ext_m2) & (s_idx[None, :] >= 2)
    return ext, s_valid, can_skip


def ctc_loss_reference(data, lab, n_lab, data_len, blank):
    """The plain version of the CTC pair: mxtpu's scan (``_ctc_loss_one``
    :355) as a loop over t, vectorised over the sequences and the
    states, with the log-domain zero -1e30 finite, the ``can_skip`` rule,
    the ``isfinite(m)`` guard and the freeze past ``data_len`` (N,) int32;
    its gradient is autograd's, through ``log_softmax`` as mxtpu's is
    ``jax.grad``'s. data (T, N, C) -> the loss (N,); an infeasible
    alignment gives 1e30."""
    T, N, C = data.shape
    logp = torch.log_softmax(data, dim=-1)
    ext, s_valid, can_skip = ctc_extended(lab, n_lab, blank)
    S = ext.shape[1]
    neg = torch.tensor(CTC_NEG, dtype=logp.dtype, device=data.device)
    rows = torch.arange(N, device=data.device)
    s_idx = torch.arange(S, device=data.device)[None, :]
    has = (n_lab > 0)[:, None]
    first = logp[0, rows, ext[:, 1]][:, None]
    alpha = torch.where(s_idx == 0, logp[0, :, blank][:, None],
                        torch.where((s_idx == 1) & has, first, neg))
    pad1 = neg.expand(N, 1)
    pad2 = neg.expand(N, 2)
    dlen = data_len.to(torch.int64)[:, None]
    for t in range(1, T):
        a_m1 = torch.cat([pad1, alpha[:, :-1]], 1)
        a_m2 = torch.where(can_skip, torch.cat([pad2, alpha[:, :-2]], 1),
                           neg)
        m = torch.maximum(torch.maximum(alpha, a_m1), a_m2)
        tot = m + torch.log(torch.exp(alpha - m) + torch.exp(a_m1 - m)
                            + torch.exp(torch.where(can_skip, a_m2, neg)
                                        - m))
        tot = torch.where(torch.isfinite(m), tot, neg)
        new = torch.where(s_valid, tot + torch.gather(logp[t], 1, ext), neg)
        alpha = torch.where(t < dlen, new, alpha)
    n2 = 2 * n_lab.to(torch.int64)[:, None]
    end1 = torch.gather(alpha, 1, n2)[:, 0]
    end2 = torch.where(has[:, 0],
                       torch.gather(alpha, 1, (n2 - 1).clamp(min=0))[:, 0],
                       neg)
    m = torch.maximum(end1, end2)
    return -(m + torch.log(torch.exp(end1 - m) + torch.exp(end2 - m)))


def _ctc_check(logp, lab, n_lab, data_len):
    """Raise unless the kernels take these tensors: float32 logp (T, N,
    C), int32 labels (N, L) and counts (N,), contiguous, on one CUDA
    device. A sequence of more than 4,096 states (L > 2,047), which does
    not fit a block, is refused by the launchers, whose error the
    wrappers raise."""
    if logp.dim() != 3 or lab.dim() != 2 or lab.shape[0] != logp.shape[1] \
            or lab.shape[1] < 1 or logp.shape[0] < 1:
        raise MXNetError("ctc_loss kernels: logp (T, N, C) %s and labels "
                         "(N, L >= 1) %s do not fit"
                         % (tuple(logp.shape), tuple(lab.shape)))
    for name, v, dt in (("logp", logp, torch.float32),
                        ("labels", lab, torch.int32),
                        ("label counts", n_lab, torch.int32),
                        ("data lengths", data_len, torch.int32)):
        if v.dtype != dt or not v.is_contiguous():
            raise MXNetError("ctc_loss kernels: %s must be contiguous %s, "
                             "not %s" % (name, dt, v.dtype))
        if not v.is_cuda or v.device != logp.device:
            raise MXNetError("ctc_loss kernels: %s is on %s; every input "
                             "must be on one CUDA device" % (name, v.device))


_ctc_lock = threading.Lock()
_ctc_fns = None


def _ctc_kernels():
    global _ctc_fns
    with _ctc_lock:
        if _ctc_fns is None:
            from .. import build
            lib = build.load(CTC_KERNEL)
            fwd = lib.ctc_loss_fwd
            fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p]
            fwd.restype = ctypes.c_int
            bwd = lib.ctc_loss_bwd
            bwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p]
            bwd.restype = ctypes.c_int
            err = lib.ctc_loss_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _ctc_fns = (fwd, bwd, err)
        return _ctc_fns


def _ctc_stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def ctc_loss_fwd(logp, lab, n_lab, data_len, blank):
    """Launch the forward: the loss (N,) and every step's alpha (T, N, S)
    float32 for the backward, from the log-probabilities (T, N, C) and
    the prepared labels (``ctc_labels``). One launch, a block a sequence
    and a warp for every 32 states, up to 4,096 states; longer sequences
    are refused. ``ctc_loss_fwd.launches`` counts the launches."""
    _ctc_check(logp, lab, n_lab, data_len)
    T, N, C = logp.shape
    S = 2 * lab.shape[1] + 1
    loss = torch.empty(N, dtype=torch.float32, device=logp.device)
    alpha = torch.empty((T, N, S), dtype=torch.float32, device=logp.device)
    if N == 0:
        return loss, alpha
    fwd, _, err = _ctc_kernels()
    with torch.cuda.device(logp.device):
        rc = fwd(logp.data_ptr(), lab.data_ptr(), n_lab.data_ptr(),
                 data_len.data_ptr(), loss.data_ptr(), alpha.data_ptr(), T,
                 N, C, lab.shape[1], int(blank), _ctc_stream(logp))
    if rc != 0:
        raise MXNetError("ctc_loss_fwd launch failed: %s (cuda error %d)"
                         % (err(rc).decode(), rc))
    with _ctc_lock:
        ctc_loss_fwd.launches += 1
    return loss, alpha


ctc_loss_fwd.launches = 0


def ctc_loss_bwd(grad, logp, alpha, lab, n_lab, data_len, blank):
    """Launch the backward: d loss / d logits (T, N, C) float32 for the
    head gradient ``grad`` (N,): the adjoint of mxtpu's scan run from the
    last step down over the forward's ``alpha``, writing each step's
    per-state cotangent to a (T, N, S) scratch tensor, then the frames'
    class sums and the log-softmax's gradient. Two launches a call, no
    atomics: repeats are bit-identical. ``ctc_loss_bwd.launches`` counts
    the calls."""
    _ctc_check(logp, lab, n_lab, data_len)
    T, N, C = logp.shape
    S = 2 * lab.shape[1] + 1
    if tuple(alpha.shape) != (T, N, S) or alpha.dtype != torch.float32 or \
            not alpha.is_contiguous() or alpha.device != logp.device or \
            grad.shape != (N,) or grad.dtype != torch.float32 or \
            not grad.is_contiguous() or grad.device != logp.device:
        raise MXNetError("ctc_loss_bwd: alpha %s and grad %s must be "
                         "contiguous float32 (%d, %d, %d) and (%d,) on %s"
                         % (tuple(alpha.shape), tuple(grad.shape), T, N, S,
                            N, logp.device))
    dx = torch.empty_like(logp)
    if N == 0:
        return dx
    ct = torch.empty((T, N, S), dtype=torch.float32, device=logp.device)
    _, bwd, err = _ctc_kernels()
    with torch.cuda.device(logp.device):
        rc = bwd(grad.data_ptr(), logp.data_ptr(), alpha.data_ptr(),
                 lab.data_ptr(), n_lab.data_ptr(), data_len.data_ptr(),
                 ct.data_ptr(), dx.data_ptr(), T, N, C, lab.shape[1],
                 int(blank), _ctc_stream(logp))
    if rc != 0:
        raise MXNetError("ctc_loss_bwd launch failed: %s (cuda error %d)"
                         % (err(rc).decode(), rc))
    with _ctc_lock:
        ctc_loss_bwd.launches += 1
    return dx


ctc_loss_bwd.launches = 0


class _CTCFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, lab, n_lab, data_len, blank):
        logp = torch.log_softmax(data, dim=-1).contiguous()
        loss, alpha = ctc_loss_fwd(logp, lab, n_lab, data_len, blank)
        ctx.save_for_backward(logp, alpha, lab, n_lab, data_len)
        ctx.blank = blank
        return loss

    @staticmethod
    def backward(ctx, grad):
        logp, alpha, lab, n_lab, data_len = ctx.saved_tensors
        dx = ctc_loss_bwd(grad.contiguous(), logp, alpha, lab, n_lab,
                          data_len, ctx.blank)
        return dx, None, None, None, None


def ctc_loss(data, label, blank_label="first", data_lengths=None,
             label_lengths=None):
    """CTC's negative log-likelihood (N,) of ``label`` (N, L) under the
    activations ``data`` (T, N, C), with mxtpu's conventions
    (``ctc_labels``, ``ctc_loss_reference``): the kernel pair of
    ``csrc/ctc_loss.cu`` on a CUDA tensor, the plain version on a CPU
    one."""
    T, N, C = data.shape
    blank_first = str(blank_label) != "last"
    blank = 0 if blank_first else C - 1
    if data.device.type == "meta":
        return torch.empty(N, dtype=data.dtype, device="meta")
    lab, n_lab = ctc_labels(label, C, blank_first, label_lengths)
    if data_lengths is None:
        data_len = torch.full((N,), T, dtype=torch.int32, device=data.device)
    else:
        data_len = int_convert(data_lengths).reshape(N).contiguous()
    if data.device.type == "cpu":
        return ctc_loss_reference(data, lab, n_lab, data_len, blank)
    if data.dtype != torch.float32:
        raise MXNetError("ctc_loss on %s takes float32 activations, not %s"
                         % (data.device, data.dtype))
    return _CTCFunction.apply(data.contiguous(), lab, n_lab, data_len, blank)


def _ctc_op(a, data, label, *lengths):
    """data (T, N, C), label (N, L), then ``data_lengths`` where
    ``use_data_lengths`` and ``label_lengths`` where ``use_label_lengths``
    (mxtpu/ops/contrib.py:419)."""
    rest = list(lengths)
    data_lengths = rest.pop(0) if a.use_data_lengths else None
    label_lengths = rest.pop(0) if a.use_label_lengths else None
    return ctc_loss(data, label.detach(), a.blank_label,
                    None if data_lengths is None else data_lengths.detach(),
                    None if label_lengths is None
                    else label_lengths.detach())


def _ctc_args(a):
    names = ["data", "label"]
    if a.get("use_data_lengths"):
        names.append("data_lengths")
    if a.get("use_label_lengths"):
        names.append("label_lengths")
    return names


register("_contrib_CTCLoss", _ctc_op, arg_names=_ctc_args,
         attrs={"use_data_lengths": False, "use_label_lengths": False,
                "blank_label": "first"},
         aliases=("CTCLoss", "ctc_loss", "_contrib_ctc_loss"),
         loss_like=True)
