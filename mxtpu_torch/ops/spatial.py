"""Spatial, warping and region operators.

Counterpart of ``mxtpu/ops/spatial.py``: ``BilinearSampler`` (:56),
``GridGenerator`` (:87), ``SpatialTransformer`` (:112), ``ROIPooling``
(:135-180), ``PSROIPooling`` (:184-239), ``Correlation`` (:243-299),
``DeformableConvolution`` (:303-366), ``DeformablePSROIPooling``
(:369-423), ``Proposal``/``MultiProposal`` (:426-534) and ``khatri_rao``
(:538), each with mxtpu's arg names, attrs, defaults and aliases.
mxtpu vmaps each op over images or ROIs; here those are a dimension
written out, and the region ops run over chunks of ROIs so that no
intermediate passes ``_CHUNK_ELEMENTS`` elements. Every warp is
mxtpu's four-tap bilinear gather (``_bilinear_gather``) with zero
outside the map, so the gradients are those of ``jax.vjp`` of the same
expression.

ROIPooling is ``roi_pool``: on a CUDA tensor the hand-written kernel
``csrc/roi_pooling.cu`` (forward and backward, ``roi_pool.launches`` and
``roi_pool_backward.launches`` count them), on a CPU tensor
``roi_pool_reference``, mxtpu's masked max written in torch. Nothing
falls back: on the card the kernel runs or the call raises. The
behaviour both follow, as mxtpu computes it (``jnp.round`` half to even
for the corners, ``jnp.max``'s gradient split equally over tied maxima,
a NaN in a bin spreading NaN over that bin's gradient, ``jnp.where``
zeroing a bin whose max is not finite, no gradient into ``rois``, the
batch index truncated and clamped as XLA's convert and gather do) is
written out in ``roi_pool_reference``.

Proposal's suppression sweep is ``contrib.nms_keep``: the kernel
``csrc/multibox_nms.cu`` on the card, the plain sweep on the CPU. Its
gradient follows mxtpu: through the gathered, decoded and clipped boxes
into ``bbox_pred`` and, with ``output_score``, through the scores into
``cls_prob``. The sorts are stable, as ``jnp.argsort`` is.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import numpy as _np
import torch

from ..base import MXNetError
from .contrib import nms_keep
from .registry import Required, int_convert, register

__all__ = ["roi_pool", "roi_pool_reference", "roi_pool_backward",
           "roi_pool_backward_reference", "check_roi_inputs"]

KERNEL = "roi_pooling"
_CHUNK_ELEMENTS = 1 << 26  # the largest intermediate of a region op


def _chunks(n, per_item):
    """Ranges over ``n`` items, each holding at most _CHUNK_ELEMENTS
    elements at ``per_item`` elements an item (at least one item)."""
    step = max(1, _CHUNK_ELEMENTS // max(1, per_item))
    return [(i, min(n, i + step)) for i in range(0, n, step)]


def _batch_index(v, n):
    """The image index of each ROI: ``roi[0]`` converted to int32 as
    XLA converts it (``registry.int_convert``), then clamped into
    ``[0, n)`` as XLA's gather clamps it."""
    return int_convert(v.detach()).clamp(0, n - 1).long()


def _inv(n):
    """The float32 reciprocal of ``n``. mxtpu's compiled ops divide by a
    constant as XLA rewrites that division: a product with the constant's
    float32 reciprocal (``rw / 3`` is ``rw * 0.33333334``), which moves a
    floor or a ceil by one where the quotient lands on an integer. The
    port multiplies by the same reciprocal."""
    return float(_np.float32(1.0) / _np.float32(n))


def _fma(a, b, c):
    """a * b + c rounded once, as mxtpu's compiled ops compute it (XLA
    contracts a product and a sum into one fused multiply-add): the
    product is exact in float64 and the sum is rounded to float32."""
    return (a.double() * b.double() + c.double()).to(a.dtype)


def _linspace(n, dtype, device):
    """``jnp.linspace(-1, 1, n)`` in its own arithmetic: -1 * (1 - t) +
    1 * t at t = i / (n - 1), the end point exactly 1."""
    if n <= 1:
        return torch.full((n,), -1.0, dtype=dtype, device=device)
    t = torch.arange(n - 1, dtype=dtype, device=device) / (n - 1)
    out = -1.0 * (1 - t) + 1.0 * t
    return torch.cat([out, torch.ones(1, dtype=dtype, device=device)])


# ------------------------------------------------------------ bilinear sample
def _bilinear_gather(data, gx, gy):
    """Sample ``data`` (B, C, H, W) at float pixel coordinates ``gx``,
    ``gy`` (B, ...) -> (B, C, ...): four taps, each zero outside the map
    (mxtpu/ops/spatial.py:30-53, in its order of operations)."""
    B, C, H, W = data.shape
    lead = gx.shape[1:]
    flat = data.reshape(B, C, H * W)
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    x1 = x0 + 1
    y1 = y0 + 1
    wx1 = gx - x0
    wy1 = gy - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1

    def tap(xi, yi, w):
        inside = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        xc = torch.nan_to_num(xi.detach().clamp(0, W - 1)).long()
        yc = torch.nan_to_num(yi.detach().clamp(0, H - 1)).long()
        idx = (yc * W + xc).reshape(B, 1, -1).expand(B, C, -1)
        v = torch.gather(flat, 2, idx).reshape(B, C, *lead)
        return v * (w * inside.to(data.dtype)).unsqueeze(1)

    return (tap(x0, y0, wx0 * wy0) + tap(x1, y0, wx1 * wy0) +
            tap(x0, y1, wx0 * wy1) + tap(x1, y1, wx1 * wy1))


def _grid_to_pixels(grid, H, W):
    """A grid (N, 2, ...) of (x, y) in [-1, 1] -> pixel coordinates."""
    gx = (grid[:, 0] + 1.0) * (W - 1) / 2.0
    gy = (grid[:, 1] + 1.0) * (H - 1) / 2.0
    return gx, gy


def _bilinear_sampler(a, data, grid):
    """data (N, C, H, W), grid (N, 2, Ho, Wo) -> (N, C, Ho, Wo)."""
    gx, gy = _grid_to_pixels(grid, data.shape[2], data.shape[3])
    return _bilinear_gather(data, gx, gy)


register("BilinearSampler", _bilinear_sampler, arg_names=["data", "grid"],
         attrs={})


# ------------------------------------------------------------- GridGenerator
def _affine_grid(affine, H, W):
    """affine (N, 6), row-major 2x3 -> grid (N, 2, H, W) in [-1, 1]."""
    ys = _linspace(H, affine.dtype, affine.device)
    xs = _linspace(W, affine.dtype, affine.device)
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    src = torch.stack([xg, yg, torch.ones_like(xg)]).reshape(3, -1)
    out = affine.reshape(-1, 2, 3) @ src
    return out.reshape(-1, 2, H, W)


def _grid_generator(a, data):
    H, W = int(a.target_shape[0]), int(a.target_shape[1])
    if a.transform_type == "affine":
        return _affine_grid(data, H, W)
    # warp: a flow field in pixels added to the identity, normalised
    xs = torch.arange(W, dtype=data.dtype, device=data.device)
    ys = torch.arange(H, dtype=data.dtype, device=data.device)
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    gx = (data[:, 0] + xg) * 2.0 / max(W - 1, 1) - 1.0
    gy = (data[:, 1] + yg) * 2.0 / max(H - 1, 1) - 1.0
    return torch.stack([gx, gy], dim=1)


register("GridGenerator", _grid_generator,
         attrs={"transform_type": Required(str), "target_shape": (0, 0)})


# -------------------------------------------------------- SpatialTransformer
def _spatial_transformer(a, data, loc):
    """Sample ``data`` onto the ``target_shape`` grid of the affine
    transform ``loc`` (N, 6)."""
    H, W = int(a.target_shape[0]), int(a.target_shape[1])
    grid = _affine_grid(loc, H, W)
    gx, gy = _grid_to_pixels(grid, data.shape[2], data.shape[3])
    return _bilinear_gather(data, gx, gy)


register("SpatialTransformer", _spatial_transformer,
         arg_names=["data", "loc"],
         attrs={"target_shape": Required(tuple),
                "transform_type": "affine", "sampler_type": "bilinear"})


# ---------------------------------------------------------------- ROIPooling
def _roi_bins(rois, pooled_h, pooled_w, scale, H, W):
    """Each ROI's bin bounds (R, ph) and (R, pw), as floats: ``hstart``,
    ``hend``, ``wstart``, ``wend`` (mxtpu/ops/spatial.py:139-153), the
    bin size a product with the pooled size's reciprocal (``_inv``)."""
    x1 = torch.round(rois[:, 1] * scale)
    y1 = torch.round(rois[:, 2] * scale)
    x2 = torch.round(rois[:, 3] * scale)
    y2 = torch.round(rois[:, 4] * scale)
    rw = torch.clamp(x2 - x1 + 1.0, min=1.0)
    rh = torch.clamp(y2 - y1 + 1.0, min=1.0)
    bin_w = rw * _inv(pooled_w)
    bin_h = rh * _inv(pooled_h)
    ph = torch.arange(pooled_h, dtype=rois.dtype, device=rois.device)
    pw = torch.arange(pooled_w, dtype=rois.dtype, device=rois.device)
    hstart = torch.clamp(torch.floor(ph * bin_h[:, None]) + y1[:, None],
                         0, H - 1)
    hend = torch.clamp(torch.ceil((ph + 1) * bin_h[:, None]) + y1[:, None],
                       0, H)
    wstart = torch.clamp(torch.floor(pw * bin_w[:, None]) + x1[:, None],
                         0, W - 1)
    wend = torch.clamp(torch.ceil((pw + 1) * bin_w[:, None]) + x1[:, None],
                       0, W)
    return hstart, hend, wstart, wend


def roi_pool_reference(data, rois, pooled_size, spatial_scale):
    """Plain version of ROIPooling: data (N, C, H, W), rois (R, 5) rows
    [image, x1, y1, x2, y2] in image pixels -> (R, C, ph, pw). Each bin
    is the max of the feature over its pixels, computed as mxtpu does: a
    masked max over the whole map (masked pixels -inf), 0 where that max
    is not finite (an empty bin, +-inf, NaN). ``torch.amax`` splits a
    bin's gradient equally over its tied maxima as ``jnp.max`` does (a
    bin of nine zeros gives each pixel 1/9), and a NaN max gives its
    bin's pixels NaN gradient, as there. ``rois`` get no gradient."""
    ph, pw = int(pooled_size[0]), int(pooled_size[1])
    N, C, H, W = data.shape
    rois = rois.detach()
    hs, he, ws, we = _roi_bins(rois, ph, pw, spatial_scale, H, W)
    bidx = _batch_index(rois[:, 0], N)
    yy = torch.arange(H, dtype=data.dtype, device=data.device)
    xx = torch.arange(W, dtype=data.dtype, device=data.device)
    in_y = (yy >= hs[..., None]) & (yy < he[..., None])  # (R, ph, H)
    in_x = (xx >= ws[..., None]) & (xx < we[..., None])  # (R, pw, W)
    neg = torch.tensor(float("-inf"), dtype=data.dtype, device=data.device)
    outs = []
    for lo, hi in _chunks(rois.shape[0], C * ph * pw * H * W):
        m = in_y[lo:hi, :, None, :, None] & in_x[lo:hi, None, :, None, :]
        feat = data[bidx[lo:hi]]  # (r, C, H, W)
        masked = torch.where(m[:, None], feat[:, :, None, None], neg)
        outs.append(torch.amax(masked, dim=(4, 5)))
    out = torch.cat(outs) if outs else data.new_zeros((0, C, ph, pw))
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def roi_pool_backward_reference(data, rois, dy, pooled_size,
                                spatial_scale):
    """Plain version of the backward kernel: the gradient (N, C, H, W) of
    ``roi_pool_reference`` under the head ``dy`` (R, C, ph, pw), taken a
    chunk of ROIs at a time so that no chunk's masked tensor outlives
    it."""
    ph, pw = int(pooled_size[0]), int(pooled_size[1])
    N, C, H, W = data.shape
    dx = torch.zeros_like(data)
    for lo, hi in _chunks(rois.shape[0], C * ph * pw * H * W):
        x = data.detach().requires_grad_()
        with torch.enable_grad():
            y = roi_pool_reference(x, rois[lo:hi], (ph, pw), spatial_scale)
            dx += torch.autograd.grad(y, [x], dy[lo:hi])[0]
    return dx


def check_roi_inputs(data, rois):
    """Raise MXNetError unless the inputs are what the kernel takes:
    float32, contiguous, data (N, C, H, W) and rois (R, 5), both on one
    CUDA device."""
    if data.ndim != 4 or rois.ndim != 2 or rois.shape[1] != 5:
        raise MXNetError("roi_pooling kernel: data %s and rois %s are not "
                         "(N, C, H, W) and (R, 5)"
                         % (tuple(data.shape), tuple(rois.shape)))
    for name, v in (("data", data), ("rois", rois)):
        if v.dtype != torch.float32:
            raise MXNetError("roi_pooling kernel: %s has dtype %s; it takes "
                             "float32" % (name, v.dtype))
        if not v.is_contiguous():
            raise MXNetError("roi_pooling kernel: %s is not contiguous"
                             % name)
        if not v.is_cuda or v.device != data.device:
            raise MXNetError("roi_pooling kernel: %s is on %s; every input "
                             "must be on one CUDA device" % (name, v.device))


_kernel_lock = threading.Lock()
_kernel_fns = None


def _kernels():
    global _kernel_fns
    with _kernel_lock:
        if _kernel_fns is None:
            from .. import build
            lib = build.load(KERNEL)
            fwd = lib.roi_pool_forward
            fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
                ctypes.c_float, ctypes.c_void_p]
            fwd.restype = ctypes.c_int
            bwd = lib.roi_pool_backward
            bwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
                ctypes.c_float, ctypes.c_void_p]
            bwd.restype = ctypes.c_int
            err = lib.roi_pooling_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _kernel_fns = (fwd, bwd, err)
        return _kernel_fns


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc, what, err):
    if rc != 0:
        raise MXNetError("%s launch failed: %s (cuda error %d)"
                         % (what, err(rc).decode(), rc))


def _roi_forward_cuda(data, rois, ph, pw, scale):
    """Launch the forward: out (R, C, ph, pw), each bin's max."""
    check_roi_inputs(data, rois)
    N, C, H, W = data.shape
    R = rois.shape[0]
    out = torch.empty((R, C, ph, pw), dtype=torch.float32,
                      device=data.device)
    if R == 0 or C == 0:
        return out
    fwd, _, err = _kernels()
    with torch.cuda.device(data.device):
        rc = fwd(data.data_ptr(), rois.data_ptr(), out.data_ptr(), N, C, H,
                 W, R, ph, pw, float(scale), _stream(data))
    _raise_on(rc, "roi_pool_forward", err)
    with _kernel_lock:
        roi_pool.launches += 1
    return out


def roi_pool_backward(dy, data, rois, scale):
    """Launch the backward: the gradient (N, C, H, W) of ROIPooling from
    ``dy`` (R, C, ph, pw) and the forward's inputs. Two launches: each
    bin's max and share of its head gradient into a (R, ph, pw, C, 2)
    float32 scratch and each ROI's bin table into a (R, 5 + 2 ph + 2 pw)
    int32 one, then a sum over the bins that hold each input element in
    ROI and bin order, with no atomics: repeats are bit-identical.
    ``roi_pool_backward.launches`` counts calls."""
    N, C, H, W = data.shape
    check_roi_inputs(data, rois)
    R = rois.shape[0]
    if dy.dim() != 4 or tuple(dy.shape[:2]) != (R, C) or \
            dy.dtype != torch.float32 or not dy.is_contiguous() or \
            dy.device != data.device:
        raise MXNetError("roi_pooling backward: dy %s must be a contiguous "
                         "float32 (%d, %d, ph, pw) on %s"
                         % (tuple(dy.shape), R, C, data.device))
    ph, pw = dy.shape[2:]
    dx = torch.empty_like(data)
    if dx.numel() == 0:
        return dx
    kv = torch.empty((R, ph, pw, C, 2), dtype=torch.float32,
                     device=data.device)
    table = torch.empty((R, 5 + 2 * ph + 2 * pw), dtype=torch.int32,
                        device=data.device)
    _, bwd, err = _kernels()
    with torch.cuda.device(data.device):
        rc = bwd(dy.data_ptr(), data.data_ptr(), rois.data_ptr(),
                 kv.data_ptr(), table.data_ptr(), dx.data_ptr(), N, C, H, W,
                 R, ph, pw, float(scale), _stream(data))
    _raise_on(rc, "roi_pool_backward", err)
    with _kernel_lock:
        roi_pool_backward.launches += 1
    return dx


roi_pool_backward.launches = 0


class _RoiPoolFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, rois, ph, pw, scale):
        ctx.save_for_backward(data, rois)
        ctx.scale = scale
        return _roi_forward_cuda(data, rois, ph, pw, scale)

    @staticmethod
    def backward(ctx, dy):
        data, rois = ctx.saved_tensors
        dx = roi_pool_backward(dy.contiguous(), data, rois, ctx.scale)
        return dx, None, None, None, None


def roi_pool(data, rois, pooled_size, spatial_scale):
    """ROIPooling (``roi_pool_reference`` says what it computes): the
    kernel on a CUDA tensor, the plain version on a CPU one."""
    ph, pw = int(pooled_size[0]), int(pooled_size[1])
    if data.device.type == "cpu":
        return roi_pool_reference(data, rois, (ph, pw), spatial_scale)
    if data.device.type == "meta":
        return torch.empty((rois.shape[0], data.shape[1], ph, pw),
                           dtype=data.dtype, device="meta")
    return _RoiPoolFunction.apply(data, rois.detach(), ph, pw,
                                  float(spatial_scale))


roi_pool.launches = 0


def _roi_pooling(a, data, rois):
    return roi_pool(data, rois, a.pooled_size, float(a.spatial_scale))


register("ROIPooling", _roi_pooling, arg_names=["data", "rois"],
         attrs={"pooled_size": Required(tuple),
                "spatial_scale": Required(float)})


# -------------------------------------------------------------- PSROIPooling
def _psroi_pooling(a, data, rois):
    """Position-sensitive ROI pooling: data (N, odim * group^2, H, W);
    each pooled bin averages its position's channel over the bin
    (group_size 0 means pooled_size)."""
    N, C, H, W = data.shape
    pooled = int(a.pooled_size)
    group = int(a.group_size) or pooled
    odim = int(a.output_dim)
    scale = float(a.spatial_scale)
    rois = rois.detach()
    x1 = rois[:, 1] * scale
    y1 = rois[:, 2] * scale
    x2 = rois[:, 3] * scale
    y2 = rois[:, 4] * scale
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    bin_w = (rw * _inv(pooled))[:, None]
    bin_h = (rh * _inv(pooled))[:, None]
    yy = torch.arange(H, dtype=data.dtype, device=data.device)
    xx = torch.arange(W, dtype=data.dtype, device=data.device)
    bi = torch.arange(pooled, dtype=data.dtype, device=data.device)
    hstart = torch.floor(_fma(bi, bin_h, y1[:, None]))
    hend = torch.ceil(_fma(bi + 1, bin_h, y1[:, None]))
    wstart = torch.floor(_fma(bi, bin_w, x1[:, None]))
    wend = torch.ceil(_fma(bi + 1, bin_w, x1[:, None]))
    in_y = (yy >= hstart[..., None]) & (yy < hend[..., None])  # (R, p, H)
    in_x = (xx >= wstart[..., None]) & (xx < wend[..., None])
    gsel = torch.arange(pooled, device=data.device) * group // pooled
    bidx = _batch_index(rois[:, 0], N)
    outs = []
    for lo, hi in _chunks(rois.shape[0], odim * pooled * pooled * H * W):
        m = (in_y[lo:hi, :, None, :, None] &
             in_x[lo:hi, None, :, None, :]).to(data.dtype)  # (r,p,p,H,W)
        f = data[bidx[lo:hi]].reshape(-1, odim, group, group, H, W)
        fbin = f[:, :, gsel][:, :, :, gsel]  # (r, odim, p, p, H, W)
        num = torch.einsum("robcyx,rbcyx->robc", fbin, m)
        den = torch.clamp(m.sum(dim=(3, 4)), min=1.0)
        outs.append(num / den[:, None])
    if not outs:
        return data.new_zeros((0, odim, pooled, pooled))
    return torch.cat(outs)


register("_contrib_PSROIPooling", _psroi_pooling, arg_names=["data", "rois"],
         attrs={"spatial_scale": Required(float), "output_dim": Required(int),
                "pooled_size": Required(int), "group_size": 0},
         aliases=("PSROIPooling",))


# --------------------------------------------------------------- Correlation
def _correlation(a, data1, data2):
    """FlowNet's correlation: for each displacement (dy, dx) of the
    (2 * max_displacement / stride2 + 1)^2 neighbourhood, the patchwise
    product (or absolute difference) of data1 at x and data2 at x + d,
    summed over channels and the kernel x kernel patch and divided by
    their count. One pass a displacement, the patch summed as kernel^2
    shifted slices."""
    pad = int(a.pad_size)
    kernel = int(a.kernel_size)
    maxd = int(a.max_displacement)
    s1 = int(a.stride1)
    s2 = int(a.stride2)
    mult = bool(a.is_multiply)
    N, C, H, W = data1.shape
    pads = (pad, pad, pad, pad)
    d1 = torch.nn.functional.pad(data1, pads)
    d2 = torch.nn.functional.pad(data2, pads)
    Hp, Wp = H + 2 * pad, W + 2 * pad
    bord = maxd + (kernel - 1) // 2
    out_h = -(-(Hp - 2 * bord) // s1)
    out_w = -(-(Wp - 2 * bord) // s1)
    k2 = kernel // 2
    disps = [d * s2 for d in range(-(maxd // s2), maxd // s2 + 1)]

    def rows(img, y0, x0):
        """img's (y0 + s1 * i, x0 + s1 * j) for the out_h x out_w
        positions."""
        return img[:, :, y0:y0 + s1 * (out_h - 1) + 1:s1,
                   x0:x0 + s1 * (out_w - 1) + 1:s1]

    outs = []
    for dy in disps:
        for dx in disps:
            acc = None
            for u in range(kernel):
                for v in range(kernel):
                    y0, x0 = bord - k2 + u, bord - k2 + v
                    p1 = rows(d1, y0, x0)
                    p2 = rows(d2, y0 + dy, x0 + dx)
                    t = (p1 * p2 if mult else torch.abs(p1 - p2)).sum(1)
                    acc = t if acc is None else acc + t
            outs.append(acc)
    return torch.stack(outs, dim=1) / (C * kernel * kernel)


register("Correlation", _correlation, arg_names=["data1", "data2"],
         attrs={"kernel_size": 1, "max_displacement": 1, "stride1": 1,
                "stride2": 1, "pad_size": 0, "is_multiply": True})


# --------------------------------------------------- DeformableConvolution
def _deformable_conv(a, data, offset, weight, bias=None):
    """Deformable convolution v1: the taps of a convolution moved by a
    learned offset field (one a deformable group), sampled bilinearly
    into columns (N, C, oh, ow, kh, kw), then one grouped product with
    the weight."""
    kh, kw = int(a.kernel[0]), int(a.kernel[1])
    sh, sw = (int(x) for x in (tuple(a.stride) or (1, 1)))
    ph, pw = (int(x) for x in (tuple(a.pad) or (0, 0)))
    dh, dw = (int(x) for x in (tuple(a.dilate) or (1, 1)))
    N, C, H, W = data.shape
    F = int(a.num_filter)
    G = int(a.num_group)
    DG = int(a.num_deformable_group)
    out_h = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    out_w = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    dev = data.device
    base_y = (torch.arange(out_h, device=dev) * sh - ph)[:, None, None, None]
    base_x = (torch.arange(out_w, device=dev) * sw - pw)[None, :, None, None]
    ky = (torch.arange(kh, device=dev) * dh)[None, None, :, None]
    kx = (torch.arange(kw, device=dev) * dw)[None, None, None, :]
    off = offset.reshape(N, DG, kh * kw, 2, out_h, out_w)
    dy = off[:, :, :, 0].permute(0, 1, 3, 4, 2).reshape(
        N * DG, out_h, out_w, kh, kw)
    dx = off[:, :, :, 1].permute(0, 1, 3, 4, 2).reshape(
        N * DG, out_h, out_w, kh, kw)
    gy = (base_y + ky).to(data.dtype) + dy
    gx = (base_x + kx).to(data.dtype) + dx
    cols = _bilinear_gather(data.reshape(N * DG, C // DG, H, W), gx, gy)
    cols_g = cols.reshape(N, G, C // G, out_h, out_w, kh, kw)
    w_g = weight.reshape(G, F // G, C // G, kh, kw)
    out = torch.einsum("ngchwyx,gfcyx->ngfhw", cols_g, w_g).reshape(
        N, F, out_h, out_w)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


register("_contrib_DeformableConvolution", _deformable_conv,
         arg_names=lambda a: (["data", "offset", "weight"]
                              if a.get("no_bias", True)
                              else ["data", "offset", "weight", "bias"]),
         attrs={"kernel": Required(tuple), "stride": (), "dilate": (),
                "pad": (), "num_filter": Required(int), "num_group": 1,
                "num_deformable_group": 1, "no_bias": True,
                "workspace": 1024, "layout": None},
         aliases=("DeformableConvolution",))


# -------------------------------------------------- DeformablePSROIPooling
def _deformable_psroi_pooling(a, data, rois, trans=None):
    """PSROIPooling with each bin shifted by a learned, normalised offset
    ``trans`` (R, 2, part, part) and averaged over sample_per_part^2
    bilinear samples."""
    group = int(a.group_size)
    odim = int(a.output_dim)
    part = int(a.part_size) or group
    scale = float(a.spatial_scale)
    trans_std = float(a.trans_std)
    pooled = int(a.pooled_size)
    sub = int(a.sample_per_part)
    N, C, H, W = data.shape
    R = rois.shape[0]
    dev, dt = data.device, data.dtype
    rois = rois.detach()
    x1 = rois[:, 1] * scale - 0.5
    y1 = rois[:, 2] * scale - 0.5
    x2 = (rois[:, 3] + 1.0) * scale - 0.5
    y2 = (rois[:, 4] + 1.0) * scale - 0.5
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    bin_w = rw * _inv(pooled)
    bin_h = rh * _inv(pooled)
    gi = torch.arange(pooled, device=dev)
    gsel = torch.clamp(gi * group // pooled, max=group - 1)
    psel = torch.clamp(gi * part // pooled, max=part - 1)
    if a.no_trans:
        ty = tx = torch.zeros((R, pooled, pooled), dtype=dt, device=dev)
    else:  # class-agnostic offsets: trans channels 0 (y) and 1 (x)
        ty = trans[:, 0][:, psel][:, :, psel] * trans_std
        tx = trans[:, 1][:, psel][:, :, psel] * trans_std
    frac = (torch.arange(sub, dtype=dt, device=dev) + 0.5) * _inv(sub)
    # sample rows (R, by, bx, sy) and columns (R, by, bx, sx)
    ys = (y1[:, None, None, None] +
          (gi.to(dt)[None, :, None, None] + frac) * bin_h[:, None, None, None]
          + (ty * rh[:, None, None])[..., None])
    xs = (x1[:, None, None, None] +
          (gi.to(dt)[None, None, :, None] + frac) * bin_w[:, None, None, None]
          + (tx * rw[:, None, None])[..., None])
    yg = ys[..., :, None].expand(R, pooled, pooled, sub, sub)
    xg = xs[..., None, :].expand(R, pooled, pooled, sub, sub)
    # the channel of output o at bin (by, bx): o * group^2 + gy * group + gx
    chan = (torch.arange(odim, device=dev)[:, None, None] * group * group
            + gsel[None, :, None] * group + gsel[None, None, :])
    bidx = _batch_index(rois[:, 0], N)
    flat = data.reshape(-1)
    x0 = torch.floor(xg)
    y0 = torch.floor(yg)
    wx1 = xg - x0
    wy1 = yg - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    base = (bidx[:, None, None, None] * C + chan[None]) * (H * W)

    def tap(xi, yi, w):  # -> (R, odim, by, bx, sy, sx)
        inside = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        xc = torch.nan_to_num(xi.detach().clamp(0, W - 1)).long()
        yc = torch.nan_to_num(yi.detach().clamp(0, H - 1)).long()
        idx = base[..., None, None] + (yc * W + xc)[:, None]
        return flat[idx] * (w * inside.to(dt))[:, None]

    v = (tap(x0, y0, wx0 * wy0) + tap(x0 + 1, y0, wx1 * wy0) +
         tap(x0, y0 + 1, wx0 * wy1) + tap(x0 + 1, y0 + 1, wx1 * wy1))
    return v.mean(dim=(4, 5))


register("_contrib_DeformablePSROIPooling", _deformable_psroi_pooling,
         arg_names=lambda a: (["data", "rois"] if a.get("no_trans")
                              else ["data", "rois", "trans"]),
         attrs={"spatial_scale": Required(float), "output_dim": Required(int),
                "group_size": Required(int), "pooled_size": Required(int),
                "part_size": 0, "sample_per_part": 4, "trans_std": 0.0,
                "no_trans": False},
         aliases=("DeformablePSROIPooling",))


# ------------------------------------------------------- Proposal (RPN)
def _gen_anchors(base_size, scales, ratios):
    """The RPN's base anchors (A, 4), float32, ratios outer and scales
    inner (mxtpu/ops/spatial.py:426-442)."""
    base = _np.array([0, 0, base_size - 1, base_size - 1], dtype=_np.float32)
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    cx = base[0] + 0.5 * (w - 1)
    cy = base[1] + 0.5 * (h - 1)
    anchors = []
    for r in ratios:
        size = w * h
        ws = _np.round(_np.sqrt(size / r))
        hs = _np.round(ws * r)
        for s in scales:
            wss, hss = ws * s, hs * s
            anchors.append([cx - 0.5 * (wss - 1), cy - 0.5 * (hss - 1),
                            cx + 0.5 * (wss - 1), cy + 0.5 * (hss - 1)])
    return _np.array(anchors, dtype=_np.float32)


def _all_anchors(a, H, W, device):
    """(H * W * A, 4) anchors in the order (y, x, anchor), built once for
    each set of attrs, map size and device and kept: Proposal reads them
    and never writes them."""
    return _anchor_grid(tuple(float(s) for s in a.scales),
                        tuple(float(r) for r in a.ratios),
                        int(a.feature_stride), int(H), int(W),
                        torch.device(device))


@functools.lru_cache(maxsize=16)
def _anchor_grid(scales, ratios, stride, H, W, device):
    anchors = _gen_anchors(stride, scales, ratios)
    sx = _np.arange(W, dtype=_np.float32) * stride
    sy = _np.arange(H, dtype=_np.float32) * stride
    shift_x, shift_y = _np.meshgrid(sx, sy)
    shifts = _np.stack([shift_x, shift_y, shift_x, shift_y],
                       axis=-1).reshape(-1, 4)
    out = (anchors[None, :, :] + shifts[:, None, :]).reshape(-1, 4)
    return torch.from_numpy(out).to(device)


def _proposal_candidates(a, cls_prob, bbox_pred, im_info):
    """Each image's candidates before the sweep (mxtpu/ops/spatial.py
    :445-495): the boxes decoded from ``bbox_pred`` on the anchors and
    clipped to the image, the foreground scores with the boxes under
    ``rpn_min_size`` at -inf, then the stable descending sort and the
    ``rpn_pre_nms_top_n`` cut. Returns (boxes (N, K, 4), scores (N, K)),
    differentiable in ``bbox_pred`` and ``cls_prob``."""
    N, A2, H, W = cls_prob.shape
    A = A2 // 2
    anchors = _all_anchors(a, H, W, cls_prob.device)  # (K, 4)
    fg = cls_prob[:, A:].permute(0, 2, 3, 1).reshape(N, -1)
    deltas = bbox_pred.reshape(N, A, 4, H, W).permute(0, 3, 4, 1, 2) \
        .reshape(N, -1, 4)
    widths = anchors[:, 2] - anchors[:, 0] + 1.0
    heights = anchors[:, 3] - anchors[:, 1] + 1.0
    ctr_x = anchors[:, 0] + 0.5 * (widths - 1.0)
    ctr_y = anchors[:, 1] + 0.5 * (heights - 1.0)
    dx, dy, dw, dh = deltas.unbind(-1)
    pred_ctr_x = dx * widths + ctr_x
    pred_ctr_y = dy * heights + ctr_y
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    zero = torch.zeros((), dtype=fg.dtype, device=fg.device)
    im_h = im_info[:, 0:1]
    im_w = im_info[:, 1:2]

    def clip(v, hi):  # jnp.clip: min(max(v, 0), hi), ties split
        return torch.minimum(torch.maximum(v, zero), hi)

    boxes = torch.stack([
        clip(pred_ctr_x - 0.5 * (pred_w - 1), im_w - 1),
        clip(pred_ctr_y - 0.5 * (pred_h - 1), im_h - 1),
        clip(pred_ctr_x + 0.5 * (pred_w - 1), im_w - 1),
        clip(pred_ctr_y + 0.5 * (pred_h - 1), im_h - 1)], dim=-1)
    ws = boxes[..., 2] - boxes[..., 0] + 1
    hs = boxes[..., 3] - boxes[..., 1] + 1
    min_size = float(a.rpn_min_size) * im_info[:, 2:3]
    keep = (ws >= min_size) & (hs >= min_size)
    fg = torch.where(keep, fg, torch.full_like(fg, float("-inf")))
    K = boxes.shape[1]
    pre = int(a.rpn_pre_nms_top_n)
    pre = min(pre, K) if pre > 0 else K
    order = torch.sort(-fg.detach(), dim=1, stable=True).indices[:, :pre]
    b = torch.gather(boxes, 1, order.unsqueeze(-1).expand(-1, -1, 4))
    return b, torch.gather(fg, 1, order)


def _proposal(a, cls_prob, bbox_pred, im_info):
    """cls_prob (N, 2A, H, W) [background scores, then foreground],
    bbox_pred (N, 4A, H, W), im_info (N, 3) [height, width, scale] ->
    rois (N * post, 5) [image, x1, y1, x2, y2] (and scores (N * post, 1)
    under ``output_score``): the candidates, the suppression sweep, the
    kept ones by score; when fewer than ``rpn_post_nms_top_n`` survive,
    the kept ones again in cycle."""
    N = cls_prob.shape[0]
    post = int(a.rpn_post_nms_top_n)
    if cls_prob.device.type == "meta":
        rois = torch.empty((N * post, 5), dtype=cls_prob.dtype, device="meta")
        if a.output_score:
            return rois, torch.empty((N * post, 1), dtype=cls_prob.dtype,
                                     device="meta")
        return rois
    b, s = _proposal_candidates(a, cls_prob, bbox_pred, im_info)
    keep = nms_keep(b.detach().contiguous(), s.detach().contiguous(),
                    torch.zeros_like(s.detach()), float(a.threshold), True)
    s = torch.where(keep, s, torch.full_like(s, float("-inf")))
    order2 = torch.sort(-s.detach(), dim=1, stable=True).indices[:, :post]
    top = torch.gather(s.detach(), 1, order2)
    num_kept = torch.clamp(torch.isfinite(top).sum(1, keepdim=True), min=1)
    slot = torch.arange(post, device=s.device)[None]
    pick = torch.where(slot < num_kept, slot, slot % num_kept)
    order2 = torch.gather(order2, 1, pick)
    out_boxes = torch.gather(b, 1, order2.unsqueeze(-1).expand(-1, -1, 4))
    top = torch.gather(s, 1, order2)
    scores = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    batch_idx = torch.arange(N, dtype=b.dtype, device=b.device)[:, None,
                                                                None]
    rois = torch.cat([batch_idx.expand(N, post, 1), out_boxes], dim=-1)
    rois = rois.reshape(N * post, 5)
    if a.output_score:
        return rois, scores.reshape(N * post, 1)
    return rois


register("_contrib_Proposal", _proposal,
         arg_names=["cls_prob", "bbox_pred", "im_info"],
         attrs={"rpn_pre_nms_top_n": 6000, "rpn_post_nms_top_n": 300,
                "threshold": 0.7, "rpn_min_size": 16,
                "scales": (4.0, 8.0, 16.0, 32.0), "ratios": (0.5, 1.0, 2.0),
                "feature_stride": 16, "output_score": False,
                "iou_loss": False},
         num_outputs=lambda a: 2 if a.get("output_score") else 1,
         aliases=("Proposal", "_contrib_MultiProposal", "MultiProposal"))


# ------------------------------------------------------------------ krprod
def _khatri_rao(a, *mats):
    """Row-wise Khatri-Rao product: inputs (r, n_i) -> (r, prod n_i)."""
    out = mats[0]
    for m in mats[1:]:
        r = out.shape[0]
        out = (out[:, :, None] * m[:, None, :]).reshape(r, -1)
    return out


register("khatri_rao", _khatri_rao, variadic="num_args",
         attrs={"num_args": Required(int)},
         aliases=("_contrib_krprod", "_khatri_rao"))
