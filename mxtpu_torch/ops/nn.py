"""Neural-network ops of the transformer LM and the image-classification
zoo.

Counterpart of the matching entries of ``mxtpu/ops/nn.py``:
``FullyConnected`` (:37), ``Convolution`` (:83), ``Pooling`` (:193),
``BatchNorm`` (:202-233; in training on the batch's statistics, with
the updated moving statistics returned for the executor to write back),
``LayerNorm`` (:274), ``Activation`` (:295), ``LeakyReLU`` (:313),
``softmax`` and ``log_softmax`` (:320-323), ``SoftmaxOutput`` (:382,
with the loss head's own gradient, :357-377), ``MakeLoss`` (:449, the
identity with a constant gradient), ``Dropout`` (:484, drawing
its mask from ``random.generator``), ``Concat`` (:543), ``SliceChannel``
(:556, alias ``split``) and the sequence ops ``SequenceLast``,
``SequenceMask`` and ``SequenceReverse`` (:638-668, time-major, with
``use_sequence_length``), and the rest of that module: ``Deconvolution``
(:93), ``UpSampling`` (:578), ``Crop`` (:601), ``Pad`` (:563), ``LRN``,
``InstanceNorm``, ``L2Normalization`` (:498-540), ``SoftmaxActivation``,
``softmax_cross_entropy``, the regression heads and ``SVMOutput`` (loss
heads whose backward ignores the head gradient, :402-479) and
``IdentityAttachKLSparseReg`` (:674). Matrix products and
convolutions go to ``torch.nn.functional`` (cuBLAS, cuDNN), as the JAX
package leaves them to XLA; their gradients are torch's autograd.

``bn_relu_inference`` is what the executor runs for an inference
``BatchNorm -> Activation(relu)`` pair: the BN statistics folded into a
per-channel scale and shift, then one pass of the epilogue kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .collective import (GatherAlong, PartialSum, ReplicaSum, SplitAlong,
                         gather_split, sum_replicas)
from .epilogue import bn_apply_relu_add, fold_bn
from .registry import (Required, off_batch_axis, register, set_replicas,
                       set_tp)
from .tensor import _embedding, _in_range, _index_of, relu


def _prod(xs):
    p = 1
    for x in xs:
        p *= x
    return p


# ---------------------------------------------------------------- FullyConnected
def _fully_connected(a, data, weight, bias=None):
    x = data.reshape(data.shape[0], -1) if a.flatten else data
    return F.linear(x, weight, bias)


def _fc_infer(a, shapes):
    data = shapes[0]
    d = data[-1] if not a.flatten else _prod(data[1:])
    out = [data, (int(a.num_hidden), d)]
    if not a.no_bias:
        out.append((int(a.num_hidden),))
    return out


register("FullyConnected", _fully_connected,
         arg_names=lambda a: ["data", "weight"] if a.get("no_bias") else
         ["data", "weight", "bias"],
         attrs={"num_hidden": Required(int), "no_bias": False,
                "flatten": True},
         infer_args=_fc_infer)


# ---------------------------------------------------------------- LayerNorm
def _layer_norm(a, data, gamma, beta):
    """Normalize over one axis with learned scale/shift. The statistics
    are the JAX package's: f32 sum and sum of squares, and the variance
    E[x^2]-E[x]^2 clamped at 0 (mxtpu/ops/nn.py:254-262), so the two
    packages round alike (float64 inputs stay in float64)."""
    ax = int(a.axis) % data.ndim
    n = data.shape[ax]
    x32 = data.to(torch.promote_types(data.dtype, torch.float32))
    s1 = torch.sum(x32, dim=ax, keepdim=True)
    s2 = torch.sum(torch.square(x32), dim=ax, keepdim=True)
    mean = s1 / n
    var = torch.clamp(s2 / n - torch.square(mean), min=0.0)
    inv = torch.rsqrt(var + a.eps)
    bshape = tuple(data.shape[ax] if i == ax else 1
                   for i in range(data.ndim))
    out32 = (x32 - mean) * inv * gamma.to(x32.dtype).reshape(bshape) \
        + beta.to(x32.dtype).reshape(bshape)
    out = out32.to(data.dtype)
    if a.output_mean_var:
        return (out, mean.squeeze(ax).to(data.dtype),
                torch.sqrt(var + a.eps).squeeze(ax).to(data.dtype))
    return out


def _ln_infer(a, shapes):
    data = shapes[0]
    c = (data[int(a.axis) % len(data)],)
    return [data, c, c]


register("LayerNorm", _layer_norm,
         arg_names=["data", "gamma", "beta"],
         attrs={"eps": 1e-5, "axis": -1, "output_mean_var": False},
         num_outputs=lambda a: 3 if a.output_mean_var else 1,
         infer_args=_ln_infer)


# ---------------------------------------------------------------- Activation
def _activation(a, x):
    t = a.act_type
    if t == "relu":
        return relu(x)
    if t == "sigmoid":
        return torch.sigmoid(x)
    if t == "tanh":
        return torch.tanh(x)
    if t == "softrelu":
        return F.softplus(x)
    raise MXNetError("unknown act_type %s" % t)


register("Activation", _activation, attrs={"act_type": Required(str)})


def _leaky_relu(a, x, gamma=None):
    t = a.act_type
    if t == "leaky":
        return torch.where(x > 0, x, a.slope * x)
    if t == "elu":
        return torch.where(x > 0, x, a.slope * (torch.exp(x) - 1))
    if t == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (x.ndim - 2))
        return torch.where(x > 0, x, g * x)
    if t == "rrelu":  # the mean slope, as mxtpu's inference form
        return torch.where(x > 0, x,
                           (a.lower_bound + a.upper_bound) / 2.0 * x)
    raise MXNetError("unknown act_type %s" % t)


register("LeakyReLU", _leaky_relu,
         arg_names=lambda a: ["data", "gamma"] if a.get("act_type") == "prelu"
         else ["data"],
         attrs={"act_type": "leaky", "slope": 0.25, "lower_bound": 0.125,
                "upper_bound": 0.334},
         infer_args=lambda a, shapes: [shapes[0], (shapes[0][1],)]
         if a.act_type == "prelu" else [shapes[0]])


def _softmax_family(f):
    def impl(a, x):
        if a.temperature:
            x = x / a.temperature
        return f(x, dim=int(a.axis))
    return impl


register("softmax", _softmax_family(torch.softmax),
         attrs={"axis": -1, "temperature": None})
register("log_softmax", _softmax_family(torch.log_softmax),
         attrs={"axis": -1, "temperature": None})


# ---------------------------------------------------------------- SoftmaxOutput
def _softmax_fwd(a, data):
    if a.multi_output:
        return torch.softmax(data, dim=1)
    if data.ndim > 2 and not a.preserve_shape:
        return torch.softmax(data.reshape(data.shape[0], -1),
                             dim=-1).reshape(data.shape)
    return torch.softmax(data, dim=-1)


def _valid_rows(a, p, label):
    """1 for each row the loss counts, 0 for a row labelled
    ``ignore_label`` under ``use_ignore``."""
    if label.shape == p.shape:
        return torch.ones(label.shape[:1], dtype=p.dtype, device=p.device)
    idx = label.to(torch.int64)
    if a.use_ignore:
        return (idx != int(a.ignore_label)).to(p.dtype)
    return torch.ones(idx.shape, dtype=p.dtype, device=p.device)


def softmax_output_grad(a, p, label, denom=None):
    """The loss head's gradient (mxtpu/ops/nn.py:357-377, the reference's
    softmax_output-inl.h): ``(p - onehot(label)) * grad_scale``; a label of
    p's shape is the target itself; ``use_ignore`` gives rows labelled
    ``ignore_label`` a zero gradient; ``normalization`` "batch" divides by
    the batch, "valid" by the count of rows not ignored (at least 1).
    ``denom``, given by the replica walk, is that divisor over the whole
    batch of every replica."""
    axis = 1 if a.multi_output else p.ndim - 1
    if label.shape == p.shape:
        target = label.to(p.dtype)
        valid = torch.ones(label.shape[:1], dtype=p.dtype, device=p.device)
    else:
        idx = label.to(torch.int64)
        classes = torch.arange(p.shape[axis], device=p.device).reshape(
            (-1,) + (1,) * (p.ndim - 1 - axis))
        # an out-of-range id (the ignore label) is an all-zero row, as
        # jax.nn.one_hot gives
        target = (idx.unsqueeze(axis) == classes).to(p.dtype)
        if a.use_ignore:
            mask = idx != int(a.ignore_label)
            target = torch.where(mask.unsqueeze(axis), target, p)
            valid = mask.to(p.dtype)
        else:
            valid = torch.ones(idx.shape, dtype=p.dtype, device=p.device)
    grad = (p - target) * a.grad_scale
    if denom is not None:
        grad = grad / denom
    elif a.normalization == "batch":
        grad = grad / p.shape[0]
    elif a.normalization == "valid":
        grad = grad / torch.clamp(valid.sum(), min=1.0)
    return grad.to(p.dtype)


class SoftmaxOutputFunction(torch.autograd.Function):
    """softmax forward; the backward is ``softmax_output_grad`` and
    ignores the incoming head gradient, as a loss head does."""

    @staticmethod
    def forward(ctx, data, label, a, denom=None):
        p = _softmax_fwd(a, data)
        ctx.save_for_backward(p, label)
        ctx.attrs = a
        ctx.denom = denom
        return p

    @staticmethod
    def backward(ctx, grad_out):
        del grad_out
        p, label = ctx.saved_tensors
        return (softmax_output_grad(ctx.attrs, p, label, ctx.denom), None,
                None, None)


def _softmax_output(a, data, label, denom=None):
    """The loss head: softmax forward; under autograd, the gradient of
    ``softmax_output_grad``. The label is read only by the backward."""
    if torch.is_grad_enabled() and data.requires_grad:
        return SoftmaxOutputFunction.apply(data, label, a, denom)
    return _softmax_fwd(a, data)


def _softmax_output_group(a, inputs):
    """SoftmaxOutput over replicas with ``normalization`` "batch" or
    "valid": each replica's gradient divided by the whole batch's count
    (rows, or rows not ignored summed over the replicas with one
    collective), as mxtpu's fused step divides the whole batch's
    gradient."""
    if a.normalization == "batch":
        total = sum(data.shape[0] for data, _ in inputs)
        return [(_softmax_output(a, data, label, total),)
                for data, label in inputs]
    with torch.no_grad():
        counts = [_valid_rows(a, data, label).sum().reshape(1)
                  for data, label in inputs]
        sum_replicas(counts)
    return [(_softmax_output(a, data, label, torch.clamp(c[0], min=1.0)),)
            for (data, label), c in zip(inputs, counts)]


def _label_like_batch(a, shapes):
    data = shapes[0]
    if a.multi_output:
        lbl = (data[0],) + tuple(data[2:])
    else:
        lbl = (data[0],)
    return [data, shapes[1] if shapes[1] is not None else lbl]


register("SoftmaxOutput", _softmax_output,
         arg_names=["data", "label"],
         attrs={"grad_scale": 1.0, "ignore_label": -1.0,
                "multi_output": False, "use_ignore": False,
                "preserve_shape": False, "normalization": "null",
                "out_grad": False, "smooth_alpha": 0.0},
         loss_like=True, aliases=("Softmax",), infer_args=_label_like_batch)


# ---------------------------------------------------------------- MakeLoss
def _make_loss_scale(a, shape, denom=None):
    """MakeLoss's constant gradient (mxtpu/ops/nn.py:436-446):
    ``grad_scale``, divided under "batch" by the rows and under "valid"
    by the element count of the whole input (mxtpu's "valid" does not
    count the elements above ``valid_thresh`` as the reference MXNet
    does, ROADMAP C). ``denom``, given by the replica walk, is that
    divisor over every replica."""
    if denom is not None:
        return a.grad_scale / denom
    if a.normalization == "batch":
        return a.grad_scale / shape[0]
    if a.normalization == "valid":
        return a.grad_scale / max(1, _prod(shape))
    return a.grad_scale


class MakeLossFunction(torch.autograd.Function):
    """The identity forward; the backward ignores the incoming head
    gradient and returns the constant ``scale`` everywhere."""

    @staticmethod
    def forward(ctx, data, scale):
        ctx.scale = scale
        return data.view_as(data)

    @staticmethod
    def backward(ctx, grad_out):
        return torch.full_like(grad_out, ctx.scale), None


def _make_loss(a, data, denom=None):
    if torch.is_grad_enabled() and data.requires_grad:
        return MakeLossFunction.apply(
            data, _make_loss_scale(a, tuple(data.shape), denom))
    return data


def _make_loss_group(a, inputs):
    """MakeLoss over replicas under "batch" or "valid": each replica's
    gradient divided by the whole batch's rows or elements."""
    dims = [tuple(x.shape) for (x,) in inputs]
    total = sum(d[0] for d in dims) if a.normalization == "batch" else \
        max(1, sum(_prod(d) for d in dims))
    return [(_make_loss(a, x, total),) for (x,) in inputs]


register("MakeLoss", _make_loss,
         attrs={"grad_scale": 1.0, "valid_thresh": 0.0,
                "normalization": "null"},
         loss_like=True)


# ---------------------------------------------------------------- Dropout
def _dropout(a, gen, x):
    """Inverted dropout in training: keep each element with probability
    ``1 - p`` and scale the kept ones by ``1 / (1 - p)``. The mask is drawn
    from the device's generator (``random.generator``), so runs repeat
    under ``random.seed``; at inference, or with p <= 0, the identity."""
    if not a.get("__is_train__", False) or a.p <= 0:
        return x
    if gen is None:  # meta tensors: shape inference
        return torch.empty_like(x)
    keep = 1.0 - a.p
    u = torch.rand(x.shape, generator=gen, device=x.device)
    return x * ((u < keep).to(x.dtype) / keep)


register("Dropout", _dropout, attrs={"p": 0.5, "__is_train__": False},
         needs_rng=True)


# ---------------------------------------------------------------- Convolution
def _tup(v, n, default):
    v = tuple(v) if v else ()
    if len(v) < n:
        v = v + (default,) * (n - len(v))
    return v[:n]


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _convolution(a, data, weight, bias=None):
    """N-d convolution. ``layout="NHWC"`` keeps the weight in its OIHW
    storage and moves only the activation: the data is viewed as NCHW for
    the call and the result viewed back, with no copy of the weight."""
    nd = len(a.kernel)
    channels_last = nd == 2 and a.layout == "NHWC"
    x = data.permute(0, 3, 1, 2) if channels_last else data
    out = _CONV[nd](x, weight, bias, stride=_tup(a.stride, nd, 1),
                    padding=_tup(a.pad, nd, 0),
                    dilation=_tup(a.dilate, nd, 1), groups=int(a.num_group))
    return out.permute(0, 2, 3, 1) if channels_last else out


def _conv_infer(a, shapes):
    data = shapes[0]
    c = data[-1] if a.layout == "NHWC" else data[1]
    out = [data, (int(a.num_filter), c // int(a.num_group)) + tuple(a.kernel)]
    if not a.no_bias:
        out.append((int(a.num_filter),))
    return out


register("Convolution", _convolution,
         arg_names=lambda a: ["data", "weight"] if a.get("no_bias") else
         ["data", "weight", "bias"],
         attrs={"kernel": Required(tuple), "stride": (), "dilate": (),
                "pad": (), "num_filter": Required(int), "num_group": 1,
                "no_bias": False, "workspace": 1024, "cudnn_tune": None,
                "cudnn_off": False, "layout": None},
         aliases=("Convolution_v1",), infer_args=_conv_infer)


# ---------------------------------------------------------------- Pooling
def _pool_pads(in_shape, kernel, stride, pad, convention):
    """Per-dim (lo, hi) padding; 'full' (ceil) convention pads extra on
    the high side (a copy of mxtpu/ops/nn.py:_pool_pads)."""
    pads = []
    for x, k, s, p in zip(in_shape, kernel, stride, pad):
        if convention == "full":
            out = -(-(x + 2 * p - k) // s) + 1  # ceil
        else:
            out = (x + 2 * p - k) // s + 1
        needed = max((out - 1) * s + k - x - p, p)
        pads.append((p, needed))
    return pads


def _window(x, kernel, stride, kind):
    """Max or sum over unpadded windows of the trailing len(kernel) dims."""
    if len(kernel) == 1:
        return _window(x.unsqueeze(-2), (1,) + kernel, (1,) + stride,
                       kind).squeeze(-2)
    if kind == "max":
        pool = F.max_pool2d if len(kernel) == 2 else F.max_pool3d
        return pool(x, kernel, stride)
    pool = F.avg_pool2d if len(kernel) == 2 else F.avg_pool3d
    return pool(x, kernel, stride, divisor_override=1)


def _pooling(a, data):
    """Pooling padded as the JAX op pads (``_pool_pads``: -inf for max,
    0 for avg/sum) and then windowed with no padding of torch's own, so
    both conventions agree; avg divides by the full window, padding
    included."""
    nd = data.ndim - 2
    channels_last = nd == 2 and a.layout == "NHWC"
    x = data.permute(0, 3, 1, 2) if channels_last else data
    spatial = tuple(x.shape[2:])
    if a.global_pool:
        kernel, stride, pad = spatial, (1,) * nd, (0,) * nd
    else:
        kernel = _tup(a.kernel, nd, 1)
        stride = _tup(a.stride, nd, 1)
        pad = _tup(a.pad, nd, 0)
    flat = []
    for lo, hi in reversed(_pool_pads(spatial, kernel, stride, pad,
                                      a.pooling_convention)):
        flat += [lo, hi]
    is_max = a.pool_type == "max"
    if any(flat):
        x = F.pad(x, flat, value=float("-inf") if is_max else 0.0)
    out = _window(x, kernel, stride, "max" if is_max else "sum")
    if a.pool_type == "avg":
        denom = 1
        for k in kernel:
            denom *= k
        out = out / denom
    elif not is_max and a.pool_type != "sum":
        raise MXNetError("unknown pool_type %s" % a.pool_type)
    return out.permute(0, 2, 3, 1) if channels_last else out


register("Pooling", _pooling,
         attrs={"kernel": (), "pool_type": "max", "global_pool": False,
                "stride": (), "pad": (), "pooling_convention": "valid",
                "cudnn_off": False, "layout": None},
         aliases=("Pooling_v1",))


# ---------------------------------------------------------------- BatchNorm
def _refuse_training(a):
    if a.get("__is_train__", False):
        raise MXNetError("the fused BatchNorm->ReLU step runs at inference "
                         "only; a training forward runs BatchNorm and "
                         "Activation as two ops")


def _bn_global(a):
    """Whether BatchNorm normalizes by its moving statistics (inference,
    or use_global_stats) rather than the batch's."""
    return a.use_global_stats or not a.get("__is_train__", False)


def _bn_sums(a, data):
    """(sum, sum of squares, count) over every axis but the channel's, in
    float32 (float64 for float64 data): BatchNorm's one pass."""
    ax = int(a.axis) % data.ndim
    red = tuple(i for i in range(data.ndim) if i != ax)
    x32 = data.to(torch.promote_types(data.dtype, torch.float32))
    return (torch.sum(x32, dim=red), torch.sum(torch.square(x32), dim=red),
            _prod(data.shape[i] for i in red))


def _batch_norm(a, data, gamma, beta, moving_mean, moving_var, sums=None):
    """BatchNorm in the JAX arithmetic (mxtpu/ops/nn.py:202-233):
    ``(x - mean) * (g * inv) + beta`` with ``inv = rsqrt(var + eps)`` and
    ``g = 1`` under fix_gamma. At inference, or with use_global_stats,
    mean and var are the moving statistics, returned unchanged as the
    aux values. In training they are the batch's, from one pass: a sum
    and a sum of squares in float32 (float64 for float64 data), the
    variance ``max(s2/n - mean^2, 0)``, both cast to the data type; the
    gradient flows through them by autograd, and the moving statistics
    move by ``m * moving + (1 - m) * stat`` with the stat detached.
    Returns the visible outputs (out, and with output_mean_var the mean
    and var used), then the new moving_mean and moving_var. ``sums``,
    given by the replica walk, are the whole batch's ``_bn_sums``."""
    ax = int(a.axis) % data.ndim
    bshape = tuple(data.shape[ax] if i == ax else 1 for i in range(data.ndim))
    g = torch.ones_like(gamma) if a.fix_gamma else gamma
    wide = torch.promote_types(data.dtype, torch.float32)
    if _bn_global(a):
        mean, var = moving_mean, moving_var
        new_mm, new_mv = moving_mean, moving_var
    else:
        s1, s2, n = _bn_sums(a, data) if sums is None else sums
        mean32 = s1 / n
        var32 = s2 / n - torch.square(mean32)
        # maximum, not clamp: at a tie (var exactly 0) both jnp.maximum
        # and torch.maximum pass half the gradient, clamp all of it
        var32 = torch.maximum(var32, torch.zeros_like(var32))
        mean, var = mean32.to(data.dtype), var32.to(data.dtype)
        m = a.momentum
        new_mm = m * moving_mean + (1 - m) * mean.detach()
        new_mv = m * moving_var + (1 - m) * var.detach()
    inv = torch.rsqrt(var.to(wide) + a.eps).to(data.dtype)
    out = (data - mean.reshape(bshape)) * (g * inv).reshape(bshape) \
        + beta.reshape(bshape)
    if a.output_mean_var:
        return out, mean, var, new_mm, new_mv
    return out, new_mm, new_mv


def _batch_norm_group(a, inputs):
    """BatchNorm in training over replicas, on the whole batch's
    statistics as mxtpu's fused step computes them: each replica's sum
    and sum of squares, stacked, are summed over the replicas with one
    collective (``collective.ReplicaSum``: differentiable, so one backward
    over every replica carries the cross-replica terms of the statistics'
    gradient, with one collective again); every replica then normalizes,
    and moves its moving statistics, from the same bits."""
    parts = [_bn_sums(a, ins[0]) for ins in inputs]
    sums = ReplicaSum.apply(*[torch.stack(p[:2]) for p in parts])
    n = sum(p[2] for p in parts)
    return [_batch_norm(a, *ins, sums=(s[0], s[1], n))
            for ins, s in zip(inputs, sums)]


def _bn_infer(a, shapes):
    c = (shapes[0][int(a.axis)],)
    return [shapes[0], c, c, c, c]


register("BatchNorm", _batch_norm,
         arg_names=["data", "gamma", "beta", "moving_mean", "moving_var"],
         aux_names=["moving_mean", "moving_var"],
         attrs={"eps": 1e-3, "momentum": 0.9, "fix_gamma": True,
                "use_global_stats": False, "output_mean_var": False,
                "axis": 1, "__is_train__": False},
         num_outputs=lambda a: 3 if a.output_mean_var else 1,
         aliases=("BatchNorm_v1",), infer_args=_bn_infer)


def _dense(x, axis):
    """(x or a permuted view of it that is contiguous, where ``axis``
    lands, the permutation back): a channels-last result viewed as NCHW
    is already dense in memory, so the kernel takes it without a copy."""
    if x.is_contiguous():
        return x, axis, None
    order = sorted(range(x.ndim), key=lambda d: -x.stride(d))
    xp = x.permute(order)
    if not xp.is_contiguous():
        xp = xp.contiguous()
    back = [order.index(d) for d in range(x.ndim)]
    return xp, order.index(axis), back


def bn_relu_inference(a, data, gamma, beta, moving_mean, moving_var):
    """``Activation(relu)(BatchNorm(...))`` at inference as one epilogue
    pass: ``fold_bn`` on the moving statistics (gamma = 1 under
    fix_gamma) gives the f32 per-channel scale and shift, and
    ``bn_apply_relu_add`` applies them with the ReLU. It rounds as
    ``x * scale + shift`` where the BatchNorm op rounds as
    ``(x - mean) * (g * inv) + beta``."""
    _refuse_training(a)
    f32 = torch.float32
    g = torch.ones_like(gamma, dtype=f32) if a.fix_gamma else gamma.to(f32)
    scale, shift = fold_bn(g, beta.to(f32), moving_mean.to(f32),
                           moving_var.to(f32), a.eps)
    x, axis, back = _dense(data, int(a.axis) % data.ndim)
    y = bn_apply_relu_add(x, scale.contiguous(), shift.contiguous(),
                          axis=axis)
    return y if back is None else y.permute(back)


# ---------------------------------------------------------------- Concat
register("Concat", lambda a, *xs: torch.cat(xs, dim=int(a.dim)),
         variadic="num_args", attrs={"num_args": Required(int), "dim": 1},
         aliases=("concat",))


def _slice_channel(a, x):
    ax, n = int(a.axis), int(a.num_outputs)
    if x.shape[ax] % n:
        raise MXNetError("SliceChannel: axis %d of size %d does not split "
                         "into %d equal parts" % (ax, x.shape[ax], n))
    parts = x.split(x.shape[ax] // n, dim=ax)
    if a.squeeze_axis:
        parts = [p.squeeze(ax) for p in parts]
    return tuple(parts)


register("SliceChannel", _slice_channel,
         attrs={"num_outputs": Required(int), "axis": 1,
                "squeeze_axis": False},
         num_outputs=lambda a: int(a.num_outputs), aliases=("split",))


# ---------------------------------------------------------------- sequences
def _seq_lengths(data, sequence_length):
    """The lengths (N,) as int64, shaped to broadcast over (T, N, ...)."""
    return sequence_length.to(torch.int64).reshape(
        (1, -1) + (1,) * (data.ndim - 2))


def _sequence_last(a, data, sequence_length=None):
    if not a.use_sequence_length or sequence_length is None:
        return data[-1]
    idx = (_seq_lengths(data, sequence_length) - 1).expand(
        (1,) + tuple(data.shape[1:]))
    return torch.gather(data, 0, idx)[0]


def _sequence_mask(a, data, sequence_length=None):
    if not a.use_sequence_length or sequence_length is None:
        return data
    t = torch.arange(data.shape[0], device=data.device).reshape(
        (-1,) + (1,) * (data.ndim - 1))
    return torch.where(t < _seq_lengths(data, sequence_length), data,
                       torch.full((), a.value, dtype=data.dtype,
                                  device=data.device))


def _sequence_reverse(a, data, sequence_length=None):
    if not a.use_sequence_length or sequence_length is None:
        return torch.flip(data, dims=(0,))
    t = torch.arange(data.shape[0], device=data.device).reshape(
        (-1,) + (1,) * (data.ndim - 1))
    lens = _seq_lengths(data, sequence_length)
    src = torch.where(t < lens, lens - 1 - t, t)
    return torch.gather(data, 0, src.expand(data.shape))


def _seq_args(a):
    return ["data", "sequence_length"] if a.get("use_sequence_length") \
        else ["data"]


register("SequenceLast", _sequence_last, arg_names=_seq_args,
         attrs={"use_sequence_length": False})
register("SequenceMask", _sequence_mask, arg_names=_seq_args,
         attrs={"use_sequence_length": False, "value": 0.0})
register("SequenceReverse", _sequence_reverse, arg_names=_seq_args,
         attrs={"use_sequence_length": False})


# --------------------------------------------------------------- Deconvolution
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _deconvolution(a, data, weight, bias=None):
    """Transposed convolution with the weight in MXNet's (C_in, C_out/g,
    *k) layout, which is torch's (mxtpu/ops/nn.py:93). torch's own
    padding takes ``adj`` only below the stride, so the full output
    (no padding) is computed and cut to mxtpu's window: ``pad`` off the
    low end, the size ``(in-1)*s - 2*pad + d*(k-1) + 1 + adj`` (``adj``
    from ``target_shape`` when that is given), zeros past the full
    output's end where ``adj`` exceeds ``pad``."""
    nd = len(a.kernel)
    k = tuple(int(x) for x in a.kernel)
    stride, dilate = _tup(a.stride, nd, 1), _tup(a.dilate, nd, 1)
    pad, adj = _tup(a.pad, nd, 0), _tup(a.adj, nd, 0)
    ke = tuple(dilate[i] * (k[i] - 1) + 1 for i in range(nd))
    if a.target_shape:
        tgt = _tup(a.target_shape, nd, 0)
        adj = tuple(tgt[i] - ((data.shape[2 + i] - 1) * stride[i]
                              - 2 * pad[i] + ke[i]) for i in range(nd))
    out = _CONV_T[nd](data, weight, None, stride=stride, dilation=dilate,
                      groups=int(a.num_group))
    flat = []
    for i in reversed(range(nd)):
        full = out.shape[2 + i]
        flat += [-pad[i], (full - pad[i] + adj[i]) - full]
    out = F.pad(out, flat)
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return out


def _deconv_infer(a, shapes):
    data = shapes[0]
    out = [data, (data[1], int(a.num_filter) // int(a.num_group))
           + tuple(a.kernel)]
    if not a.no_bias:
        out.append((int(a.num_filter),))
    return out


register("Deconvolution", _deconvolution,
         arg_names=lambda a: ["data", "weight"] if a.get("no_bias", True)
         else ["data", "weight", "bias"],
         attrs={"kernel": Required(tuple), "stride": (), "dilate": (),
                "pad": (), "adj": (), "target_shape": (),
                "num_filter": Required(int), "num_group": 1,
                "no_bias": True, "workspace": 512, "cudnn_tune": None,
                "cudnn_off": False, "layout": None},
         infer_args=_deconv_infer)


# ---------------------------------------------------------------- UpSampling
def _upsampling(a, *xs):
    """"nearest": each input repeated ``scale`` times along H and W, the
    results concatenated on the channels (mxtpu concatenates under either
    ``multi_input_mode``); "bilinear": the first input resized by
    ``scale`` with half-pixel centers (``jax.image.resize``'s), the
    weight input unread (mxtpu/ops/nn.py:578)."""
    s = int(a.scale)
    if a.sample_type == "nearest":
        outs = [x.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)
                for x in xs]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return F.interpolate(xs[0], scale_factor=s, mode="bilinear",
                         align_corners=False)


register("UpSampling", _upsampling, variadic="num_args",
         attrs={"num_args": 1, "scale": Required(int),
                "sample_type": "nearest", "num_filter": 0,
                "multi_input_mode": "concat", "workspace": 512})


def _crop(a, *xs):
    """The H x W window of x (the second input's H and W, or ``h_w``) at
    ``offset`` or centred (mxtpu/ops/nn.py:601)."""
    x = xs[0]
    h, w = (xs[1].shape[2], xs[1].shape[3]) if len(xs) == 2 else \
        (int(a.h_w[0]), int(a.h_w[1]))
    if a.center_crop:
        y0, x0 = (x.shape[2] - h) // 2, (x.shape[3] - w) // 2
    else:
        y0, x0 = int(a.offset[0]), int(a.offset[1])
    return x[:, :, y0:y0 + h, x0:x0 + w]


register("Crop", _crop, variadic="num_args",
         attrs={"num_args": 1, "offset": (0, 0), "h_w": (0, 0),
                "center_crop": False})


def _pad_index(n, lo, hi, mode, device):
    """The source index of each position of an axis of ``n`` padded by
    (lo, hi): clamped for "edge", mirrored without repeating the edge
    (numpy's "reflect", folding again past the far end) for "reflect"."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge" or n == 1:
        return torch.clamp(i, 0, n - 1)
    j = torch.remainder(i, 2 * (n - 1))
    return torch.where(j < n, j, 2 * (n - 1) - j)


def _pad(a, x):
    """``pad_width`` holds (before, after) per axis. "constant" fills
    ``constant_value``; "edge" and "reflect" read the source positions of
    ``_pad_index`` along each padded axis (any axis, as jnp.pad)."""
    pw = a.pad_width
    pairs = [(int(pw[2 * i]), int(pw[2 * i + 1])) for i in range(x.ndim)]
    if a.mode == "constant":
        flat = [v for p in reversed(pairs) for v in p]
        return F.pad(x, flat, value=a.constant_value)
    if a.mode not in ("edge", "reflect"):
        raise MXNetError("Pad: unknown mode %s" % a.mode)
    for d, (lo, hi) in enumerate(pairs):
        if lo or hi:
            x = torch.index_select(
                x, d, _pad_index(x.shape[d], lo, hi, a.mode, x.device))
    return x


register("Pad", _pad,
         attrs={"mode": Required(str), "pad_width": Required(tuple),
                "constant_value": 0.0},
         aliases=("pad",))


# --------------------------------------------------------------- normalization
def _lrn(a, x):
    """``x * (knorm + alpha/n * window_sum(x^2))^-beta`` over ``nsize``
    channels, zero-padded by n//2 on each side (mxtpu/ops/nn.py:498)."""
    n = int(a.nsize)
    sq = F.pad(torch.square(x).movedim(1, -1), (n // 2, n // 2))
    s = sq.unfold(-1, n, 1).sum(-1).movedim(-1, 1)
    return x * torch.pow(a.knorm + (a.alpha / n) * s, -a.beta)


register("LRN", _lrn,
         attrs={"alpha": 1e-4, "beta": 0.75, "knorm": 2.0,
                "nsize": Required(int)})


def _instance_norm(a, x, gamma, beta):
    red = tuple(range(2, x.ndim))
    mean = torch.mean(x, dim=red, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=red, keepdim=True)
    bshape = (1, -1) + (1,) * (x.ndim - 2)
    return (x - mean) * torch.rsqrt(var + a.eps) * gamma.reshape(bshape) \
        + beta.reshape(bshape)


register("InstanceNorm", _instance_norm, arg_names=["data", "gamma", "beta"],
         attrs={"eps": 1e-3},
         infer_args=lambda a, shapes: [shapes[0], (shapes[0][1],),
                                       (shapes[0][1],)])


def _l2_normalization(a, x):
    """x over sqrt(sum(x^2) + eps) along the channel axis ("channel"),
    the spatial axes ("spatial") or all but the batch ("instance")."""
    red = {"channel": (1,), "spatial": tuple(range(2, x.ndim))}.get(
        a.mode, tuple(range(1, x.ndim)))
    return x / torch.sqrt(torch.sum(torch.square(x), dim=red, keepdim=True)
                          + a.eps)


register("L2Normalization", _l2_normalization,
         attrs={"eps": 1e-10, "mode": "instance"})


def _softmax_activation(a, x):
    if a.mode == "channel":
        return torch.softmax(x, dim=1)
    return torch.softmax(x.reshape(x.shape[0], -1), dim=-1).reshape(x.shape)


register("SoftmaxActivation", _softmax_activation, attrs={"mode": "instance"})


def _softmax_cross_entropy(a, data, label):
    """``-sum(log_softmax(data)[i, label[i]])``; a label outside
    [-n, n) reads NaN, one in [-n, 0) wraps (jnp's take_along_axis)."""
    logp = torch.log_softmax(data, dim=-1)
    idx, valid = _in_range(_index_of(label), data.shape[-1])
    picked = torch.take_along_dim(logp, idx.unsqueeze(-1), dim=-1)
    return -torch.sum(torch.where(valid.unsqueeze(-1), picked, float("nan")))


register("softmax_cross_entropy", _softmax_cross_entropy,
         arg_names=["data", "label"], attrs={})


# ---------------------------------------------------------------- loss heads
class _HeadFunction(torch.autograd.Function):
    """A loss head: ``forward(data)`` is the op's output, and the backward
    ignores the incoming gradient and returns ``grad(out, data, label)``
    (mxtpu's ``jax.custom_vjp`` heads, mxtpu/ops/nn.py:402-479)."""

    @staticmethod
    def forward(ctx, data, label, a, link, grad):
        out = link(data)
        ctx.save_for_backward(out, data, label)
        ctx.attrs, ctx.grad = a, grad
        return out

    @staticmethod
    def backward(ctx, grad_out):
        del grad_out
        out, data, label = ctx.saved_tensors
        g = ctx.grad(ctx.attrs, out, data, label)
        return g.to(out.dtype), None, None, None, None


def _head(link, grad):
    def impl(a, data, label):
        if torch.is_grad_enabled() and data.requires_grad:
            return _HeadFunction.apply(data, label, a, link, grad)
        return link(data)
    return impl


def _regression_grad(fn):
    """``fn(out, label) * grad_scale``, the label reshaped to the
    output's shape where they differ (regression_output-inl.h)."""
    def grad(a, out, data, label):
        lab = label.reshape(out.shape) if label.shape != out.shape \
            else label
        return fn(out, lab.to(out.dtype)) * a.grad_scale
    return grad


def _label_like_data(a, shapes):
    return [shapes[0], shapes[1] if shapes[1] is not None else shapes[0]]


for _n, _link, _g in [
        ("LinearRegressionOutput", lambda x: x, lambda o, l: o - l),
        ("LogisticRegressionOutput", torch.sigmoid, lambda o, l: o - l),
        ("MAERegressionOutput", lambda x: x,
         lambda o, l: torch.sign(o - l))]:
    register(_n, _head(_link, _regression_grad(_g)),
             arg_names=["data", "label"], attrs={"grad_scale": 1.0},
             loss_like=True, infer_args=_label_like_data)


def _svm_grad(a, out, data, label):
    """The hinge's gradient (mxtpu/ops/nn.py:463): ``s = 1 - 2 onehot``
    (an out-of-range label is an all-zero one-hot row), linear:
    ``s * [s x + margin > 0]``, squared: ``2 max(s x + margin, 0) s``;
    times ``regularization_coefficient``."""
    classes = torch.arange(data.shape[-1], device=data.device)
    onehot = (label.to(torch.int64).unsqueeze(-1) == classes).to(data.dtype)
    s = 1 - onehot * 2
    dist = s * data + a.margin
    if a.use_linear:
        g = (dist > 0).to(data.dtype) * s
    else:
        g = 2 * torch.clamp(dist, min=0) * s
    return g * a.regularization_coefficient


register("SVMOutput", _head(lambda x: x.view_as(x), _svm_grad),
         arg_names=["data", "label"],
         attrs={"margin": 1.0, "regularization_coefficient": 1.0,
                "use_linear": False},
         loss_like=True, infer_args=_label_like_batch)
# the identity, with no penalty in the gradient, as mxtpu's
register("IdentityAttachKLSparseReg", lambda a, x: x.view_as(x),
         attrs={"sparseness_target": 0.1, "penalty": 0.001,
                "momentum": 0.9})


# ---------------------------------------------------------------- replicas
set_replicas(["SliceChannel", "split"],
             lambda a, nd: off_batch_axis(a.axis, nd))
set_replicas(["FullyConnected", "Activation", "LeakyReLU", "Dropout",
              "Convolution", "Convolution_v1", "Pooling", "Pooling_v1"])
set_replicas(["LayerNorm", "softmax", "log_softmax"],
             lambda a, nd: off_batch_axis(a.axis, nd))
set_replicas(["Concat", "concat"], lambda a, nd: off_batch_axis(a.dim, nd))
set_replicas(["SoftmaxOutput", "Softmax"],
             lambda a, nd: a.normalization == "null",
             group_fn=_softmax_output_group)
set_replicas(["MakeLoss"], lambda a, nd: a.normalization == "null",
             group_fn=_make_loss_group)
set_replicas(["BatchNorm", "BatchNorm_v1"], lambda a, nd: _bn_global(a),
             group_fn=_batch_norm_group)
set_replicas(["Deconvolution", "UpSampling", "Crop", "LRN", "InstanceNorm",
              "SoftmaxActivation", "LinearRegressionOutput",
              "LogisticRegressionOutput", "MAERegressionOutput", "SVMOutput",
              "IdentityAttachKLSparseReg", "L2Normalization"])
set_replicas(["Pad", "pad"], lambda a, nd: not any(a.pad_width[:2]))



# ---------------------------------------------------------------- tp
def _tp_weight(split, layout, dim):
    """The split weight's name when it is input 1, alone split, and the
    tp axis alone splits its dimension ``dim`` (and no other); else
    None."""
    tp = layout.tp_axis
    name = split.get(1)
    if tp is None or name is None or set(split) != {1}:
        return None
    entries = layout.specs[name]
    if len(entries) <= dim or entries[dim] != (tp,) or any(
            tp in e for d, e in enumerate(entries) if d != dim):
        return None
    return name


def _partial_products(inputs, w, layout, cdim, fn):
    """The tp pattern of an op whose weight splits its input features:
    each replica's block of the features (``SplitAlong`` on ``cdim``)
    through ``fn`` with its block of the weight, one sum over the tp
    group (``PartialSum``), then the replicated bias."""
    tp = layout.tp_axis
    groups = layout.groups((tp,))
    xs = SplitAlong.apply(cdim, groups, tp, *[x[0] for x in inputs])
    return PartialSum.apply(groups, tp,
                            *[fn(x, wt) for x, wt in zip(xs, w)])


def _fc_tp(a, inputs, split, layout):
    """FullyConnected with its weight's input features (dim 1) over tp:
    ``y = sum_t x_t W_t^T + b``. The forward is one all-reduce over the
    tp group, its backward one all-gather of dx; dW stays local."""
    name = _tp_weight(split, layout, 1)
    if name is None:
        return None
    w = gather_split([x[1] for x in inputs], name, layout, keep=(1,))
    if a.flatten:
        inputs = [(x[0].reshape(x[0].shape[0], -1),) + tuple(x[1:])
                  for x in inputs]
    y = _partial_products(inputs, w, layout, inputs[0][0].ndim - 1,
                          F.linear)
    if not a.no_bias:
        y = [t + x[2] for t, x in zip(y, inputs)]
    return [(t,) for t in y]


def _conv_tp(a, inputs, split, layout):
    """Convolution (one group) with its weight's input channels (dim 1)
    over tp: the partial sums of ``_fc_tp``, channel by channel."""
    name = _tp_weight(split, layout, 1)
    if name is None or int(a.num_group) != 1:
        return None
    w = gather_split([x[1] for x in inputs], name, layout, keep=(1,))
    x0 = inputs[0][0]
    channels_last = len(a.kernel) == 2 and a.layout == "NHWC"
    cdim = x0.ndim - 1 if channels_last else 1
    y = _partial_products(inputs, w, layout, cdim,
                          lambda x, wt: _convolution(a, x, wt))
    if not a.no_bias:
        shape = [1] * x0.ndim
        shape[cdim] = -1
        y = [t + x[2].view(shape) for t, x in zip(y, inputs)]
    return [(t,) for t in y]


def _embedding_tp(a, inputs, split, layout):
    """Embedding with its weight's columns (dim 1) over tp: each replica
    looks up its columns, then one all-gather along the last axis over
    the tp group (its backward: each peer's own columns)."""
    name = _tp_weight(split, layout, 1)
    if name is None:
        return None
    w = gather_split([x[1] for x in inputs], name, layout, keep=(1,))
    rows = [_embedding(a, x[0], wt) for x, wt in zip(inputs, w)]
    tp = layout.tp_axis
    out = GatherAlong.apply(rows[0].ndim - 1, layout.groups((tp,)), False,
                            tp, *rows)
    return [(t,) for t in out]


set_tp(["FullyConnected"], _fc_tp)
set_tp(["Convolution"], _conv_tp)
set_tp(["Embedding"], _embedding_tp)
