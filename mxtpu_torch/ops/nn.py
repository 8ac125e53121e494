"""Neural-network ops of the transformer LM and the image-classification
zoo.

Counterpart of the matching entries of ``mxtpu/ops/nn.py``:
``FullyConnected`` (:37), ``Convolution`` (:83), ``Pooling`` (:193),
``BatchNorm`` (:202-233; in training on the batch's statistics, with
the updated moving statistics returned for the executor to write back),
``LayerNorm`` (:274), ``Activation`` (:295), ``LeakyReLU`` (:313),
``softmax`` and ``log_softmax`` (:320-323), ``SoftmaxOutput`` (:382,
with the loss head's own gradient, :357-377), ``Dropout`` (:484, drawing
its mask from ``random.generator``) and ``Concat`` (:543). Matrix products and
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
from .epilogue import bn_apply_relu_add, fold_bn
from .registry import Required, register


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
        return torch.relu(x)
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


def softmax_output_grad(a, p, label):
    """The loss head's gradient (mxtpu/ops/nn.py:357-377, the reference's
    softmax_output-inl.h): ``(p - onehot(label)) * grad_scale``; a label of
    p's shape is the target itself; ``use_ignore`` gives rows labelled
    ``ignore_label`` a zero gradient; ``normalization`` "batch" divides by
    the batch, "valid" by the count of rows not ignored (at least 1)."""
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
    if a.normalization == "batch":
        grad = grad / p.shape[0]
    elif a.normalization == "valid":
        grad = grad / torch.clamp(valid.sum(), min=1.0)
    return grad.to(p.dtype)


class SoftmaxOutputFunction(torch.autograd.Function):
    """softmax forward; the backward is ``softmax_output_grad`` and
    ignores the incoming head gradient, as a loss head does."""

    @staticmethod
    def forward(ctx, data, label, a):
        p = _softmax_fwd(a, data)
        ctx.save_for_backward(p, label)
        ctx.attrs = a
        return p

    @staticmethod
    def backward(ctx, grad_out):
        del grad_out
        p, label = ctx.saved_tensors
        return softmax_output_grad(ctx.attrs, p, label), None, None


def _softmax_output(a, data, label):
    """The loss head: softmax forward; under autograd, the gradient of
    ``softmax_output_grad``. The label is read only by the backward."""
    if torch.is_grad_enabled() and data.requires_grad:
        return SoftmaxOutputFunction.apply(data, label, a)
    return _softmax_fwd(a, data)


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


def _batch_norm(a, data, gamma, beta, moving_mean, moving_var):
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
    and var used), then the new moving_mean and moving_var."""
    ax = int(a.axis) % data.ndim
    bshape = tuple(data.shape[ax] if i == ax else 1 for i in range(data.ndim))
    g = torch.ones_like(gamma) if a.fix_gamma else gamma
    wide = torch.promote_types(data.dtype, torch.float32)
    if a.use_global_stats or not a.get("__is_train__", False):
        mean, var = moving_mean, moving_var
        new_mm, new_mv = moving_mean, moving_var
    else:
        red = tuple(i for i in range(data.ndim) if i != ax)
        n = _prod(data.shape[i] for i in red)
        x32 = data.to(wide)
        mean32 = torch.sum(x32, dim=red) / n
        var32 = torch.sum(torch.square(x32), dim=red) / n \
            - torch.square(mean32)
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
