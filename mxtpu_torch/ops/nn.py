"""Neural-network ops the transformer LM's serving path uses.

Counterpart of the matching entries of ``mxtpu/ops/nn.py``:
``FullyConnected`` (:37), ``LayerNorm`` (:274), ``Activation`` (:295),
``SoftmaxOutput`` (:382, forward only: the loss head's custom gradient
arrives with training) and ``Dropout`` (:492). Matrix products go to
``torch.nn.functional.linear``, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
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
    packages round alike."""
    ax = int(a.axis) % data.ndim
    n = data.shape[ax]
    x32 = data.to(torch.float32)
    s1 = torch.sum(x32, dim=ax, keepdim=True)
    s2 = torch.sum(torch.square(x32), dim=ax, keepdim=True)
    mean = s1 / n
    var = torch.clamp(s2 / n - torch.square(mean), min=0.0)
    inv = torch.rsqrt(var + a.eps)
    bshape = tuple(data.shape[ax] if i == ax else 1
                   for i in range(data.ndim))
    out32 = (x32 - mean) * inv * gamma.to(torch.float32).reshape(bshape) \
        + beta.to(torch.float32).reshape(bshape)
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


# ---------------------------------------------------------------- SoftmaxOutput
def _softmax_output(a, data, label):
    """Forward of the loss head: softmax; the label is not read."""
    del label
    if a.multi_output:
        return torch.softmax(data, dim=1)
    if data.ndim > 2 and not a.preserve_shape:
        return torch.softmax(data.reshape(data.shape[0], -1),
                             dim=-1).reshape(data.shape)
    return torch.softmax(data, dim=-1)


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
         aliases=("Softmax",), infer_args=_label_like_batch)


# ---------------------------------------------------------------- Dropout
def _dropout(a, x):
    if not a.get("__is_train__", False) or a.p <= 0:
        return x
    raise MXNetError("Dropout in training mode is not ported yet; the port "
                     "runs inference only")


register("Dropout", _dropout, attrs={"p": 0.5, "__is_train__": False})
