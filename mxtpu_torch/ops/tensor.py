"""Tensor ops the transformer LM's serving path uses.

Counterpart of the matching entries of ``mxtpu/ops/tensor.py``: ``Cast``
(:101), ``elemwise_add`` with its ``_plus`` alias (:147, what Symbol ``+``
composes), ``broadcast_add`` (:202), ``Reshape`` (:334), ``transpose``
(:342), ``slice_axis`` (:420) and ``Embedding`` (:476). The other op
families of that module are ported in later slices.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import Required, register, torch_dtype


def binary(name, f, **kw):
    register(name, lambda a, l, r: f(l, r), arg_names=["lhs", "rhs"],
             attrs={}, **kw)


register("Cast", lambda a, x: x.to(torch_dtype(a.dtype)),
         attrs={"dtype": Required(str)}, aliases=("cast",))

binary("elemwise_add", torch.add, aliases=("_plus", "_add"))
binary("broadcast_add", torch.add)


def _infer_reshape(shape_spec, in_shape):
    """MXNet reshape mini-language: 0 copy, -1 infer, -2 rest, -3 merge,
    -4 split (same rules as mxtpu/ops/tensor.py:_infer_reshape)."""
    out = []
    src = list(in_shape)
    i = 0
    j = 0
    spec = list(shape_spec)
    while j < len(spec):
        s = spec[j]
        if s == 0:
            out.append(src[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            a1, a2 = spec[j + 1], spec[j + 2]
            if a1 == -1:
                a1 = src[i] // a2
            if a2 == -1:
                a2 = src[i] // a1
            out.extend([a1, a2])
            i += 1
            j += 2
        else:
            out.append(int(s))
            if i < len(src):
                i += 1
        j += 1
    if -1 in out:
        known = 1
        for v in out:
            if v != -1:
                known *= v
        total = 1
        for v in in_shape:
            total *= v
        out[out.index(-1)] = total // max(known, 1)
    return tuple(out)


def _reshape(a, x):
    shape = a.shape
    if not shape and a.target_shape:
        tgt = tuple(a.target_shape)
        if a.keep_highest:
            tgt = (x.shape[0],) + tgt[1:]
        shape = tuple(-1 if d == 0 else d for d in tgt)
    if not shape:
        raise MXNetError("Reshape requires shape= (or legacy target_shape=)")
    if a.reverse:
        rev = _infer_reshape(tuple(reversed(shape)),
                             tuple(reversed(x.shape)))
        return torch.reshape(x, tuple(reversed(rev)))
    return torch.reshape(x, _infer_reshape(shape, tuple(x.shape)))


register("Reshape", _reshape,
         attrs={"shape": (), "target_shape": (), "reverse": False,
                "keep_highest": False},
         aliases=("reshape",))


def _transpose(a, x):
    axes = tuple(a.axes) if a.axes else tuple(reversed(range(x.ndim)))
    return x.permute(axes)


register("transpose", _transpose, attrs={"axes": ()})


def _slice_axis(a, x):
    ax = int(a.axis) % x.ndim
    b = a.begin or 0
    # `end` defaults to None, so it has no type to parse by: a value read
    # back from symbol JSON arrives as a string ("8" or "None")
    e = x.shape[ax] if a.end in (None, "None") else int(a.end)
    if b < 0:
        b += x.shape[ax]
    if e < 0:
        e += x.shape[ax]
    return x.narrow(ax, b, e - b)


register("slice_axis", _slice_axis,
         attrs={"axis": Required(int), "begin": 0, "end": None})


def _embedding(a, data, weight):
    # float token ids truncate toward zero, as astype(int32) does
    return torch.nn.functional.embedding(data.to(torch.int64), weight)


register("Embedding", _embedding, arg_names=["data", "weight"],
         attrs={"input_dim": Required(int), "output_dim": Required(int),
                "dtype": "float32"},
         infer_args=lambda a, shapes: [
             shapes[0], (int(a.input_dim), int(a.output_dim))])
