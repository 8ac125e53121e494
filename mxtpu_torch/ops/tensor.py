"""Tensor ops of the served and trained models and of the imperative
frontends (NDArray arithmetic, autograd, Gluon and its losses).

Counterpart of the matching entries of ``mxtpu/ops/tensor.py``: the
unary math (:53-99: ``relu``, ``sigmoid``, ``negative``, ``_copy``,
``abs``, ``square``, ``sqrt``, ``exp``, ``log``, ``zeros_like``,
``ones_like``), ``Cast`` (:101), the elementwise binaries (:147-163,
with ``_plus``/``_minus``/``_mul``/``_div``, what Symbol arithmetic
composes, and the 0/1 comparisons), the scalar ops (:168-186), the
broadcast binaries (:196-205) and ``broadcast_to`` (:212), the
reductions ``sum``/``mean``/``max``/``min`` with ``axis``, ``keepdims``
and ``exclude`` and ``norm`` (:217-237), ``argmax`` (:254), ``pick``
(:268), ``Reshape`` (:334), ``Flatten`` (:338), ``reshape_like``
(:340), ``transpose`` (:342), ``expand_dims`` (:344), ``SwapAxis``
(:346), ``slice_axis`` (:420), ``stack`` (:447), ``Embedding`` (:476),
``take`` (:486) and ``where`` (:600), each with mxtpu's arg names and
attr defaults. Comparisons return 0/1 in the left operand's dtype, as
mxtpu's ``_logic`` does. The other op families of that module are
ported in later slices.
"""
from __future__ import annotations

import ast

import torch

from ..base import MXNetError
from .registry import Required, register, torch_dtype


def _axis_tuple(axis, ndim, exclude=False):
    """The reduced axes (mxtpu/ops/tensor.py:_axis_tuple); ``axis`` may
    be None, an int, a tuple, or one of those as symbol-JSON text."""
    if isinstance(axis, str):
        axis = None if axis.strip() in ("", "None") else \
            ast.literal_eval(axis)
    if axis is None or axis == () or axis == []:
        ax = tuple(range(ndim))
    elif isinstance(axis, int):
        ax = (axis % ndim,)
    else:
        ax = tuple(int(a) % ndim for a in axis)
    if exclude:
        ax = tuple(i for i in range(ndim) if i not in ax)
    return ax


def unary(name, f, **kw):
    register(name, lambda a, x: f(x), arg_names=["data"], attrs={}, **kw)


def binary(name, f, **kw):
    register(name, lambda a, l, r: f(l, r), arg_names=["lhs", "rhs"],
             attrs={}, **kw)


def binary_scalar(name, f, **kw):
    """``f(x, scalar)`` with the scalar a Python float, which torch rounds
    to x's dtype as mxtpu's ``jnp.asarray(scalar, x.dtype)`` does."""
    register(name, lambda a, x: f(x, a.scalar), arg_names=["data"],
             attrs={"scalar": Required(float)}, **kw)


def _full_like(f):
    """``f`` of x and a 0-d tensor of the scalar, for the ops that take
    no Python number (filled on x's device, no host copy)."""
    return lambda x, s: f(x, torch.full((), s, dtype=x.dtype,
                                        device=x.device))


def _logic(f):
    return lambda l, r: f(l, r).to(l.dtype)


# ---------------------------------------------------------------- unary math
unary("relu", torch.relu)
unary("sigmoid", torch.sigmoid)
unary("_copy", torch.clone)
unary("negative", torch.neg)
unary("abs", torch.abs)
unary("square", torch.square)
unary("sqrt", torch.sqrt)
unary("exp", torch.exp)
unary("log", torch.log)
unary("zeros_like", torch.zeros_like)
unary("ones_like", torch.ones_like)

register("Cast", lambda a, x: x.to(torch_dtype(a.dtype)),
         attrs={"dtype": Required(str)}, aliases=("cast",))

# ---------------------------------------------------------------- binaries
# torch.maximum/minimum split the gradient at a tie as jnp.maximum does
_COMPARE = [("equal", torch.eq), ("not_equal", torch.ne),
            ("greater", torch.gt), ("greater_equal", torch.ge),
            ("lesser", torch.lt), ("lesser_equal", torch.le)]
binary("elemwise_add", torch.add, aliases=("_plus", "_add"))
binary("elemwise_sub", torch.sub, aliases=("_minus", "_sub"))
binary("elemwise_mul", torch.mul, aliases=("_mul",))
binary("elemwise_div", torch.div, aliases=("_div",))
binary("_maximum", torch.maximum)
binary("_minimum", torch.minimum)
binary("_power", torch.pow)
for _n, _f in _COMPARE:
    binary("_" + _n, _logic(_f))

binary_scalar("_plus_scalar", torch.add)
binary_scalar("_minus_scalar", torch.sub)
binary_scalar("_rminus_scalar", lambda x, s: s - x)
binary_scalar("_mul_scalar", torch.mul)
binary_scalar("_div_scalar", torch.div)
binary_scalar("_rdiv_scalar", lambda x, s: s / x)
binary_scalar("_maximum_scalar", _full_like(torch.maximum))
binary_scalar("_minimum_scalar", _full_like(torch.minimum))
binary_scalar("_power_scalar", torch.pow)
binary_scalar("_rpower_scalar", lambda x, s: torch.pow(s, x))
for _n, _f in _COMPARE:
    binary_scalar("_%s_scalar" % _n, _logic(_f))

for _n, _f in [("add", torch.add), ("plus", torch.add), ("sub", torch.sub),
               ("minus", torch.sub), ("mul", torch.mul), ("div", torch.div),
               ("power", torch.pow), ("maximum", torch.maximum),
               ("minimum", torch.minimum)] + \
        [(n, _logic(f)) for n, f in _COMPARE]:
    binary("broadcast_" + _n, _f)

register("broadcast_to",
         lambda a, x: x.expand(tuple(s if s != 0 else x.shape[i]
                                     for i, s in enumerate(a.shape))),
         attrs={"shape": Required(tuple)})


# ---------------------------------------------------------------- reductions
def _reduce(name, f):
    def impl(a, x):
        ax = _axis_tuple(a.axis, x.ndim, a.exclude)
        if not ax:  # nothing to reduce (torch reads dim=() as every dim)
            return x
        return f(x, dim=ax, keepdim=bool(a.keepdims))

    register(name, impl, attrs={"axis": None, "keepdims": False,
                                "exclude": False})


_reduce("sum", torch.sum)
_reduce("mean", torch.mean)
_reduce("max", torch.amax)  # amax/amin share a tie's gradient, as jnp
_reduce("min", torch.amin)
register("norm", lambda a, x: torch.sqrt(torch.sum(torch.square(x))),
         attrs={})


def _argmax(a, x):
    if a.axis is None:
        r = torch.argmax(x.reshape(-1), dim=0)
        if a.keepdims:
            r = r.reshape((1,) * x.ndim)
        return r.to(x.dtype)
    return torch.argmax(x, dim=int(a.axis),
                        keepdim=bool(a.keepdims)).to(x.dtype)


register("argmax", _argmax, attrs={"axis": None, "keepdims": False})


def _pick(a, x, index):
    axis = (int(a.axis) if a.axis is not None else -1) % x.ndim
    idx = index.to(torch.int64).unsqueeze(axis)
    picked = torch.take_along_dim(x, idx, dim=axis)
    return picked if a.keepdims else picked.squeeze(axis)


register("pick", _pick, arg_names=["data", "index"],
         attrs={"axis": -1, "keepdims": False})


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


register("Flatten", lambda a, x: x.reshape(x.shape[0], -1), attrs={},
         aliases=("flatten",))
register("reshape_like", lambda a, l, r: l.reshape(r.shape),
         arg_names=["lhs", "rhs"], attrs={})


def _transpose(a, x):
    axes = tuple(a.axes) if a.axes else tuple(reversed(range(x.ndim)))
    return x.permute(axes)


register("transpose", _transpose, attrs={"axes": ()})
register("expand_dims", lambda a, x: x.unsqueeze(int(a.axis)),
         attrs={"axis": Required(int)})
register("SwapAxis", lambda a, x: x.transpose(int(a.dim1), int(a.dim2)),
         attrs={"dim1": 0, "dim2": 0}, aliases=("swapaxes",))
register("stack", lambda a, *xs: torch.stack(xs, dim=int(a.axis)),
         variadic="num_args", attrs={"num_args": Required(int), "axis": 0})


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


def _take(a, data, indices):
    """Rows of ``data`` along ``axis`` at ``indices`` (cast to integers
    toward zero); "clip" clamps an index into range, "wrap" takes it
    modulo the axis (mxtpu/ops/tensor.py:486)."""
    ax = int(a.axis) % data.ndim
    n = data.shape[ax]
    idx = indices.to(torch.int64)
    idx = torch.remainder(idx, n) if a.mode == "wrap" else \
        torch.clamp(idx, 0, n - 1)
    out = torch.index_select(data, ax, idx.reshape(-1))
    return out.reshape(data.shape[:ax] + tuple(indices.shape)
                       + data.shape[ax + 1:])


register("take", _take, arg_names=["a", "indices"],
         attrs={"axis": 0, "mode": "clip"})

register("where", lambda a, c, l, r: torch.where(c.to(torch.bool), l, r),
         arg_names=["condition", "x", "y"], attrs={})
