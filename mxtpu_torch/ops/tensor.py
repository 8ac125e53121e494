"""Tensor ops of the served and trained models and of the imperative
frontends (NDArray arithmetic, autograd, Gluon and its losses).

Counterpart of the matching entries of ``mxtpu/ops/tensor.py``: the
unary math (:53-99: ``relu``, ``sigmoid``, ``negative``, ``_copy``,
``abs``, ``square``, ``sqrt``, ``exp``, ``log``, ``zeros_like``,
``ones_like``, ``make_loss``), ``Cast`` (:101), the elementwise
binaries (:147-163, with ``_plus``/``_minus``/``_mul``/``_div``, what
Symbol arithmetic composes, and the 0/1 comparisons), the scalar ops
(:168-186), ``smooth_l1`` (:188), the broadcast binaries (:196-205) and
``broadcast_to`` (:212), the reductions ``sum``/``mean``/``max``/``min``
with ``axis``, ``keepdims`` and ``exclude`` and ``norm`` (:217-237),
``argmax`` (:254), ``pick`` (:268), ``Reshape`` (:334), ``Flatten``
(:338), ``reshape_like`` (:340), ``transpose`` (:342), ``expand_dims``
(:344), ``SwapAxis`` (:346), ``slice_axis`` (:420), ``stack`` (:447),
``Embedding`` (:476), ``take`` (:486), ``where`` (:600), ``reverse``
(:430) and ``_zeros`` (:532, made on the executor's device), each with
mxtpu's arg names and attr defaults. Comparisons return 0/1 in the left
operand's dtype, as mxtpu's ``_logic`` does. The types follow mxtpu's:
a scalar op first puts its scalar in the array's type (``scalar_of``),
an integer sum is int32 (uint8: uint32) and an integer mean float32. So
do the gradients where torch's differ at a tie or a zero: ``relu``'s at
0 is 1/2, ``abs``'s 1, and ``power``'s at 0^0 NaN (``_Relu``, ``_Abs``,
``_Pow``). The other op families of that module are ported in later
slices.
"""
from __future__ import annotations

import ast
import math

import torch

from ..base import MXNetError
from .registry import (Required, off_batch_axis, register, set_replicas,
                       torch_dtype)


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


def scalar_of(x, s):
    """The Python number ``s`` in ``x``'s type, as mxtpu's
    ``jnp.asarray(scalar, x.dtype)`` makes it: rounded to a float type,
    truncated toward zero for an integer type, where NaN raises
    ValueError and a value outside the type's range OverflowError."""
    if x.dtype in (torch.float16, torch.bfloat16):
        return float(torch.tensor(s, dtype=x.dtype))
    if x.dtype.is_floating_point or x.dtype == torch.bool:
        return s
    v = int(s)
    info = torch.iinfo(x.dtype)
    if not info.min <= v <= info.max:
        raise OverflowError("Python integer %d out of bounds for %s"
                            % (v, str(x.dtype).rsplit(".", 1)[-1]))
    return v


def binary_scalar(name, f, **kw):
    """``f(x, scalar)`` with the scalar first put in x's type
    (``scalar_of``), so an integer array stays integer and a float16
    one adds the float16 scalar, as in mxtpu."""
    register(name, lambda a, x: f(x, scalar_of(x, a.scalar)),
             arg_names=["data"], attrs={"scalar": Required(float)}, **kw)


def _full_like(f):
    """``f`` of x and a 0-d tensor of the scalar, for the ops that take
    no Python number (filled on x's device, no host copy)."""
    return lambda x, s: f(x, torch.full((), s, dtype=x.dtype,
                                        device=x.device))


def _logic(f):
    return lambda l, r: f(l, r).to(l.dtype)


class _Relu(torch.autograd.Function):
    """``max(x, 0)`` whose gradient at x = 0 (either sign) is 1/2, as
    mxtpu's ``jnp.maximum(x, 0)`` splits a tie; ``torch.relu``'s is 0.
    The backward is one ``heaviside`` mask times the head gradient."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.relu(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.heaviside(x, x.new_full((), 0.5))


class _Abs(torch.autograd.Function):
    """``|x|`` whose gradient at x = 0 (either sign) is 1, as
    ``jnp.abs``'s (``select(x >= 0, g, -g)``); torch's ``sgn`` gives 0."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


class _Pow(torch.autograd.Function):
    """``base ** exponent`` (either may be a Python number) with the
    gradients of mxtpu's ``jnp.power`` (lax.pow's rules): ``exponent *
    base ** (exponent - 1)`` for the base, unmasked, so 0 ** 0 gives NaN
    where torch's own backward masks exponent 0; ``log(base) * out``
    for the exponent, with a zero base read as 1."""

    @staticmethod
    def forward(ctx, base, exponent):
        out = torch.pow(base, exponent)
        ctx.numbers = [None if torch.is_tensor(v) else v
                       for v in (base, exponent)]
        ctx.save_for_backward(*[v if torch.is_tensor(v) else None
                                for v in (base, exponent)], out)
        return out

    @staticmethod
    def backward(ctx, g):
        base, exponent, out = ctx.saved_tensors
        base = ctx.numbers[0] if base is None else base
        exponent = ctx.numbers[1] if exponent is None else exponent
        gb = ge = None
        if ctx.needs_input_grad[0]:
            # a tensor exponent: torch's pow by a number special-cases
            # some (-0.5 is rsqrt, which gives -inf at -0 where pow's +inf)
            e1 = exponent - 1 if torch.is_tensor(exponent) else \
                torch.full_like(base, exponent - 1)
            gb = (g * (exponent * torch.pow(base, e1))
                  ).sum_to_size(base.shape)
        if ctx.needs_input_grad[1]:
            if torch.is_tensor(base):
                log_b = torch.log(torch.where(base == 0, 1, base))
            else:
                log_b = math.log(base) if base > 0 else \
                    (0.0 if base == 0 else math.nan)
            ge = (g * (log_b * out)).sum_to_size(exponent.shape)
        return gb, ge


def relu(x):
    return _Relu.apply(x)


# ---------------------------------------------------------------- unary math
unary("relu", relu)
unary("sigmoid", torch.sigmoid)
unary("_copy", torch.clone)
unary("negative", torch.neg)
unary("abs", _Abs.apply)
unary("square", torch.square)
unary("sqrt", torch.sqrt)
unary("exp", torch.exp)
unary("log", torch.log)
unary("zeros_like", torch.zeros_like)
unary("ones_like", torch.ones_like)
unary("make_loss", lambda x: x)  # the identity, gradient and all


def _cast(a, x):
    """``x`` in ``a.dtype``. A float cast to an integer type saturates
    at the type's range and maps NaN to 0, truncating toward zero in
    between, as XLA's convert does for mxtpu (mxtpu/ops/tensor.py:101);
    torch's own conversion wraps or overflows there."""
    dt = torch_dtype(a.dtype)
    if not x.is_floating_point() or dt.is_floating_point or dt == torch.bool:
        return x.to(dt)
    info = torch.iinfo(dt)
    # float64 holds every int32 bound exactly; int64's max rounds up to
    # 2**63, which the comparison then still maps to the max
    xd = torch.nan_to_num(x.to(torch.float64), nan=0.0)
    over, under = xd >= float(info.max), xd <= float(info.min)
    mid = torch.where(over | under, torch.zeros_like(xd), xd).to(dt)
    return torch.where(over, info.max, torch.where(under, info.min, mid)
                       ).to(dt)


register("Cast", _cast, attrs={"dtype": Required(str)}, aliases=("cast",))

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
binary("_power", _Pow.apply)
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
binary_scalar("_power_scalar", _Pow.apply)
binary_scalar("_rpower_scalar", lambda x, s: _Pow.apply(s, x))
for _n, _f in _COMPARE:
    binary_scalar("_%s_scalar" % _n, _logic(_f))


def _smooth_l1(a, x):
    """``0.5 (x s)^2`` where ``|x| < 1/s^2``, else ``|x| - 0.5/s^2``
    (mxtpu/ops/tensor.py:188); its gradient is ``s^2 x`` inside the band
    and ``sign(x)`` outside, as ``jax.vjp`` of the same ``where``."""
    s = a.scalar
    return torch.where(torch.abs(x) < 1.0 / (s ** 2), 0.5 * (x * s) ** 2,
                       torch.abs(x) - 0.5 / (s ** 2))


register("smooth_l1", _smooth_l1, attrs={"scalar": 1.0})

for _n, _f in [("add", torch.add), ("plus", torch.add), ("sub", torch.sub),
               ("minus", torch.sub), ("mul", torch.mul), ("div", torch.div),
               ("power", _Pow.apply), ("maximum", torch.maximum),
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


#: the type an integer sum comes out in: JAX's default integer, int32,
#: and uint32 for the unsigned types, wrapping on overflow
_SUM_INT = {torch.uint8: torch.uint32, torch.bool: torch.int32}


def _sum(x, dim, keepdim):
    """``jnp.sum``'s types: an integer array sums to int32 (uint8 to
    uint32), wrapping as mxtpu's does; torch's own sum gives int64."""
    if x.is_floating_point():
        return torch.sum(x, dim=dim, keepdim=keepdim)
    return torch.sum(x, dim=dim, keepdim=keepdim, dtype=torch.int64).to(
        _SUM_INT.get(x.dtype, torch.int32))


def _mean(x, dim, keepdim):
    """``jnp.mean``'s types: an integer array averages in float32."""
    if not x.is_floating_point():
        x = x.to(torch.float32)
    return torch.mean(x, dim=dim, keepdim=keepdim)


_reduce("sum", _sum)
_reduce("mean", _mean)
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


def _in_range(idx, n):
    """(``idx`` wrapped into ``[0, n)`` with every id outside
    ``[-n, n)`` set to 0, the mask of the ids inside): how
    ``jnp.take``/``take_along_axis`` read an index, negative ones from
    the end and the rest filled (mxtpu's NaN rows). The clamped index
    never reaches a kernel out of range: on the card that trips a
    device-side assert, which leaves the CUDA context unusable."""
    valid = (idx >= -n) & (idx < n)
    wrapped = torch.where(idx < 0, idx + n, idx)
    return torch.where(valid, wrapped, torch.zeros_like(idx)), valid


def _pick(a, x, index):
    """``x``'s entries at ``index`` along ``axis``; an index outside
    ``[-n, n)`` gives NaN and no gradient (mxtpu/ops/tensor.py:268)."""
    axis = (int(a.axis) if a.axis is not None else -1) % x.ndim
    idx, valid = _in_range(index.to(torch.int64), x.shape[axis])
    picked = torch.take_along_dim(x, idx.unsqueeze(axis), dim=axis)
    picked = torch.where(valid.unsqueeze(axis), picked, float("nan"))
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
    """Rows of ``weight`` at ``data``. Float ids truncate toward zero, as
    astype(int32) does; ids in ``[-input_dim, 0)`` wrap and every other
    id outside ``[0, input_dim)`` gives a NaN row with no gradient
    (mxtpu's ``jnp.take``, mxtpu/ops/tensor.py:476)."""
    idx, valid = _in_range(data.to(torch.int64), weight.shape[0])
    rows = torch.nn.functional.embedding(idx, weight)
    return torch.where(valid.unsqueeze(-1), rows, float("nan"))


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
register("reverse",
         lambda a, x: torch.flip(x, dims=tuple(int(i) for i in a.axis)),
         attrs={"axis": Required(tuple)}, aliases=("flip",))


# zeros of ``shape`` on the executor's device, or imperatively on the
# ``ctx`` attr's (``registry.OpDef.apply`` hands the device over)
register("_zeros",
         lambda a, device: torch.zeros(
             tuple(int(s) for s in a.shape),
             dtype=torch_dtype(a.dtype or "float32"), device=device),
         arg_names=[],
         attrs={"shape": Required(tuple), "dtype": "float32", "ctx": ""})


# ---------------------------------------------------------------- replicas
# how each op runs over replicas (OpDef.replica_mode): elementwise ops and
# reshapes of a replica's contiguous rows are its rows of the whole
# result; an op that reduces, reorders or indexes the batch axis is
# refused by a replica walk
_ELEMENTWISE = (
    ["relu", "sigmoid", "_copy", "negative", "abs", "square", "sqrt", "exp",
     "log", "zeros_like", "ones_like", "make_loss", "smooth_l1", "Cast",
     "cast", "where",
     "elemwise_add", "_plus", "_add", "elemwise_sub", "_minus", "_sub",
     "elemwise_mul", "_mul", "elemwise_div", "_div", "_maximum", "_minimum",
     "_power", "_plus_scalar", "_minus_scalar", "_rminus_scalar",
     "_mul_scalar", "_div_scalar", "_rdiv_scalar", "_maximum_scalar",
     "_minimum_scalar", "_power_scalar", "_rpower_scalar"]
    + ["_" + n for n, _ in _COMPARE] + ["_%s_scalar" % n for n, _ in _COMPARE]
    + ["broadcast_" + n for n in ("add", "plus", "sub", "minus", "mul", "div",
                                  "power", "maximum", "minimum")]
    + ["broadcast_" + n for n, _ in _COMPARE])
set_replicas(_ELEMENTWISE + ["Reshape", "reshape", "Flatten", "flatten",
                             "reshape_like", "Embedding"])
set_replicas(["broadcast_to"], lambda a, nd: int(a.shape[0]) == 0)
set_replicas(["sum", "mean", "max", "min"],
             lambda a, nd: not a.exclude and off_batch_axis(a.axis, nd))
set_replicas(["argmax"], lambda a, nd: off_batch_axis(a.axis, nd))
set_replicas(["pick", "take"], lambda a, nd: off_batch_axis(a.axis, nd))
set_replicas(["transpose"],
             lambda a, nd: bool(a.axes) and int(a.axes[0]) % nd == 0)
set_replicas(["expand_dims"], lambda a, nd: int(a.axis) != 0)
set_replicas(["SwapAxis", "swapaxes"],
             lambda a, nd: off_batch_axis((a.dim1, a.dim2), nd))
set_replicas(["stack"], lambda a, nd: int(a.axis) != 0 and
             int(a.axis) != -(nd + 1))
set_replicas(["slice_axis"], lambda a, nd: off_batch_axis(a.axis, nd))
set_replicas(["reverse", "flip"], lambda a, nd: off_batch_axis(a.axis, nd))
set_replicas(["_zeros"])  # a constant, the same on every replica
