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
(:430), ``_zeros`` (:532, made on the executor's device) and the rest of
that module: the unary math (trigonometric, rounding, roots, ``erf``,
``gamma``), ``_mod``/``_hypot`` and their scalar and broadcast forms,
``add_n``, ``prod``/``nansum``/``nanprod``/``argmin``, ``slice`` and its
assignments, ``clip``, ``repeat``, ``tile``, ``dot``/``batch_dot``,
``one_hot``/``gather_nd``/``scatter_nd``/``batch_take`` (no index out of
range reaches a gather), ``_ones``/``_full``/``_arange``,
``topk``/``sort``/``argsort`` (stable) and the int8 casts, each with
mxtpu's arg names and attr defaults. Comparisons return 0/1 in the left
operand's dtype, as mxtpu's ``_logic`` does. The types follow mxtpu's:
a scalar op first puts its scalar in the array's type (``scalar_of``),
an integer sum is int32 (uint8: uint32) and an integer mean float32. So
do the gradients where torch's differ at a tie or a zero: ``relu``'s at
0 is 1/2, ``abs``'s 1, and ``power``'s at 0^0 NaN (``_Relu``, ``_Abs``,
``_Pow``), ``clip``'s at a bound 1/2 (``_Clip``) and ``cbrt``'s at 0
+inf (``_Cbrt``).
"""
from __future__ import annotations

import ast
import math

import torch

from ..base import MXNetError
from .registry import (Required, int_convert, off_batch_axis, register,
                       set_replicas, torch_dtype)


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
    """``x`` in ``a.dtype``; to an integer type as XLA's convert makes it
    for mxtpu (mxtpu/ops/tensor.py:101; ``registry.int_convert``)."""
    dt = torch_dtype(a.dtype)
    if dt.is_floating_point or dt == torch.bool:
        return x.to(dt)
    return int_convert(x, dt)


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


# ------------------------------------------------------------- the rest
# of mxtpu/ops/tensor.py: unary math (:53-99), the int8 casts (:107-144),
# mod and hypot, add_n, broadcast_axis, the other reductions, slice and
# its assignments, clip, repeat, tile, space_to_depth, dot, batch_dot,
# the gathers and scatters, the init ops, the orderings (:554-597) and
# the sparse-compat ops (:604-609)
def _inexact(x):
    """x, an integer array taken as float32 first, as jnp's inexact math
    promotes it."""
    return x if x.is_floating_point() else x.to(torch.float32)


class _Cbrt(torch.autograd.Function):
    """``jnp.cbrt``: the real cube root, whose gradient is
    ``1/3 * out**-2`` (lax's rule, +inf at 0), where the composite
    ``sign(x) * |x|**(1/3)`` would give NaN there."""

    @staticmethod
    def forward(ctx, x):
        out = torch.copysign(torch.pow(torch.abs(x), 1.0 / 3.0), x)
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        return g * ((1.0 / 3.0) * torch.pow(out, -2.0))


for _n, _f in [("sin", torch.sin), ("cos", torch.cos), ("tan", torch.tan),
               ("arcsin", torch.asin), ("arccos", torch.acos),
               ("arctan", torch.atan), ("sinh", torch.sinh),
               ("cosh", torch.cosh), ("tanh", torch.tanh),
               ("arcsinh", torch.asinh), ("arccosh", torch.acosh),
               ("arctanh", torch.atanh), ("erf", torch.erf),
               ("expm1", torch.expm1), ("log1p", torch.log1p),
               ("log2", torch.log2), ("log10", torch.log10),
               ("gammaln", torch.lgamma),
               # |Gamma(x)|, as mxtpu's exp(gammaln(x)) gives it
               ("gamma", lambda x: torch.exp(torch.lgamma(x))),
               ("degrees", lambda x: x * (180.0 / math.pi)),
               ("radians", lambda x: x * (math.pi / 180.0)),
               ("reciprocal", lambda x: 1 / x),
               ("rsqrt", lambda x: 1 / torch.sqrt(x)),
               ("cbrt", _Cbrt.apply),
               ("rcbrt", lambda x: 1 / _Cbrt.apply(x)),
               ("softsign", lambda x: x / (1 + _Abs.apply(x)))]:
    unary(_n, (lambda f: lambda x: f(_inexact(x)))(_f))


def _rounding(f):
    """A rounding op: an integer array comes back as it is; the gradient
    is 0 everywhere."""
    return lambda x: f(x) if x.is_floating_point() else x.clone()


# sign keeps -0.0 as jnp's does (torch's gives +0.0); its gradient is 0
unary("sign", lambda x: torch.where(x == 0, x.detach(), torch.sign(x))
      if x.is_floating_point() else torch.sign(x))
for _n, _f in [("round", torch.round), ("rint", torch.round),
               ("ceil", torch.ceil), ("floor", torch.floor),
               ("trunc", torch.trunc), ("fix", torch.trunc)]:
    unary(_n, _rounding(_f))
unary("identity", torch.clone)
unary("BlockGrad", lambda x: x.detach().clone(), aliases=("stop_gradient",))
register("_identity_with_attr_like_rhs", lambda a, l, r: l.clone(),
         arg_names=["lhs", "rhs"], attrs={})


def _q8_scale(a, like):
    """The scale attr as a float32 tensor that broadcasts against
    ``like``: one scale when ``axis`` < 0, else one a slice of ``axis``
    (mxtpu/ops/tensor.py:107)."""
    s = torch.tensor(tuple(a.scale), dtype=torch.float32, device=like.device)
    axis = int(a.axis)
    if axis < 0 or like.ndim == 0:
        return s.reshape(()) if s.numel() == 1 else s
    shape = [1] * like.ndim
    shape[axis] = s.shape[0]
    return s.reshape(shape)


def _quantize_int8(a, x):
    """round(x / scale), half to even, clipped to [-127, 127], as int8."""
    q = torch.round(x.to(torch.float32) / _q8_scale(a, x))
    return torch.clamp(q, -127, 127).to(torch.int8)


register("quantize_int8", _quantize_int8,
         attrs={"scale": Required(tuple), "axis": -1})
register("dequantize_int8",
         lambda a, q: (q.to(torch.float32) * _q8_scale(a, q)).to(
             torch_dtype(a.out_dtype)),
         attrs={"scale": Required(tuple), "axis": -1,
                "out_dtype": "float32"})


def _mod(x, y):
    """``jnp.mod``: the truncated remainder moved onto the divisor's
    sign; an integer divisor of 0 is read as 1 (so ``5 % 0 == 0``), a
    float one gives NaN. Its gradient is fmod's (the divisor's
    ``-trunc(x / y)``, plus 1 where the sign moved), as lax.rem's."""
    if not (x.is_floating_point() or y.is_floating_point()):
        y = torch.where(y == 0, torch.ones_like(y), y)
    r = torch.fmod(x, y)
    move = ((r < 0) != (y < 0)) & (r != 0)
    return torch.where(move, r + y, r)


def _hypot(x, y):
    """``jnp.hypot``'s algorithm, so its gradient at (0, 0) is jnp's
    (1/2 to each side: abs's 1 at 0 times maximum's half at a tie)."""
    x, y = _Abs.apply(_inexact(x)), _Abs.apply(_inexact(y))
    inf = torch.isposinf(x) | torch.isposinf(y)
    hi, lo = torch.maximum(x, y), torch.minimum(x, y)
    zero = hi == 0
    out = torch.where(zero, hi, hi * torch.sqrt(
        1 + torch.square(lo / torch.where(zero, torch.ones_like(hi), hi))))
    return torch.where(inf, torch.full_like(out, math.inf), out)


def _with_scalar(f, reverse=False):
    """``f`` of x and the scalar (already in x's type) as a 0-d tensor of
    x's type on x's device; ``reverse`` swaps the operands."""
    def impl(x, s):
        t = torch.full((), s, dtype=x.dtype, device=x.device)
        return f(t, x) if reverse else f(x, t)
    return impl


binary("_grad_add", torch.add)
for _n in ("_mod", "broadcast_mod"):
    binary(_n, _mod)
for _n in ("_hypot", "broadcast_hypot"):
    binary(_n, _hypot)
binary_scalar("_mod_scalar", _with_scalar(_mod))
binary_scalar("_rmod_scalar", _with_scalar(_mod, reverse=True))
binary_scalar("_hypot_scalar", _with_scalar(_hypot))
register("add_n", lambda a, *xs: sum(xs[1:], xs[0]), variadic="num_args",
         attrs={"num_args": Required(int)},
         aliases=("ElementWiseSum", "_sum"))


def _broadcast_axis(a, x):
    ax = _axis_tuple(a.axis, x.ndim)
    size = tuple(a.size)
    return x.expand(tuple(size[ax.index(i)] if i in ax else x.shape[i]
                          for i in range(x.ndim)))


register("broadcast_axis", _broadcast_axis, attrs={"axis": (), "size": ()},
         aliases=("broadcast_axes",))


def _prod(x, dim, keepdim):
    """``jnp.prod`` over the axes ``dim`` (torch's takes one axis: they
    are moved last and flattened), with the integer types of ``_sum``; a
    zero's gradient is the product of the rest, as lax's rule gives."""
    keep = [i for i in range(x.ndim) if i not in dim]
    flat = x.permute(keep + list(dim)).reshape([x.shape[i] for i in keep]
                                               + [-1])
    if x.is_floating_point():
        out = torch.prod(flat, dim=-1)
    else:
        out = torch.prod(flat, dim=-1, dtype=torch.int64).to(
            _SUM_INT.get(x.dtype, torch.int32))
    for d in sorted(dim) if keepdim else ():
        out = out.unsqueeze(d)
    return out


def _nan_as(value, f):
    """``f`` with every NaN read as ``value`` (nansum, nanprod)."""
    def impl(x, dim, keepdim):
        if x.is_floating_point():
            x = torch.where(torch.isnan(x), torch.full_like(x, value), x)
        return f(x, dim, keepdim)
    return impl


_reduce("prod", _prod)
_reduce("nansum", _nan_as(0.0, _sum))
_reduce("nanprod", _nan_as(1.0, _prod))
_reduce("sum_axis", _sum)


def _square_sum(a, x):
    ax = _axis_tuple(a.axis, x.ndim)
    return _sum(torch.square(x), ax, bool(a.keepdims)) if ax else \
        torch.square(x)


register("_square_sum", _square_sum, attrs={"axis": None, "keepdims": False})


def _arg_reduce(f):
    """argmax/argmin (mxtpu/ops/tensor.py:240): the first index of the
    extreme, in the input's type."""
    def impl(a, x):
        if a.axis is None:
            r = f(x.reshape(-1), dim=0)
            if a.keepdims:
                r = r.reshape((1,) * x.ndim)
            return r.to(x.dtype)
        return f(x, dim=int(a.axis), keepdim=bool(a.keepdims)).to(x.dtype)
    return impl


register("argmin", _arg_reduce(torch.argmin),
         attrs={"axis": None, "keepdims": False})
register("argmax_channel",
         lambda a, x: torch.argmax(x, dim=1).to(x.dtype), attrs={})


def _slice_idx(a, shape):
    """The basic index of ``slice``'s begin/end (None: the whole axis;
    a negative bound counts from the end once, then Python's slice rules
    clip it), as mxtpu/ops/tensor.py:369."""
    begin, end = list(a.begin), list(a.end)
    idx = []
    for d in range(len(shape)):
        b = begin[d] if d < len(begin) and begin[d] is not None else 0
        e = end[d] if d < len(end) and end[d] is not None else shape[d]
        idx.append(slice(b + shape[d] if b < 0 else b,
                         e + shape[d] if e < 0 else e))
    return tuple(idx)


def _slice_assign(a, lhs, rhs):
    """lhs with lhs[begin:end] = rhs, as a new tensor (autograd sends
    the region's gradient to rhs and the rest to lhs)."""
    out = lhs.clone()
    out[_slice_idx(a, lhs.shape)] = rhs.to(lhs.dtype)
    return out


def _slice_assign_scalar(a, x):
    out = x.clone()
    out[_slice_idx(a, x.shape)] = scalar_of(x, a.scalar)
    return out


register("slice", lambda a, x: x[_slice_idx(a, x.shape)],
         attrs={"begin": Required(tuple), "end": Required(tuple)},
         aliases=("crop",))
register("_slice_assign", _slice_assign, arg_names=["lhs", "rhs"],
         attrs={"begin": Required(tuple), "end": Required(tuple)},
         aliases=("_crop_assign",))
register("_slice_assign_scalar", _slice_assign_scalar,
         attrs={"begin": Required(tuple), "end": Required(tuple),
                "scalar": 0.0},
         aliases=("_crop_assign_scalar",))


class _Clip(torch.autograd.Function):
    """``jnp.clip`` = ``minimum(maximum(x, lo), hi)``: NaN stays NaN,
    and the gradient at a bound is jnp's tie split, 1/2 at ``lo`` and at
    ``hi`` (1/4 where they meet), where ``torch.clamp`` passes 1."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = lo, hi
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.bounds
        m = torch.clamp(x, min=lo)
        w_lo = torch.where(x > lo, 1.0, torch.where(x == lo, 0.5, 0.0))
        w_hi = torch.where(m < hi, 1.0, torch.where(m == hi, 0.5, 0.0))
        return g * (w_lo * w_hi).to(g.dtype), None, None


def _clip(a, x):
    """The bounds are Python floats, so an integer array comes out in
    float32, as jnp's weak types promote it."""
    x = _inexact(x)
    return _Clip.apply(x, scalar_of(x, a.a_min), scalar_of(x, a.a_max))


register("clip", _clip,
         attrs={"a_min": Required(float), "a_max": Required(float)})


def _repeat(a, x):
    axis = None if a.axis in (None, "None") else int(a.axis)
    return torch.repeat_interleave(x, int(a.repeats), dim=axis)


register("repeat", _repeat, attrs={"repeats": Required(int), "axis": None})
register("tile", lambda a, x: torch.tile(x, tuple(int(r) for r in a.reps)),
         attrs={"reps": Required(tuple)})


def _space_to_depth(a, x):
    n, c, h, w = x.shape
    b = int(a.block_size)
    y = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return y.reshape(n, c * b * b, h // b, w // b)


register("space_to_depth", _space_to_depth,
         attrs={"block_size": Required(int)})


def _dot(a, lhs, rhs):
    """``jnp.dot`` (numpy's: the last axis of lhs against a vector rhs,
    else against rhs's second to last axis), after mxtpu's transposes
    (mxtpu/ops/tensor.py:445)."""
    l, r = lhs, rhs
    if a.transpose_a:
        l = lhs.t() if lhs.ndim == 2 else \
            lhs.permute(tuple(range(1, lhs.ndim)) + (0,))
    if a.transpose_b:
        r = rhs.t() if rhs.ndim == 2 else \
            rhs.permute((rhs.ndim - 1,) + tuple(range(rhs.ndim - 1)))
    if l.ndim == 0 or r.ndim == 0:
        return l * r
    return torch.tensordot(l, r, dims=([l.ndim - 1], [max(r.ndim - 2, 0)]))


def _batch_dot(a, lhs, rhs):
    l = lhs.transpose(-1, -2) if a.transpose_a else lhs
    r = rhs.transpose(-1, -2) if a.transpose_b else rhs
    return torch.matmul(l, r)


register("dot", _dot, arg_names=["lhs", "rhs"],
         attrs={"transpose_a": False, "transpose_b": False})
register("batch_dot", _batch_dot, arg_names=["lhs", "rhs"],
         attrs={"transpose_a": False, "transpose_b": False})


def _index_of(x):
    """``x`` as int64 indices, a float read as XLA's int32 convert reads
    it (``registry.int_convert``)."""
    return (int_convert(x) if x.is_floating_point() else x).to(torch.int64)


def _batch_take(a, x, indices):
    """``x[i, indices[i]]`` (mxtpu's take_along_axis on axis 1): an index
    in [-n, 0) wraps, one outside [-n, n) gives NaN and no gradient. The
    gather only ever sees indices in range (``_in_range``)."""
    idx, valid = _in_range(_index_of(indices), x.shape[1])
    got = torch.take_along_dim(x, idx.unsqueeze(1), dim=1)[:, 0]
    return torch.where(valid, got, float("nan"))


register("batch_take", _batch_take, arg_names=["a", "indices"], attrs={})


def _one_hot(a, indices):
    """Rows of ``depth`` with ``on_value`` at the index and ``off_value``
    elsewhere; an index outside [0, depth) (after ``_index_of``) gives a
    row of ``off_value``. Made by comparing with an arange, so no index
    reaches a gather. An integer ``dtype`` comes out float32, as jnp's
    weak types promote ``out * (on - off) + off``."""
    classes = torch.arange(int(a.depth), device=indices.device)
    dt = torch_dtype(a.dtype)
    hot = (_index_of(indices).unsqueeze(-1) == classes).to(
        dt if dt.is_floating_point else torch.float32)
    return hot * (a.on_value - a.off_value) + a.off_value


register("one_hot", _one_hot,
         attrs={"depth": Required(int), "on_value": 1.0, "off_value": 0.0,
                "dtype": "float32"})


def _nd_index(indices, shape):
    """(the M index tensors of ``indices`` (M, ...) into ``shape``'s
    leading M axes, negative ones wrapped once; their in-range mask)."""
    idx = _index_of(indices)
    rows = []
    valid = torch.ones(idx.shape[1:], dtype=torch.bool, device=idx.device)
    for i in range(idx.shape[0]):
        v = torch.where(idx[i] < 0, idx[i] + shape[i], idx[i])
        valid = valid & (v >= 0) & (v < shape[i])
        rows.append(v)
    return rows, valid


def _gather_nd(a, data, indices):
    """``data[indices[0], ..., indices[M-1]]``: a negative index wraps
    once, then every index is clamped into its axis, as jnp's indexing
    gathers; the gradient of a clamped read is dropped, as the scatter
    that transposes jnp's gather drops it."""
    rows, valid = _nd_index(indices, data.shape)
    got = data[tuple(torch.clamp(v, 0, data.shape[i] - 1)
                     for i, v in enumerate(rows))]
    valid = valid.reshape(valid.shape + (1,) * (got.ndim - valid.ndim))
    return torch.where(valid, got, got.detach())


def _scatter_nd(a, data, indices):
    """zeros(shape) with ``data`` added at ``indices``: a negative index
    wraps once and an update still outside the shape is dropped (sent
    to index 0 as a zero, with no gradient), as jnp's ``.at[].add``."""
    shape = tuple(int(s) for s in a.shape)
    rows, valid = _nd_index(indices, shape)
    rows = tuple(torch.where(valid, v, torch.zeros_like(v)) for v in rows)
    keep = valid.reshape(valid.shape + (1,) * (data.ndim - valid.ndim))
    upd = torch.where(keep, data, torch.zeros_like(data))
    out = torch.zeros(shape, dtype=data.dtype, device=data.device)
    return out.index_put(rows, upd, accumulate=True)


register("gather_nd", _gather_nd, arg_names=["data", "indices"], attrs={})
register("scatter_nd", _scatter_nd, arg_names=["data", "indices"],
         attrs={"shape": Required(tuple)})


def _filled(value):
    return lambda a, device: torch.full(
        tuple(int(s) for s in a.shape), value(a),
        dtype=torch_dtype(a.dtype or "float32"), device=device)


register("_ones", _filled(lambda a: 1), arg_names=[],
         attrs={"shape": Required(tuple), "dtype": "float32", "ctx": ""})
register("_full", _filled(lambda a: a.value), arg_names=[],
         attrs={"shape": Required(tuple), "dtype": "float32", "ctx": "",
                "value": Required(float)})


def _arange(a, device):
    """numpy's arange, which jnp's follows for Python bounds: ceil((stop
    - start) / step) values, the first ``start`` and the second ``start +
    step`` (each rounded to the type), the rest ``start + i * delta``
    with delta the difference of those two, in the type's arithmetic;
    then each value ``repeat`` times."""
    start, stop = a.start, a.stop
    if stop is None:
        start, stop = 0.0, start
    dt = torch_dtype(a.dtype)
    n = max(0, math.ceil((stop - start) / a.step))
    if dt.is_floating_point:
        first = torch.tensor([start, start + a.step], dtype=dt,
                             device=device)
        out = first[0] + torch.arange(n, dtype=dt, device=device) * \
            (first[1] - first[0])
        out[:2] = first[:n]
    else:
        out = (int(start) + torch.arange(n, device=device)
               * (int(start + a.step) - int(start))).to(dt)
    return torch.repeat_interleave(out, int(a.repeat)) \
        if int(a.repeat) > 1 else out


register("_arange", _arange, arg_names=[],
         attrs={"start": 0.0, "stop": None, "step": 1.0, "repeat": 1,
                "dtype": "float32", "ctx": ""})


def _sort_axis(a, x):
    return x.ndim - 1 if a.axis is None else int(a.axis) % x.ndim


def _topk(a, x):
    """The k largest (``is_ascend``: smallest) along ``axis``, as mxtpu's:
    values ``-sort(-x)`` and indices by a stable sort of ``-x``, so
    equal values keep the lower index first and NaN comes last; returned
    as ``ret_typ`` says (indices in x's type, a 0/1 mask, or both)."""
    axis = _sort_axis(a, x)
    k = int(a.k) if int(a.k) > 0 else x.shape[axis]
    xm = x.movedim(axis, -1)
    srt, idx = torch.sort(xm if a.is_ascend else -xm, dim=-1, stable=True)
    idx = idx[..., :k]
    if a.ret_typ == "mask":
        return torch.zeros_like(xm).scatter(
            -1, idx, torch.ones_like(idx, dtype=x.dtype)).movedim(-1, axis)
    vals = (srt if a.is_ascend else -srt)[..., :k].movedim(-1, axis)
    idx = idx.movedim(-1, axis).to(x.dtype)
    return {"value": vals, "indices": idx}.get(a.ret_typ, (vals, idx))


register("topk", _topk,
         attrs={"axis": -1, "k": 1, "ret_typ": "indices", "is_ascend": False},
         num_outputs=lambda a: 2 if a.ret_typ == "both" else 1)


def _sort(a, x):
    """A stable ascending sort (NaN last); descending is its flip, as
    mxtpu's, so NaN comes first there."""
    axis = _sort_axis(a, x)
    s = torch.sort(x, dim=axis, stable=True)[0]
    return s if a.is_ascend else torch.flip(s, dims=(axis,))


def _argsort(a, x):
    """Indices of a stable sort of x (descending: of -x, so NaN stays
    last and ties keep the lower index first), in x's type."""
    return torch.sort(x if a.is_ascend else -x, dim=_sort_axis(a, x),
                      stable=True)[1].to(x.dtype)


register("sort", _sort, attrs={"axis": -1, "is_ascend": True})
register("argsort", _argsort, attrs={"axis": -1, "is_ascend": True})
# the dense storage only, as mxtpu's
register("cast_storage", lambda a, x: x.clone(),
         attrs={"stype": Required(str)})


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
set_replicas(["_zeros", "_ones", "_full", "_arange"])  # constants
set_replicas(
    ["sin", "cos", "tan", "arcsin", "arccos", "arctan", "sinh", "cosh",
     "tanh", "arcsinh", "arccosh", "arctanh", "erf", "expm1", "log1p",
     "log2", "log10", "gammaln", "gamma", "degrees", "radians",
     "reciprocal", "rsqrt", "cbrt", "rcbrt", "softsign", "sign", "round",
     "rint", "ceil", "floor", "trunc", "fix", "identity", "BlockGrad",
     "stop_gradient", "_identity_with_attr_like_rhs", "quantize_int8",
     "dequantize_int8", "_grad_add", "_mod", "broadcast_mod", "_hypot",
     "broadcast_hypot", "_mod_scalar", "_rmod_scalar", "_hypot_scalar",
     "add_n", "ElementWiseSum", "_sum", "clip", "cast_storage",
     "one_hot", "argmax_channel", "batch_take"])
set_replicas(["prod", "nansum", "nanprod", "sum_axis", "_square_sum"],
             lambda a, nd: not a.get("exclude") and off_batch_axis(a.axis, nd))
set_replicas(["argmin"], lambda a, nd: off_batch_axis(a.axis, nd))
set_replicas(["topk", "sort", "argsort"],
             lambda a, nd: a.axis is not None and off_batch_axis(a.axis, nd))
