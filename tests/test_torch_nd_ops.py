"""The ops this slice adds to the port (the imperative surface, the
losses and the Gluon layers need them), against mxtpu's: the same numpy
inputs through mxtpu's op (JAX on the CPU, on an empty jit cache) and
the port's (PyTorch on the CPU). Forward within 1e-5 relative (f32);
where the op is differentiable, the gradient under one random head
gradient, ``torch.autograd.grad`` of the port's op against ``jax.vjp`` of
mxtpu's, within 1e-4 of the largest gradient (the two sum in other
orders). Then the generated ``nd.<op>`` functions: positional attrs map
onto attrs in registration order, tensor inputs by position or name,
as mxtpu's ``_make_nd_fn`` maps them.

torch is imported lazily and pinned to one thread: several test workers
share the host."""
import numpy as np
import pytest

import mxtpu  # noqa: F401  (registers the JAX ops)
from mxtpu.ops import registry as jreg

FWD_RTOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(scope="module")
def tt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return torch, mxtpu_torch


def _r(shape, seed, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            + shift).astype(np.float32)


def _pos(shape, seed):
    return np.abs(_r(shape, seed)) + 0.5


UNARY = ["relu", "sigmoid", "_copy", "negative", "abs", "square", "exp"]
COMPARE = ["equal", "not_equal", "greater", "greater_equal", "lesser",
           "lesser_equal"]
SCALAR = ["_plus_scalar", "_minus_scalar", "_rminus_scalar", "_mul_scalar",
          "_div_scalar", "_rdiv_scalar", "_maximum_scalar",
          "_minimum_scalar", "_power_scalar", "_rpower_scalar"]
# ties planted for the comparisons and maximum/minimum: equal halves
_TIE_L = np.array([[0.5, -1.0, 2.0], [0.25, 3.0, -2.0]], np.float32)
_TIE_R = np.array([[0.5, 1.0, 2.0], [-0.25, 3.0, 1.0]], np.float32)

# (op, inputs, attrs, indices of the inputs to differentiate)
CASES = (
    [(n, [_r((3, 4), i)], {}, [0]) for i, n in enumerate(UNARY)] +
    [("sqrt", [_pos((3, 4), 10)], {}, [0]),
     ("log", [_pos((3, 4), 11)], {}, [0]),
     ("zeros_like", [_r((2, 3), 12)], {}, []),
     ("ones_like", [_r((2, 3), 13)], {}, [])] +
    [(n, [_r((2, 3, 4), 20 + i), _r((2, 3, 4), 30 + i, shift=2.0)], {},
      [0, 1]) for i, n in enumerate(["elemwise_sub", "elemwise_mul",
                                     "elemwise_div", "_minus", "_mul",
                                     "_div"])] +
    [(n, [_TIE_L, _TIE_R], {}, [0, 1]) for n in ("_maximum", "_minimum")] +
    [("_power", [_pos((3, 4), 40), _r((3, 4), 41)], {}, [0, 1])] +
    [("_" + n, [_TIE_L, _TIE_R], {}, []) for n in COMPARE] +
    [(n, [_pos((3, 4), 50 + i)], {"scalar": 1.5}, [0])
     for i, n in enumerate(SCALAR)] +
    [(n, [_TIE_L], {"scalar": 0.5}, [0])
     for n in ("_maximum_scalar", "_minimum_scalar")] +
    [("_%s_scalar" % n, [_TIE_L], {"scalar": 0.5}, []) for n in COMPARE] +
    [("broadcast_" + n, [_r((2, 3, 4), 60 + i), _r((1, 3, 1), 70 + i,
                                                    shift=2.0)], {}, [0, 1])
     for i, n in enumerate(["sub", "mul", "div", "minus", "plus",
                            "maximum", "minimum"])] +
    [("broadcast_power", [_pos((2, 3), 80), _r((2, 1), 81)], {}, [0, 1])] +
    [("broadcast_" + n, [_TIE_L, _TIE_R[:1]], {}, []) for n in COMPARE] +
    [("broadcast_to", [_r((1, 3, 1), 90)], {"shape": (2, 3, 4)}, [0]),
     ("broadcast_to", [_r((2, 1), 91)], {"shape": (0, 5)}, [0])] +
    [(n, [_r((2, 3, 4), 100 + i)], attrs, [0])
     for i, (n, attrs) in enumerate(
         [(n, a) for n in ("sum", "mean", "max", "min")
          for a in ({}, {"axis": 1}, {"axis": (0, 2), "keepdims": True},
                    {"axis": 0, "exclude": True},
                    {"axis": -1, "keepdims": True, "exclude": True})])] +
    [("mean", [_r((5,), 120)], {"axis": 0, "exclude": True}, [0]),
     ("norm", [_r((3, 4), 121)], {}, [0]),
     ("argmax", [_r((3, 5), 122)], {}, []),
     ("argmax", [_r((3, 5), 123)], {"axis": 1}, []),
     ("argmax", [_r((3, 5), 124)], {"axis": 0, "keepdims": True}, []),
     ("pick", [_r((4, 5), 130), np.array([0, 4, 2, 2], np.float32)],
      {}, [0]),
     ("pick", [_r((4, 5), 131), np.array([1, 0, 3, 2, 1], np.float32)],
      {"axis": 0, "keepdims": True}, [0]),
     # indices outside [-n, n) give NaN and no gradient; in-range
     # negative ones wrap (ROADMAP C.3)
     ("pick", [_r((4, 5), 132), np.array([-6, -1, 5, 7], np.float32)],
      {"axis": 1}, [0]),
     ("pick", [_r((3, 4), 133), np.array([-1, -4, 4, 2], np.float32)],
      {"axis": 0, "keepdims": True}, [0]),
     # ids outside [0, input_dim): NaN rows with no gradient to the
     # weight, in-range negative ids wrap (ROADMAP C.2)
     ("Embedding", [np.array([[-7, -6, -5, -1, 0], [4, 5, 9, 2.7, -0.5]],
                             np.float32), _r((5, 3), 134)],
      {"input_dim": 5, "output_dim": 3}, [1]),
     ("reshape_like", [_r((2, 6), 140), _r((3, 4), 141)], {}, [0]),
     ("expand_dims", [_r((2, 3), 142)], {"axis": 1}, [0]),
     ("expand_dims", [_r((2, 3), 143)], {"axis": -1}, [0]),
     ("SwapAxis", [_r((2, 3, 4), 144)], {"dim1": 0, "dim2": 2}, [0]),
     ("swapaxes", [_r((2, 3, 4), 145)], {"dim1": 1, "dim2": 2}, [0]),
     ("stack", [_r((2, 3), 146), _r((2, 3), 147), _r((2, 3), 148)],
      {"num_args": 3, "axis": 1}, [0, 1, 2]),
     ("take", [_r((5, 3), 150), np.array([[0, 4], [4, 1]], np.float32)],
      {}, [0]),
     ("take", [_r((3, 5), 151), np.array([-2, 7, 3], np.float32)],
      {"axis": 1}, [0]),
     ("take", [_r((3, 5), 152), np.array([-2, 7, 3], np.float32)],
      {"axis": 1, "mode": "wrap"}, [0]),
     ("where", [np.array([[1, 0, 1], [0, 0, 1]], np.float32),
                _r((2, 3), 153), _r((2, 3), 154)], {}, [1, 2]),
     ("softmax", [_r((3, 7), 160, 3.0)], {}, [0]),
     ("softmax", [_r((2, 4, 3), 161)], {"axis": 1}, [0]),
     ("softmax", [_r((3, 5), 162)], {"temperature": 2.0}, [0]),
     ("log_softmax", [_r((3, 7), 163, 3.0)], {}, [0]),
     ("log_softmax", [_r((2, 4, 3), 164)], {"axis": 1}, [0]),
     ("LeakyReLU", [_r((3, 6), 170)], {}, [0]),
     ("LeakyReLU", [_r((3, 6), 171)], {"act_type": "leaky", "slope": 0.1},
      [0]),
     ("LeakyReLU", [_r((3, 6), 172)], {"act_type": "elu", "slope": 0.5},
      [0]),
     ("LeakyReLU", [_r((2, 3, 4), 173), _r((3,), 174)],
      {"act_type": "prelu"}, [0, 1]),
     ("LeakyReLU", [_r((3, 6), 175)], {"act_type": "rrelu"}, [0])])
IDS = ["%s-%d" % (c[0], i) for i, c in enumerate(CASES)]


def _jax_fwd(name, arrays, attrs):
    """mxtpu's op on an empty per-op jit cache, put back afterwards
    (ROADMAP C: mxtpu keys that process-wide cache on hash(attrs))."""
    import jax.numpy as jnp
    op = jreg.get_op(name)
    saved, op._jit_cache = op._jit_cache, {}
    try:
        _, _, outs = jreg.invoke(name, [jnp.asarray(a) for a in arrays],
                                 dict(attrs))
    finally:
        op._jit_cache = saved
    return [np.asarray(o, np.float32) for o in outs]


@pytest.mark.parametrize("name,arrays,attrs,diff", CASES, ids=IDS)
def test_forward_matches_mxtpu(tt, name, arrays, attrs, diff):
    torch, mt = tt
    _, _, outs = mt.ops.registry.invoke(
        name, [torch.from_numpy(a.copy()) for a in arrays], dict(attrs))
    want = _jax_fwd(name, arrays, attrs)
    assert len(outs) == len(want)
    for got, ref in zip(outs, want):
        got = got.to(torch.float32).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=FWD_RTOL, atol=FWD_RTOL)


GRAD_CASES = [(c, i) for c, i in zip(CASES, IDS) if c[3]]


@pytest.mark.parametrize("name,arrays,attrs,diff",
                         [c for c, _ in GRAD_CASES],
                         ids=[i for _, i in GRAD_CASES])
def test_gradient_matches_mxtpu(tt, name, arrays, attrs, diff):
    import jax
    import jax.numpy as jnp
    torch, mt = tt
    jop = jreg.get_op(name)
    ja = jop.parse_attrs(dict(attrs))

    def jf(*xs):
        full = [jnp.asarray(x) for x in arrays]
        for i, x in zip(diff, xs):
            full[i] = x
        out = jop.fn(ja, *full)
        return out[0] if isinstance(out, (tuple, list)) else out

    out, vjp = jax.vjp(jf, *[jnp.asarray(arrays[i]) for i in diff])
    head = np.asarray(np.random.RandomState(len(name)).randn(*out.shape),
                      np.float32)
    want = [np.asarray(g, np.float32) for g in vjp(jnp.asarray(head))]

    op = mt.ops.registry.get_op(name)
    xs = [torch.from_numpy(a.copy()) for a in arrays]
    for i in diff:
        xs[i].requires_grad_()
    pout = op.apply(op.parse_attrs(dict(attrs)), xs)[0]
    got = torch.autograd.grad(pout, [xs[i] for i in diff],
                              torch.from_numpy(head))
    scale = max(1.0, max(float(np.abs(w).max()) for w in want))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * scale)


def test_nd_functions_map_positionals_as_mxtpu(tt):
    """``nd.<op>``: a non-tensor positional fills the first attr not
    given by keyword, tensors go by position or arg name, ``out=``
    writes in place; each as mxtpu's generated function."""
    torch, mt = tt
    x = _r((2, 3, 4), 200)
    idx = np.array([[0, 2, 1], [3, 3, 0]], np.float32)
    with mt.cpu():
        a = mt.nd.array(x)
        got = [mt.nd.sum(a, 1).asnumpy(),                 # axis
               mt.nd.sum(a, 1, True).asnumpy(),           # axis, keepdims
               mt.nd.pick(a, mt.nd.array(idx), 2).asnumpy(),
               mt.nd.pick(index=mt.nd.array(idx), data=a,
                          axis=2).asnumpy(),
               mt.nd.SwapAxis(a, 0, 2).asnumpy(),
               mt.nd.stack(a, a, axis=1).asnumpy(),
               mt.nd.stack([a, a]).asnumpy(),
               mt.nd.maximum(a, 0.25).asnumpy(),
               mt.nd.minimum(0.25, a).asnumpy(),
               mt.nd.greater(a, 0.0).asnumpy()]
        out = mt.nd.zeros((2, 4))
        mt.nd.sum(a, axis=1, out=out)
    jx = mxtpu.nd.array(x)
    jidx = mxtpu.nd.array(idx)
    want = [mxtpu.nd.sum(jx, 1), mxtpu.nd.sum(jx, 1, True),
            mxtpu.nd.pick(jx, jidx, 2),
            mxtpu.nd.pick(index=jidx, data=jx, axis=2),
            mxtpu.nd.SwapAxis(jx, 0, 2), mxtpu.nd.stack(jx, jx, axis=1),
            mxtpu.nd.stack([jx, jx]), mxtpu.nd.maximum(jx, 0.25),
            mxtpu.nd.minimum(0.25, jx), mxtpu.nd.greater(jx, 0.0)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.asnumpy(), rtol=FWD_RTOL,
                                   atol=FWD_RTOL)
    np.testing.assert_allclose(out.asnumpy(), x.sum(1), rtol=FWD_RTOL)


def test_ndarray_operators_match_mxtpu(tt):
    """The arithmetic and comparison operators, the reductions and the
    shape methods of NDArray, against mxtpu's NDArray."""
    torch, mt = tt
    x, y = _r((3, 4), 210), _r((3, 4), 211, shift=3.0)

    def body(nd):
        a, b = nd.array(x), nd.array(y)
        res = [a + b, a - b, a * b, a / b, a + 2, 2 - a, a * 3, 3 / b,
               b ** 2, 2 ** a, -a, a > b, a >= 0.1, a < b, a <= 0.1,
               a == a, a != b, a.sum(), a.mean(axis=0), a.max(axis=1),
               a.min(), a.argmax(axis=1), a.T, a.transpose((1, 0)),
               a.reshape((2, 6)), a.flatten(), a.expand_dims(0),
               a.broadcast_to((3, 4)), a.astype("float32"), a.copy(),
               a[1], a[1:3], a[:, 2], a[::2], a[::-1]]
        return [r.asnumpy() for r in res]

    with mt.cpu():
        got = body(mt.nd)
    want = body(mxtpu.nd)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g, w, rtol=FWD_RTOL, atol=FWD_RTOL,
                                   err_msg=str(i))
    with mt.cpu():
        a = mt.nd.array(x)
        assert a.size == 12 and a.ndim == 2 and len(a) == 3
        assert mt.nd.array([2.5]).asscalar() == 2.5
        with pytest.raises(mt.MXNetError, match="scalar"):
            a.asscalar()
        assert [r.shape for r in a] == [(4,)] * 3
        np.testing.assert_array_equal(
            mt.nd.arange(2, 8, 2, repeat=2).asnumpy(),
            mxtpu.nd.arange(2, 8, 2, repeat=2).asnumpy())
        np.testing.assert_array_equal(mt.nd.full((2,), 7).asnumpy(), [7, 7])
        np.testing.assert_array_equal(mt.nd.ones(3).asnumpy(), [1, 1, 1])
        np.testing.assert_array_equal(
            mt.nd.concatenate([a, a], axis=1).asnumpy(),
            np.concatenate([x, x], axis=1))


def test_every_ported_op_has_mxtpus_signature(tt):
    """Every op name in the port's registry (aliases included) has
    mxtpu's attrs with their defaults, arg names, aux names and
    variadic attr."""
    torch, mt = tt
    preg = mt.ops.registry

    def spec(reg, op):
        return {k: (("required", getattr(v.proto, "__name__", v.proto))
                    if isinstance(v, reg.Required) else v)
                for k, v in op.attrs_spec.items()}

    differ = []
    for name in preg.list_ops():
        p, j = preg.get_op(name), jreg.get_op(name)
        same_args = callable(p.arg_names) == callable(j.arg_names) and (
            callable(p.arg_names) or list(p.arg_names) == list(j.arg_names))
        if spec(preg, p) != spec(jreg, j) or not same_args or \
                list(p.aux_names) != list(j.aux_names) or \
                p.variadic != j.variadic:
            differ.append(name)
    assert len(preg.list_ops()) >= 104
    assert not differ, differ
