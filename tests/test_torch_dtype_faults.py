"""The port's NDArray types and its gradients at ties against mxtpu's
(ROADMAP C.8-C.14): the same numpy inputs through both packages'
NDArray surface on the CPU (mxtpu on JAX's CPU backend).

- C.12: ``NDArray.dtype`` is a numpy dtype, equal to mxtpu's; bfloat16
  gives the documented stand-in ``registry.BFLOAT16`` (a deliberate
  delta: numpy has no bfloat16 without ml_dtypes).
- C.13: the constructors and ``nd.array`` take numpy types; ``nd.array``
  keeps an NDArray's type and narrows numpy's int64/float64 as mxtpu;
  ``NDArrayIter`` of float16 data stays float16.
- C.10: every ``*_scalar`` op puts the scalar in the array's type first,
  so integer arrays stay integer (and wrap), out-of-range scalars raise,
  ``/`` gives float32, in both packages alike.
- C.11: sums of integer arrays are int32 (uint8: uint32) and wrap;
  means of integer arrays are float32. float64 reduces to float64 in the
  port (a deliberate delta: mxtpu runs with x64 off).
- C.8: relu's and ``Activation(relu)``'s gradient at 0 is 1/2, abs's 1.
- C.9: ``power``'s gradients at 0 ** 0 are NaN as mxtpu's.
- C.14: basic indexing returns a view in the port (a deliberate delta,
  the reference MXNet's behaviour); mxtpu copies.

torch is imported lazily and pinned to one thread: several test workers
share the host."""
import numpy as np
import pytest

import mxtpu as mx
from mxtpu.ops import registry as jreg


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


DTYPES = ["float32", "float16", "int32", "int8", "uint8"]


def _both(mt, fn):
    """``fn(package)`` under each package's cpu() scope: (port, mxtpu)."""
    with mt.cpu():
        got = fn(mt)
    with mx.cpu():
        want = fn(mx)
    return got, want


def _same(got, want):
    """Same numpy dtype, shape and values (NaN where NaN)."""
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    g, w = got.asnumpy(), want.asnumpy()
    assert g.dtype == w.dtype and g.shape == w.shape
    np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------------ C.12
@pytest.mark.parametrize("dt", DTYPES + ["float64"])
def test_dtype_is_mxtpus_numpy_dtype(mt, dt):
    src = np.arange(6).reshape(2, 3)
    got, want = _both(mt, lambda p: p.nd.array(src, dtype=dt))
    assert isinstance(got.dtype, np.dtype)
    assert got.dtype == np.dtype(dt) and got.dtype == getattr(np, dt)
    if dt != "float64":  # mxtpu's float64 is float32 (x64 off)
        assert got.dtype == want.dtype
    assert np.zeros(3, dtype=got.dtype).dtype == got.dtype
    assert got.astype(got.dtype).dtype == got.dtype


def test_bfloat16_dtype_is_the_documented_stand_in(mt):
    """A deliberate delta (ROADMAP C): mxtpu's bfloat16 dtype comes from
    ml_dtypes; the port's is ``registry.BFLOAT16``, which round-trips
    through the constructors and names "bfloat16" in files."""
    import torch
    reg = mt.ops.registry
    with mt.cpu():
        x = mt.nd.array(np.arange(4.0), dtype="bfloat16")
        assert x.dtype == reg.BFLOAT16 and x.dtype != np.float32
        assert x._data.dtype == torch.bfloat16
        assert mt.nd.zeros((2,), dtype=x.dtype)._data.dtype == torch.bfloat16
        assert reg.torch_dtype(x.dtype) == torch.bfloat16
        assert mt.nd.ndarray.dtype_name(x.dtype) == "bfloat16"
        assert x.astype(np.float32).dtype == np.float32


# ------------------------------------------------------------------ C.13
@pytest.mark.parametrize("kind", ["class", "dtype", "str"])
@pytest.mark.parametrize("dt", DTYPES)
def test_constructors_take_numpy_types(mt, dt, kind):
    arg = {"class": getattr(np, dt), "dtype": np.dtype(dt), "str": dt}[kind]
    for make in (lambda p: p.nd.zeros((2, 3), dtype=arg),
                 lambda p: p.nd.ones((2, 3), dtype=arg),
                 lambda p: p.nd.empty((2, 3), dtype=arg),
                 lambda p: p.nd.full((2, 3), 7, dtype=arg),
                 lambda p: p.nd.array([[1, 2, 3]], dtype=arg)):
        got, want = _both(mt, make)
        assert got.dtype == want.dtype == np.dtype(dt)


SOURCES = {
    "int64 numpy": np.arange(5, dtype=np.int64),
    "float64 numpy": np.linspace(0, 1, 5),
    "float16 numpy": np.linspace(0, 1, 5).astype(np.float16),
    "uint8 numpy": np.arange(5, dtype=np.uint8),
    "int16 numpy": np.arange(5, dtype=np.int16),
    "bool numpy": np.array([True, False, True]),
    "list of ints": [1, 2, 3],
    "list of floats": [1.0, 2.5],
    "nested list": [[1, 2], [3, 4]],
}


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_array_follows_mxtpus_type_rule(mt, name):
    src = SOURCES[name]
    got, want = _both(mt, lambda p: p.nd.array(src))
    _same(got, want)


@pytest.mark.parametrize("dt", DTYPES)
def test_array_of_an_ndarray_keeps_its_type(mt, dt):
    src = np.arange(6).reshape(2, 3).astype(dt)
    got, want = _both(mt, lambda p: p.nd.array(p.nd.array(src, dtype=dt)))
    _same(got, want)
    assert got.dtype == np.dtype(dt)


def test_ndarrayiter_of_float16_data_stays_float16(mt):
    x = np.random.RandomState(0).rand(8, 3).astype(np.float16)
    y = np.arange(8, dtype=np.float32)

    def first(p):
        it = p.io.NDArrayIter(x, y, batch_size=4)
        return it.provide_data[0].dtype, it.next().data[0]

    (gdesc, gb), (wdesc, wb) = _both(mt, first)
    assert gdesc == wdesc == np.float16
    _same(gb, wb)


def test_simple_bind_takes_numpy_type_dict(mt):
    def bind(p):
        net = p.sym.FullyConnected(p.sym.Variable("data"), num_hidden=3,
                                   name="fc")
        ex = net.simple_bind(p.cpu(), data=(2, 4),
                             type_dict={"data": np.float64})
        return ex.arg_dict["data"]

    got, _ = _both(mt, bind)
    assert got.dtype == np.float64


# ------------------------------------------------------------------ C.10
SCALAR_OPS = ["_plus_scalar", "_minus_scalar", "_rminus_scalar",
              "_mul_scalar", "_div_scalar", "_rdiv_scalar",
              "_maximum_scalar", "_minimum_scalar", "_power_scalar",
              "_rpower_scalar", "_equal_scalar", "_not_equal_scalar",
              "_greater_scalar", "_greater_equal_scalar", "_lesser_scalar",
              "_lesser_equal_scalar"]
SCALARS = [0.5, 2.0, 10.0, -0.7, 3.9]


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("op", SCALAR_OPS)
def test_scalar_ops_keep_the_arrays_type(mt, op, dt):
    vals = {"uint8": [250, 3, 7, 0], "int8": [100, -3, 7, 1]}.get(
        dt, [7, -1, 2, 3])
    if op in ("_rdiv_scalar",) and dt != "float32" and dt != "float16":
        vals = [v if v else 1 for v in vals]  # no integer 0 divisor
    src = np.array(vals).astype(dt)
    for s in SCALARS:
        if op == "_power_scalar" and dt in ("int8", "uint8", "int32") \
                and s < 0:
            continue  # negative integer powers of integers
        if op == "_rpower_scalar" and dt in ("int8", "int32") and \
                (src < 0).any():
            continue
        if dt == "uint8" and s < 0 and int(s) != 0:
            continue  # out of range: raises (test below)
        got, want = _both(mt, lambda p: p.nd.invoke_op(
            op, [p.nd.array(src, dtype=dt)], {"scalar": s})[0])
        assert got.dtype == want.dtype, (s, got.dtype, want.dtype)
        # a quotient may round one ulp apart (torch divides by a number
        # as a product with its reciprocal)
        np.testing.assert_allclose(got.asnumpy().astype(np.float64),
                                   want.asnumpy().astype(np.float64),
                                   rtol=1e-3 if dt == "float16" else 1e-6,
                                   atol=0, err_msg=str(s))


@pytest.mark.parametrize("expr", ["u + 10", "u - 5", "u * 1.5", "u + 255.9",
                                  "i + 0.5", "i - 0.7", "0.7 - i", "i ** 0.5",
                                  "i / 2", "2 / i", "i == 0.5", "u / 2"])
def test_operators_on_integer_arrays_as_mxtpu(mt, expr):
    def run(p):
        u = p.nd.array(np.array([250, 3], np.uint8))
        i = p.nd.array(np.array([7, 1], np.int32))
        return eval(expr, {"u": u, "i": i})

    got, want = _both(mt, run)
    _same(got, want)


@pytest.mark.parametrize("s", [-1, 256, float("nan"), float("inf")])
def test_out_of_range_scalars_raise_in_both(mt, s):
    for p in (mt, mx):
        with p.cpu():
            u = p.nd.array(np.array([250, 3], np.uint8))
            with pytest.raises((OverflowError, ValueError)):
                (u + s).asnumpy()


@pytest.mark.parametrize("dt", ["float16", "float32"])
def test_float_scalar_arithmetic_keeps_the_float_type(mt, dt):
    src = np.linspace(-1, 1, 7).astype(dt)
    for expr in ("x + 0.1", "x * 3.3", "x - 1e-3", "0.7 / (x + 2)"):
        got, want = _both(mt, lambda p: eval(
            expr, {"x": p.nd.array(src, dtype=dt)}))
        assert got.dtype == want.dtype == np.dtype(dt)
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(),
                                   rtol=1e-3 if dt == "float16" else 1e-6)


def test_bfloat16_scalar_arithmetic_stays_bfloat16(mt):
    import torch
    with mt.cpu():
        x = mt.nd.array(np.linspace(-1, 1, 7), dtype="bfloat16")
        for y in (x + 0.1, x * 3.3, 2 - x, x / 3):
            assert y._data.dtype == torch.bfloat16


# ------------------------------------------------------------------ C.11
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("fn", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("axis", [None, 1])
def test_reductions_of_each_type_as_mxtpu(mt, dt, fn, axis):
    rng = np.random.RandomState(0)
    src = (rng.rand(3, 40) * 100).astype(dt)
    got, want = _both(mt, lambda p: getattr(p.nd.array(src, dtype=dt), fn)(
        axis=axis))
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got.asnumpy().astype(np.float64),
                               want.asnumpy().astype(np.float64),
                               rtol=2e-3 if dt == "float16" else 1e-6)


@pytest.mark.parametrize("dt,vals", [("int32", [2 ** 30, 2 ** 30, 5]),
                                     ("uint8", [200, 100, 7]),
                                     ("int8", [100, 100, 100])])
def test_integer_sums_wrap_as_mxtpu(mt, dt, vals):
    got, want = _both(mt, lambda p: p.nd.array(np.array(vals, dt)).sum())
    _same(got, want)


def test_float64_reduces_to_float64_in_the_port(mt):
    """A deliberate delta (ROADMAP C): mxtpu runs with x64 off, so its
    float64 array is float32 and sums to float32; the port keeps
    float64."""
    src = np.linspace(0, 1, 11)
    got, want = _both(mt, lambda p: p.nd.array(src, dtype="float64").sum())
    assert got.dtype == np.float64 and want.dtype == np.float32
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-6)


# ------------------------------------------------------------------ C.8, C.9
TIES = np.array([-1.0, 0.0, -0.0, 2.0, 0.5], np.float32)


def _grads(mt, f, arrays, diff):
    """(port, mxtpu) gradients of sum(f(pkg, *arrays)) by autograd."""
    def run(p):
        xs = [p.nd.array(a) for a in arrays]
        for i in diff:
            xs[i].attach_grad()
        with p.autograd.record():
            y = f(p, *xs)
        y.backward()
        return [xs[i].grad.asnumpy() for i in diff]
    return _both(mt, run)


UNARY_TIES = {
    "relu": lambda p, x: p.nd.relu(x),
    "Activation(relu)": lambda p, x: p.nd.Activation(x, act_type="relu"),
    "abs": lambda p, x: p.nd.abs(x),
    "LeakyReLU": lambda p, x: p.nd.LeakyReLU(x, slope=0.1),
    "maximum(x, 0)": lambda p, x: p.nd.maximum(x, 0),
    "x ** 0": lambda p, x: x ** 0,
    "x ** 2": lambda p, x: x ** 2,
    "x ** 0.5": lambda p, x: x ** 0.5,
    "0 ** x": lambda p, x: 0 ** x,
    "2 ** x": lambda p, x: 2 ** x,
    "-2 ** x": lambda p, x: (-2) ** x,
}


@pytest.mark.parametrize("name", sorted(UNARY_TIES))
def test_gradients_at_ties_and_zeros_as_mxtpu(mt, name):
    got, want = _grads(mt, UNARY_TIES[name], [TIES], [0])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, equal_nan=True)


def test_relu_and_abs_gradients_at_zero(mt):
    """The C.8 rule itself: relu's gradient at 0 (either sign) is 1/2,
    abs's is 1."""
    relu, _ = _grads(mt, UNARY_TIES["relu"], [TIES], [0])
    absg, _ = _grads(mt, UNARY_TIES["abs"], [TIES], [0])
    np.testing.assert_array_equal(relu[0], [0, 0.5, 0.5, 1, 1])
    np.testing.assert_array_equal(absg[0], [-1, 1, 1, 1, 1])


@pytest.mark.parametrize("op,lhs,rhs", [
    ("_power", [0.0, 0.0, 2.0, -1.0, 0.0], [0.0, 1.0, 0.0, 2.0, 0.5]),
    ("broadcast_power", [[0.0], [2.0]], [[0.0, 1.0, 0.5]]),
    ("broadcast_power", [[0.0, 0.0]], [[0.0], [0.0], [2.0]]),
])
def test_power_gradients_at_zero_to_the_zero_as_mxtpu(mt, op, lhs, rhs):
    import jax
    import jax.numpy as jnp
    import torch
    a, b = (np.array(v, np.float32) for v in (lhs, rhs))
    jop = jreg.get_op(op)
    y, vjp = jax.vjp(lambda x, e: jop.fn(jop.parse_attrs({}), x, e),
                     jnp.asarray(a), jnp.asarray(b))
    want = [np.asarray(g) for g in vjp(jnp.ones_like(y))]
    ta, tb = (torch.from_numpy(v.copy()).requires_grad_() for v in (a, b))
    pop = mt.ops.registry.get_op(op)
    out = pop.fn(pop.parse_attrs({}), ta, tb)
    got = torch.autograd.grad(out.sum(), [ta, tb])
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, equal_nan=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y),
                               rtol=1e-6)


# ------------------------------------------------------------------ C.14
VIEW_CASES = {
    "b = a[1]; b[:] = 0": "b = a[1]\nb[:] = 0",
    "a[0][1] = 9": "a[0][1] = 9",
    "b = a[0:1]; b += 1": "b = a[0:1]\nb += 1",
}


@pytest.mark.parametrize("name", sorted(VIEW_CASES))
def test_basic_indexing_is_a_view_in_the_port(mt, name):
    """A deliberate delta (ROADMAP C.14): the port's basic index is a
    view, as the reference MXNet's ``_at``/``_slice``; mxtpu copies,
    because a JAX array cannot alias (listed under its faults)."""
    src = np.arange(6, dtype=np.float32).reshape(2, 3)

    def run(p):
        a = p.nd.array(src)
        exec(VIEW_CASES[name], {"a": a})
        return a.asnumpy()

    got, want = _both(mt, run)
    np.testing.assert_array_equal(want, src)
    assert not np.array_equal(got, src)


def test_slice_update_in_place_agrees(mt):
    src = np.arange(6, dtype=np.float32).reshape(2, 3)

    def run(p):
        a = p.nd.array(src)
        a[0:1] += 1
        return a.asnumpy()

    got, want = _both(mt, run)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], src[0] + 1)
