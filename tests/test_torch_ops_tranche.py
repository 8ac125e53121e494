"""The 97 op names the port took over from ``mxtpu/ops/tensor.py`` and
``mxtpu/ops/nn.py`` in one tranche, against mxtpu's: the same numpy inputs
through mxtpu's op (JAX on the CPU, on an empty jit cache) and the port's
(PyTorch on the CPU). Forward: the same dtype, shape and NaN positions,
values within 1e-5 relative. Where the op is differentiable, the gradient
under one random head gradient, ``torch.autograd.grad`` of the port's op
against ``jax.vjp`` of mxtpu's, within 1e-4 of the largest finite
gradient, with infinities and NaNs at the same places. The inputs plant
exact zeros, ties, the clip bounds, NaN and -0.0 for the sorts, indices
out of range, an int32 zero divisor, and integer and float16 arrays
where mxtpu takes them (``op_tranche_cases.py``). Then a census of the
port's names against mxtpu's registry: all 290.

torch is imported lazily and pinned to one thread: several test workers
share the host."""
import inspect

import numpy as np
import pytest

import mxtpu  # noqa: F401  (registers the JAX ops)
from mxtpu.ops import registry as jreg
from op_tranche_cases import CASES, _a

FWD_RTOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(scope="module")
def tt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return torch, mxtpu_torch


IDS = ["%s-%d" % (c[0], i) for i, c in enumerate(CASES)]


def _jax_run(name, arrays, attrs):
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
    return [np.asarray(o) for o in outs]


def _close(got, want, tol, what):
    """Same shape, the same NaN and infinity positions, the rest within
    ``tol`` of the largest finite magnitude of ``want`` (at least 1)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    bad = ~np.isfinite(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), what)
    np.testing.assert_array_equal(got[bad & ~np.isnan(want)],
                                  want[bad & ~np.isnan(want)], what)
    fin = want[~bad]
    scale = max(1.0, float(np.abs(fin).max())) if fin.size else 1.0
    np.testing.assert_allclose(got[~bad], fin, rtol=0, atol=tol * scale,
                               err_msg=what)


def _port_dtype(mt, t):
    return mt.ops.registry.numpy_dtype(t.dtype)


@pytest.mark.parametrize("name,arrays,attrs,diff", CASES, ids=IDS)
def test_forward_matches_mxtpu(tt, name, arrays, attrs, diff):
    torch, mt = tt
    _, _, outs = mt.ops.registry.invoke(
        name, [torch.from_numpy(a.copy()) for a in arrays], dict(attrs))
    want = _jax_run(name, arrays, attrs)
    assert len(outs) == len(want)
    for got, ref in zip(outs, want):
        assert _port_dtype(mt, got) == ref.dtype, (got.dtype, ref.dtype)
        g = got.numpy()
        if np.issubdtype(ref.dtype, np.integer):
            np.testing.assert_array_equal(g, ref)
        else:
            np.testing.assert_allclose(g.astype(np.float64),
                                       ref.astype(np.float64),
                                       rtol=FWD_RTOL, atol=FWD_RTOL,
                                       equal_nan=True)
            # -0.0 and 0.0 where mxtpu has them (the sorts keep the sign)
            np.testing.assert_array_equal(np.signbit(g[g == 0]),
                                          np.signbit(ref[g == 0]))


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
    wrt = [xs[i] for i in diff]
    if pout.requires_grad:
        got = torch.autograd.grad(pout, wrt, torch.from_numpy(head),
                                  allow_unused=True)
    else:  # BlockGrad: no path back
        got = [None] * len(wrt)
    got = [torch.zeros_like(x) if g is None else g for g, x in zip(got, wrt)]
    for k, (g, w) in enumerate(zip(got, want)):
        _close(g.detach().numpy(), w, GRAD_TOL, "input %d" % diff[k])


def test_the_tie_and_range_cases_pinned(tt):
    """The cases the tranche was written against, as plain numbers."""
    torch, mt = tt
    reg = mt.ops.registry
    x = torch.tensor([0.0, 0.5, 1.0], requires_grad=True)
    _, _, (y,) = reg.invoke("clip", [x], {"a_min": 0.0, "a_max": 1.0})
    (g,) = torch.autograd.grad(y.sum(), [x])
    assert g.tolist() == [0.5, 1.0, 0.5]
    _, _, (k,) = reg.invoke("topk", [torch.tensor([1.0, 3.0, 3.0, 2.0])],
                            {"k": 2})
    assert k.tolist() == [1.0, 2.0]
    _, _, (h,) = reg.invoke("one_hot", [torch.tensor([-1.0, 3.0])],
                            {"depth": 3})
    assert h.tolist() == [[0.0] * 3] * 2
    _, _, (m,) = reg.invoke("_mod", [torch.tensor([5], dtype=torch.int32),
                                     torch.tensor([0], dtype=torch.int32)],
                            {})
    assert m.tolist() == [0] and m.dtype == torch.int32
    _, _, (gm,) = reg.invoke("gamma", [torch.tensor([-0.5])], {})
    assert abs(gm.item() - 3.5449077) < 1e-5   # |Gamma(-0.5)|, as mxtpu
    _, _, (r,) = reg.invoke("round", [torch.tensor([0.5, 1.5, 2.5])], {})
    assert r.tolist() == [0.0, 2.0, 2.0]        # half to even, as mxtpu


def test_ndarray_surface_reaches_the_new_ops(tt):
    """``a % b``, ``nd.clip``, ``nd.dot``, ``nd.topk``, ``nd.one_hot`` and
    the others through the NDArray surface, against mxtpu's."""
    torch, mt = tt
    x = _a([[5.5, -3.0, 2.0], [0.0, 7.0, -1.5]])
    y = _a([[2.0, 2.0, -3.0], [1.5, 4.0, 2.0]])

    def body(nd):
        a, b = nd.array(x), nd.array(y)
        return [a % b, a % 2.5, 7.0 % b, nd.clip(a, 0.0, 5.0),
                nd.dot(a, b.T), nd.topk(a, k=2, ret_typ="value"),
                nd.one_hot(nd.array(_a([0, 2, -1])), 3), nd.tanh(a),
                nd.sort(a, is_ascend=False), nd.argsort(a),
                nd.batch_dot(nd.reshape(a, (2, 1, 3)),
                             nd.reshape(b, (2, 3, 1))),
                nd.slice(a, begin=(0, 1), end=(2, 3)), nd.tile(a, (1, 2)),
                nd.repeat(a, 2, axis=0), nd.add_n(a, b, a), nd.prod(b),
                nd.BlockGrad(a), nd.broadcast_mod(a, nd.array(_a([[3.0]]))),
                nd.gather_nd(a, nd.array(_a([[1, 0], [2, 9]])))]

    with mt.cpu():
        got = [r.asnumpy() for r in body(mt.nd)]
    want = [r.asnumpy() for r in body(mxtpu.nd)]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g, w, rtol=FWD_RTOL, atol=FWD_RTOL,
                                   err_msg=str(i))


def _module_names():
    """{mxtpu op module: its registered names (aliases included)}."""
    out = {}
    for name in jreg.list_ops():
        mod = inspect.getmodule(jreg.get_op(name).fn).__name__
        out.setdefault(mod.rsplit(".", 1)[-1], set()).add(name)
    return out


def test_census_of_the_port_against_mxtpu(tt):
    """All 290 of mxtpu's names, and no other: every op module of mxtpu's
    (linalg.py's 18 and contrib.py's CTC, fft/ifft, quantize/dequantize
    and count_sketch the last in) is in whole, each name with its
    signature (``test_every_ported_op_has_mxtpus_signature``)."""
    torch, mt = tt
    port = set(mt.ops.registry.list_ops())
    ref = set(jreg.list_ops())
    assert len(ref) == 290 and len(port) == 290
    assert port == ref
    by = _module_names()
    for done in ("tensor", "nn", "spatial", "custom", "optimizer_ops",
                 "linalg", "contrib"):
        assert by[done] <= port, done
    left = {m: sorted(n - port) for m, n in by.items() if n - port}
    assert left == {}


def test_module_level_functions_over_the_new_ops(tt):
    """``nd.hypot``/``modulo``/``moveaxis``/``onehot_encode`` and
    ``sym.hypot``/``full``/``ones``/``arange``/``pow``, against mxtpu's."""
    torch, mt = tt
    x = _a([[3.0, 0.0, -1.5], [5.0, 12.0, 2.0]])

    def nd_body(pkg):
        a = pkg.nd.array(x)
        out = pkg.nd.zeros((3, 4))
        pkg.nd.onehot_encode(pkg.nd.array(_a([1, 3, 0])), out)
        return [pkg.nd.hypot(a, 4.0), pkg.nd.hypot(2.0, a),
                pkg.nd.hypot(a, a), pkg.nd.modulo(a, 2.5),
                pkg.nd.moveaxis(a, 0, -1), out]

    def sym_body(pkg):
        v = pkg.sym.Variable("x")
        s = pkg.sym.Group([pkg.sym.hypot(v, 4.0), pkg.sym.hypot(v, v),
                           pkg.sym.pow(v, 2),
                           pkg.sym.full((2, 3), 2.5) + v,
                           pkg.sym.ones(shape=(2, 3)) + v,
                           pkg.sym.arange(start=1, stop=4)])
        ex = s.bind(pkg.cpu(), {"x": pkg.nd.array(x, ctx=pkg.cpu())})
        return ex.forward()

    assert mt.nd.hypot(3.0, 4.0) == 5.0
    with mt.cpu():
        got = [r.asnumpy() for r in nd_body(mt) + sym_body(mt)]
    want = [r.asnumpy() for r in nd_body(mxtpu) + sym_body(mxtpu)]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g, w, rtol=FWD_RTOL, err_msg=str(i))
