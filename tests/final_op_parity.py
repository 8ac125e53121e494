"""One case of ``final_op_cases.py`` through mxtpu's op (JAX on the CPU)
and the port's (PyTorch on the CPU): the forward, and the gradient under
seeded random head gradients, ``torch.autograd.grad`` of the port's op
against ``jax.vjp`` of mxtpu's. JAX and torch are imported when a
function runs."""
import numpy as np

import mxtpu  # noqa: F401  (registers the JAX ops)
from mxtpu.ops import registry as jreg


def close(got, want, tol, what):
    """Same shape, the same NaN and infinity positions, the rest within
    ``tol`` of the largest finite magnitude of ``want`` (at least 1)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bad = ~np.isfinite(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), what)
    np.testing.assert_array_equal(got[bad & ~np.isnan(want)],
                                  want[bad & ~np.isnan(want)], what)
    fin = want[~bad]
    scale = max(1.0, float(np.abs(fin).max())) if fin.size else 1.0
    np.testing.assert_allclose(got[~bad], fin, rtol=0, atol=tol * scale,
                               err_msg=what)


def _jax_fn(name, arrays, attrs, diff, outs):
    import jax.numpy as jnp
    op = jreg.get_op(name)
    a = op.parse_attrs(dict(attrs))

    def f(*xs):
        full = [jnp.asarray(x) for x in arrays]
        for i, x in zip(diff, xs):
            full[i] = x
        res = op.fn(a, *full)
        res = tuple(res) if isinstance(res, (tuple, list)) else (res,)
        return tuple(res[k] for k in outs)
    return f


def check_forward(torch, mt, name, arrays, attrs, tol):
    """Every output: dtype, shape and values within ``tol``."""
    import jax.numpy as jnp
    op = jreg.get_op(name)
    want = op.fn(op.parse_attrs(dict(attrs)),
                 *[jnp.asarray(x) for x in arrays])
    want = [np.asarray(w) for w in (want if isinstance(want, (tuple, list))
                                    else (want,))]
    _, _, got = mt.ops.registry.invoke(
        name, [torch.from_numpy(x.copy()) for x in arrays], dict(attrs))
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert mt.ops.registry.numpy_dtype(g.dtype) == w.dtype, (k, g.dtype)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g.numpy(), w, "output %d" % k)
        else:
            close(g.numpy(), w, tol, "output %d" % k)
    return got, want


def check_gradient(torch, mt, name, arrays, attrs, diff, outs, tol):
    """d(outputs ``outs``)/d(inputs ``diff``) under one seeded head
    gradient an output, against ``jax.vjp``."""
    import jax
    import jax.numpy as jnp
    f = _jax_fn(name, arrays, attrs, diff, outs)
    res, vjp = jax.vjp(f, *[jnp.asarray(arrays[i]) for i in diff])
    rng = np.random.RandomState(len(name))
    heads = [rng.randn(*r.shape).astype(np.float32) for r in res]
    want = [np.asarray(g) for g in vjp(tuple(jnp.asarray(h)
                                             for h in heads))]
    op = mt.ops.registry.get_op(name)
    xs = [torch.from_numpy(x.copy()) for x in arrays]
    for i in diff:
        xs[i].requires_grad_()
    got_outs = op.apply(op.parse_attrs(dict(attrs)), xs)
    sel = [got_outs[k] for k in outs]
    got = torch.autograd.grad(sel, [xs[i] for i in diff],
                              [torch.from_numpy(h) for h in heads],
                              allow_unused=True)
    for k, (g, w, i) in enumerate(zip(got, want, diff)):
        g = torch.zeros_like(xs[i]) if g is None else g
        close(g.detach().numpy(), w, tol, "d input %d" % i)
