"""Gradients of the port's ops against mxtpu's, on the CPU.

Every op of the LM, mlp and lenet graphs: the same numpy inputs and head
gradient through ``torch.autograd.grad`` of the port's op and ``jax.vjp``
of mxtpu's (f32, atol 1e-5 relative to max(1, |grad|): the two sum in
other orders). SoftmaxOutput's own gradient (``(p - onehot) *
grad_scale``, ``use_ignore``, each ``normalization``, the head gradient
ignored), exactly as mxtpu's custom VJP within 1e-6. Dropout in
training: its keep rate and scaling, the identity at inference, and the
same mask again under ``random.seed`` (its bits are torch's generator's,
not threefry's, so only statistics are compared with mxtpu)."""
import numpy as np
import pytest

from mxtpu.ops import registry as jreg


@pytest.fixture(scope="module")
def tt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return torch, mxtpu_torch


def _grads(tt, name, attrs, inputs, diff, seed):
    """(port grads, mxtpu grads) of op ``name`` w.r.t. inputs ``diff``
    under one random head gradient."""
    import jax
    import jax.numpy as jnp
    torch, mt = tt
    jop = jreg.get_op(name)
    ja = jop.parse_attrs(attrs)

    def jf(*xs):
        full = [jnp.asarray(x) for x in inputs]
        for i, x in zip(diff, xs):
            full[i] = x
        out = jop.fn(ja, *full)
        return out[0] if isinstance(out, (tuple, list)) else out

    out, vjp = jax.vjp(jf, *[jnp.asarray(inputs[i]) for i in diff])
    g = np.random.RandomState(seed).randn(*out.shape).astype(np.float32)
    want = [np.asarray(x, np.float32) for x in vjp(jnp.asarray(g))]

    op = mt.ops.registry.get_op(name)
    pa = op.parse_attrs(attrs)
    xs = [torch.from_numpy(np.array(x)) for x in inputs]
    for i in diff:
        xs[i].requires_grad_()
    pout = op.apply(pa, xs)[0]
    np.testing.assert_allclose(pout.detach().float().numpy(),
                               np.asarray(out, np.float32), rtol=0,
                               atol=1e-5)
    got = torch.autograd.grad(pout, [xs[i] for i in diff],
                              torch.from_numpy(g).to(pout.dtype))
    return [x.float().numpy() for x in got], want


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _cases():
    r = np.random.RandomState(0)
    ids = np.array([[1, 3, 3, 0], [7, 3, 1, 1]], np.float32)  # repeats
    img = _rand(r, 2, 3, 9, 9)
    return [
        ("FullyConnected", {"num_hidden": 5},
         [_rand(r, 3, 2, 4), _rand(r, 5, 8), _rand(r, 5)], [0, 1, 2]),
        ("FullyConnected", {"num_hidden": 6, "flatten": False},
         [_rand(r, 2, 3, 4), _rand(r, 6, 4), _rand(r, 6)], [0, 1, 2]),
        ("FullyConnected", {"num_hidden": 3, "no_bias": True},
         [_rand(r, 4, 5), _rand(r, 3, 5)], [0, 1]),
        ("LayerNorm", {}, [_rand(r, 2, 3, 8), _rand(r, 8), _rand(r, 8)],
         [0, 1, 2]),
        ("Embedding", {"input_dim": 9, "output_dim": 4},
         [ids, _rand(r, 9, 4)], [1]),
        ("Activation", {"act_type": "relu"}, [_rand(r, 4, 6)], [0]),
        ("Activation", {"act_type": "tanh"}, [_rand(r, 4, 6)], [0]),
        ("Activation", {"act_type": "sigmoid"}, [_rand(r, 4, 6)], [0]),
        ("Activation", {"act_type": "softrelu"}, [_rand(r, 4, 6)], [0]),
        ("Reshape", {"shape": (-1, 4)}, [_rand(r, 2, 3, 4)], [0]),
        ("transpose", {"axes": (0, 2, 1, 3)}, [_rand(r, 2, 3, 4, 5)], [0]),
        ("slice_axis", {"axis": 1, "begin": 1, "end": 3},
         [_rand(r, 2, 5, 3)], [0]),
        ("Cast", {"dtype": "float32"}, [_rand(r, 3, 4)], [0]),
        ("broadcast_add", {}, [_rand(r, 2, 3, 4), _rand(r, 1, 3, 4)],
         [0, 1]),
        ("elemwise_add", {}, [_rand(r, 3, 4), _rand(r, 3, 4)], [0, 1]),
        ("Flatten", {}, [_rand(r, 2, 3, 4)], [0]),
        ("Convolution", {"kernel": (3, 3), "num_filter": 4, "pad": (1, 1),
                         "stride": (2, 2)},
         [img, _rand(r, 4, 3, 3, 3), _rand(r, 4)], [0, 1, 2]),
        ("Convolution", {"kernel": (5, 5), "num_filter": 2},
         [img, _rand(r, 2, 3, 5, 5), _rand(r, 2)], [0, 1, 2]),
        ("Pooling", {"kernel": (2, 2), "stride": (2, 2), "pool_type": "max"},
         [img], [0]),
        ("Pooling", {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
                     "pool_type": "avg"}, [img], [0]),
        ("Pooling", {"kernel": (3, 3), "stride": (2, 2), "pool_type": "max",
                     "pooling_convention": "full"}, [img], [0]),
    ]


@pytest.mark.parametrize("case", range(len(_cases())),
                         ids=lambda i: "%d-%s" % (i, _cases()[i][0]))
def test_op_gradient_matches_mxtpu_vjp(tt, case):
    name, attrs, inputs, diff = _cases()[case]
    got, want = _grads(tt, name, attrs, inputs, diff, seed=case)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        np.testing.assert_allclose(a, w, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))


def _softmax_grads(tt, attrs, data, label):
    import jax
    import jax.numpy as jnp
    torch, mt = tt
    jop = jreg.get_op("SoftmaxOutput")
    ja = jop.parse_attrs(attrs)
    out, vjp = jax.vjp(lambda d: jop.fn(ja, d, jnp.asarray(label)),
                       jnp.asarray(data))
    g = np.random.RandomState(1).randn(*out.shape).astype(np.float32)
    (want,) = vjp(jnp.asarray(g))  # a loss head ignores g
    op = mt.ops.registry.get_op("SoftmaxOutput")
    x = torch.from_numpy(data).requires_grad_()
    p = op.apply(op.parse_attrs(attrs), [x, torch.from_numpy(label)])[0]
    (got,) = torch.autograd.grad(p, [x], torch.from_numpy(g))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("normalization", ["null", "batch", "valid"])
@pytest.mark.parametrize("use_ignore", [False, True])
def test_softmax_output_gradient_matches_mxtpu(tt, normalization,
                                               use_ignore):
    r = np.random.RandomState(2)
    data = _rand(r, 6, 5)
    label = np.array([0, 4, 2, 4, 1, 3], np.float32)
    attrs = {"normalization": normalization, "use_ignore": use_ignore,
             "ignore_label": 4, "grad_scale": 0.5}
    got, want = _softmax_grads(tt, attrs, data, label)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if use_ignore:
        assert np.abs(got[[1, 3]]).max() == 0.0  # ignored rows


def test_softmax_output_gradient_multi_output_and_dense_label(tt):
    r = np.random.RandomState(3)
    got, want = _softmax_grads(tt, {"multi_output": True},
                               _rand(r, 2, 4, 3),
                               np.array([[0, 3, 1], [2, 2, 0]], np.float32))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    dense = np.abs(_rand(r, 3, 4))
    got, want = _softmax_grads(tt, {}, _rand(r, 3, 4),
                               dense / dense.sum(1, keepdims=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_dropout_statistics_and_reproducibility(tt):
    torch, mt = tt
    op = mt.ops.registry.get_op("Dropout")
    x = torch.ones(400, 500)
    a = op.parse_attrs({"p": 0.3})
    assert op.apply(a, [x])[0] is x  # inference: the identity
    a = type(a)(a, __is_train__=True)
    mt.random.seed(7)
    y1 = op.apply(a, [x])[0]
    y2 = op.apply(a, [x])[0]
    mt.random.seed(7)
    y3 = op.apply(a, [x])[0]
    kept = float((y1 != 0).float().mean())
    assert abs(kept - 0.7) < 0.01  # 200k Bernoulli(0.7) draws: 5 sigma
    assert set(torch.unique(y1).tolist()) == {0.0, 1 / 0.7} or \
        torch.allclose(torch.unique(y1), torch.tensor([0.0, 1 / 0.7]))
    assert abs(float(y1.mean()) - 1.0) < 0.02  # inverted scaling
    assert torch.equal(y1, y3) and not torch.equal(y1, y2)
    state = mt.random.get_state()
    y4 = op.apply(a, [x])[0]
    mt.random.set_state(state)
    assert torch.equal(op.apply(a, [x])[0], y4)
    # the gradient is the mask, scaled
    xg = x.clone().requires_grad_()
    mt.random.seed(7)
    (g,) = torch.autograd.grad(op.apply(a, [xg])[0].sum(), [xg])
    assert torch.equal(g, y1)


def test_dropout_keep_rate_matches_mxtpu(tt):
    """mxtpu's Dropout keeps the same share with its own bits."""
    import jax
    import jax.numpy as jnp
    jop = jreg.get_op("Dropout")
    ja = jop.parse_attrs({"p": 0.3})
    ja = type(ja)(ja, __is_train__=True)
    y = jop.fn(ja, jax.random.PRNGKey(0), jnp.ones((400, 500)))
    assert abs(float((y != 0).mean()) - 0.7) < 0.01
