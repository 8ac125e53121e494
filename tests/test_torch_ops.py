"""mxtpu_torch ops vs mxtpu ops: the same numpy inputs through
``mxtpu.ops.registry.invoke`` (JAX on the CPU) and
``mxtpu_torch.ops.registry.invoke`` (PyTorch on the CPU), float32, with
atol = rtol = 1e-5; and the port's meta-tensor shape inference against
the JAX package's ``jax.eval_shape`` inference.

torch is imported inside the fixture (lazily) and pinned to one thread,
because several test workers share the host."""
import numpy as np
import pytest

import mxtpu  # noqa: F401  (registers the JAX ops)
from mxtpu.ops import registry as jreg

RTOL = ATOL = 1e-5


@pytest.fixture(scope="module")
def tt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return torch, mxtpu_torch


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# (op, [input arrays], attrs) — every op the transformer LM's serving
# path runs, across the attr values the graphs use and their neighbours
CASES = [
    ("Cast", [_rand((3, 5), 0)], {"dtype": "float32"}),
    ("Cast", [_rand((3, 5), 1)], {"dtype": "bfloat16"}),
    ("Cast", [_rand((3, 5), 2)], {"dtype": "float16"}),
    ("elemwise_add", [_rand((2, 3, 4), 3), _rand((2, 3, 4), 4)], {}),
    ("_plus", [_rand((4, 6), 5), _rand((4, 6), 6)], {}),
    ("broadcast_add", [_rand((2, 3, 4), 7), _rand((1, 3, 4), 8)], {}),
    ("broadcast_add", [_rand((2, 3, 4), 9), _rand((2, 1, 4), 10)], {}),
    ("Reshape", [_rand((2, 3, 4), 11)], {"shape": (-1, 4)}),
    ("Reshape", [_rand((2, 3, 4), 12)], {"shape": (0, -1)}),
    ("Reshape", [_rand((2, 3, 4), 13)], {"shape": (-3, 0)}),
    ("Reshape", [_rand((2, 3, 4), 14)], {"shape": (0, -4, 1, 3, 4)}),
    ("Reshape", [_rand((2, 3, 4), 15)], {"shape": (-2,)}),
    ("Reshape", [_rand((2, 3, 4), 16)], {"shape": (-1, 2, 2),
                                         "reverse": True}),
    ("reshape", [_rand((2, 12), 17)], {"shape": (-1, 4, 3, 2)}),
    ("transpose", [_rand((2, 3, 4, 5), 18)], {"axes": (0, 2, 1, 3)}),
    ("transpose", [_rand((2, 3, 4), 19)], {}),
    ("slice_axis", [_rand((1, 8, 4), 20)], {"axis": 1, "begin": 0,
                                             "end": 5}),
    ("slice_axis", [_rand((3, 8, 4), 21)], {"axis": -1, "begin": 1,
                                             "end": -1}),
    ("Embedding", [np.array([[0, 3, 7], [2, 2, 9]], np.float32),
                   _rand((10, 6), 22)], {"input_dim": 10, "output_dim": 6}),
    ("FullyConnected", [_rand((2, 5, 8), 23), _rand((6, 8), 24),
                        _rand((6,), 25)], {"num_hidden": 6,
                                           "flatten": False}),
    ("FullyConnected", [_rand((4, 2, 3), 26), _rand((5, 6), 27),
                        _rand((5,), 28)], {"num_hidden": 5}),
    ("FullyConnected", [_rand((4, 7), 29), _rand((3, 7), 30)],
     {"num_hidden": 3, "no_bias": True}),
    ("LayerNorm", [_rand((2, 5, 8), 31, 3.0) + 2.0, _rand((8,), 32),
                   _rand((8,), 33)], {}),
    ("LayerNorm", [_rand((3, 6, 2), 34), _rand((6,), 35),
                   _rand((6,), 36)], {"axis": 1, "eps": 1e-3}),
    ("LayerNorm", [_rand((4, 8), 37), _rand((8,), 38), _rand((8,), 39)],
     {"output_mean_var": True}),
    ("Activation", [_rand((3, 7), 40)], {"act_type": "relu"}),
    ("Activation", [_rand((3, 7), 41)], {"act_type": "sigmoid"}),
    ("Activation", [_rand((3, 7), 42)], {"act_type": "tanh"}),
    ("Activation", [_rand((3, 7), 43)], {"act_type": "softrelu"}),
    ("SoftmaxOutput", [_rand((6, 11), 44, 3.0), np.zeros((6,), np.float32)],
     {}),
    ("SoftmaxOutput", [_rand((2, 3, 4), 45), np.zeros((2,), np.float32)],
     {}),
    ("SoftmaxOutput", [_rand((2, 3, 4), 46), np.zeros((2,), np.float32)],
     {"preserve_shape": True}),
    ("SoftmaxOutput", [_rand((2, 3, 4), 47), np.zeros((2, 4), np.float32)],
     {"multi_output": True}),
    ("Dropout", [_rand((3, 4), 48)], {"p": 0.3}),
]
IDS = ["%s-%d" % (c[0], i) for i, c in enumerate(CASES)]


def _jax_invoke(name, arrays, attrs):
    """mxtpu's op on an empty per-op jit cache, put back afterwards.
    mxtpu keys that process-wide cache on hash(attrs) alone, and
    hash(-1) == hash(-2) (ROADMAP C): a Reshape to (-2,) here and one to
    (-1,) in another test of the same worker would run each other's
    program."""
    import jax
    import jax.numpy as jnp
    op = jreg.get_op(name)
    rng = jax.random.PRNGKey(0) if op.needs_rng else None
    saved, op._jit_cache = op._jit_cache, {}
    try:
        _, _, outs = jreg.invoke(name, [jnp.asarray(a) for a in arrays],
                                 dict(attrs), rng=rng)
    finally:
        op._jit_cache = saved
    return [np.asarray(o.astype(jnp.float32)) for o in outs]


@pytest.mark.parametrize("name,arrays,attrs", CASES, ids=IDS)
def test_op_matches_mxtpu(tt, name, arrays, attrs):
    torch, mt = tt
    _, _, outs = mt.ops.registry.invoke(
        name, [torch.from_numpy(a.copy()) for a in arrays], dict(attrs))
    want = _jax_invoke(name, arrays, attrs)
    assert len(outs) == len(want)
    for got, ref in zip(outs, want):
        got = got.to(torch.float32).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,arrays,attrs", CASES, ids=IDS)
def test_meta_shape_inference_matches_mxtpu(tt, name, arrays, attrs):
    torch, mt = tt
    op = mt.ops.registry.get_op(name)
    parsed = op.parse_attrs(dict(attrs))
    got = op.infer(parsed, [(a.shape, torch.float32) for a in arrays])
    jop = jreg.get_op(name)
    want = jop.infer(jop.parse_attrs(dict(attrs)),
                     [(a.shape, np.float32) for a in arrays])
    assert [s for s, _ in got] == [tuple(s) for s, _ in want]


def test_dropout_in_training_is_refused(tt):
    """Dropout in training is no longer refused: it draws a mask (kept
    values scaled by 1/(1-p)). Nor is BatchNorm (batch statistics; see
    test_torch_batchnorm_train.py). What training still refuses is the
    fused BatchNorm->ReLU step, which serves inference only."""
    torch, mt = tt
    from mxtpu_torch.ops.nn import bn_relu_inference
    _, _, (y,) = mt.ops.registry.invoke("Dropout", [torch.ones(64, 64)],
                                        {"p": 0.5, "__is_train__": True})
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    op = mt.ops.registry.get_op("BatchNorm")
    with pytest.raises(mt.MXNetError, match="training"):
        bn_relu_inference(op.parse_attrs({"__is_train__": True}),
                          torch.ones(2, 3), *[torch.ones(3)] * 4)


def test_required_attr_missing_raises(tt):
    torch, mt = tt
    with pytest.raises(mt.MXNetError, match="required attr"):
        mt.ops.registry.invoke("Embedding", [torch.zeros(1, 2),
                                             torch.zeros(4, 3)],
                               {"input_dim": 4})
