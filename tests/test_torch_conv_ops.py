"""The image zoo's ops in mxtpu_torch vs mxtpu: Convolution, Pooling,
BatchNorm (inference), Flatten and Concat. The same numpy inputs go
through ``mxtpu.ops.registry.invoke`` (JAX on the CPU) and
``mxtpu_torch.ops.registry.invoke`` (PyTorch on the CPU), float32, with
atol = rtol = 1e-5; the port's meta-tensor shape inference is held
against ``jax.eval_shape``. Also the executor's fused BN->ReLU step
(``bn_relu_inference``) against mxtpu's BatchNorm then ReLU, in f32 and
in bf16 (at the tolerance its test states).

Attr tuples avoid -1/-2: mxtpu keys its per-op jit cache on hash(attrs),
and hash(-1) == hash(-2) (ROADMAP C)."""
import json

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


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            + shift).astype(np.float32)


def _pos(shape, seed):
    return (np.random.RandomState(seed).rand(*shape) + 0.5).astype(
        np.float32)


def _conv(data, w, bias=None, **attrs):
    ins = [data, w] + ([bias] if bias is not None else [])
    attrs.setdefault("num_filter", w.shape[0])
    attrs.setdefault("no_bias", bias is None)
    return ("Convolution", ins, attrs)


def _bn(shape, axis, seed, **attrs):
    c = shape[axis]
    return ("BatchNorm", [_rand(shape, seed, 2.0, 0.5), _pos((c,), seed + 1),
                          _rand((c,), seed + 2), _rand((c,), seed + 3, 0.3),
                          _pos((c,), seed + 4)], dict(axis=axis, **attrs))


X = _rand((2, 4, 9, 11), 0)
CASES = [
    _conv(X, _rand((6, 4, 3, 3), 1), _rand((6,), 2), kernel=(3, 3)),
    _conv(X, _rand((6, 4, 3, 3), 3), _rand((6,), 4), kernel=(3, 3),
          stride=(2, 2), pad=(1, 1)),
    _conv(X, _rand((5, 4, 3, 2), 5), kernel=(3, 2), stride=(1, 2),
          pad=(2, 0), dilate=(2, 3)),
    _conv(X, _rand((6, 2, 3, 3), 6), _rand((6,), 7), kernel=(3, 3),
          pad=(1, 1), num_group=2),
    _conv(X, _rand((4, 1, 3, 3), 8), kernel=(3, 3), pad=(1, 1),
          stride=(2, 2), num_group=4),  # depthwise
    _conv(X, _rand((8, 4, 1, 1), 9), kernel=(1, 1)),
    _conv(_rand((2, 9, 11, 4), 10), _rand((6, 4, 3, 3), 11),
          _rand((6,), 12), kernel=(3, 3), pad=(1, 1), layout="NHWC"),
    _conv(_rand((2, 9, 11, 4), 13), _rand((4, 2, 3, 3), 14), kernel=(3, 3),
          stride=(2, 2), num_group=2, layout="NHWC"),
    _conv(_rand((2, 3, 17), 15), _rand((5, 3, 4), 16), _rand((5,), 17),
          kernel=(4,), stride=(3,), pad=(1,)),
    _conv(_rand((1, 2, 5, 6, 7), 18), _rand((3, 2, 2, 3, 3), 19),
          kernel=(2, 3, 3), pad=(0, 1, 1)),
    ("Pooling", [X], dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                          pool_type="max")),
    ("Pooling", [X], dict(kernel=(3, 3), stride=(2, 2), pool_type="max",
                          pooling_convention="full")),
    ("Pooling", [X], dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                          pool_type="avg")),
    ("Pooling", [X], dict(kernel=(3, 3), stride=(2, 2), pool_type="avg",
                          pooling_convention="full")),
    ("Pooling", [X], dict(kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                          pool_type="avg")),
    ("Pooling", [X], dict(kernel=(2, 3), stride=(2, 2), pad=(1, 1),
                          pool_type="sum", pooling_convention="full")),
    ("Pooling", [X], dict(kernel=(2, 2), stride=(2, 2), pool_type="sum")),
    ("Pooling", [X], dict(global_pool=True, kernel=(7, 7),
                          pool_type="avg")),
    ("Pooling", [X], dict(global_pool=True, pool_type="max")),
    ("Pooling", [_rand((2, 9, 11, 4), 20)],
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max",
          layout="NHWC")),
    ("Pooling", [_rand((2, 9, 11, 4), 21)],
     dict(kernel=(3, 3), stride=(2, 2), pool_type="avg",
          pooling_convention="full", layout="NHWC")),
    ("Pooling", [_rand((2, 3, 13), 22)], dict(kernel=(3,), stride=(2,),
                                              pool_type="max")),
    _bn((2, 4, 5, 3), 1, 30),
    _bn((2, 4, 5, 3), 1, 40, fix_gamma=False, eps=2e-5),
    _bn((2, 5, 3, 6), 3, 50),
    _bn((2, 5, 3, 6), 3, 60, fix_gamma=False),
    _bn((6, 7), 1, 70, fix_gamma=False),
    _bn((2, 4, 5, 3), 1, 80, fix_gamma=False, output_mean_var=True),
    _bn((2, 4, 5, 3), 1, 90, use_global_stats=True, momentum=0.5),
    ("Flatten", [X], {}),
    ("Flatten", [_rand((3, 2, 2, 2, 2), 23)], {}),
    ("Concat", [X, _rand((2, 3, 9, 11), 24), _rand((2, 1, 9, 11), 25)],
     dict(num_args=3, dim=1)),
    ("Concat", [_rand((2, 3), 26), _rand((4, 3), 27)],
     dict(num_args=2, dim=0)),
]
IDS = ["%s-%d" % (c[0], i) for i, c in enumerate(CASES)]


def _jax_invoke(name, arrays, attrs):
    """Every output of mxtpu's invoke: BatchNorm's visible outputs are
    followed by its aux values, as the port's are."""
    import jax.numpy as jnp
    _, _, outs = jreg.invoke(name, [jnp.asarray(a) for a in arrays],
                             dict(attrs))
    return [np.asarray(o) for o in outs]


@pytest.mark.parametrize("name,arrays,attrs", CASES, ids=IDS)
def test_op_matches_mxtpu(tt, name, arrays, attrs):
    torch, mt = tt
    _, _, outs = mt.ops.registry.invoke(
        name, [torch.from_numpy(a.copy()) for a in arrays], dict(attrs))
    want = _jax_invoke(name, arrays, attrs)
    assert len(outs) == len(want)
    for got, ref in zip(outs, want):
        assert tuple(got.shape) == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,arrays,attrs", CASES, ids=IDS)
def test_meta_shape_inference_matches_mxtpu(tt, name, arrays, attrs):
    torch, mt = tt
    op = mt.ops.registry.get_op(name)
    got = op.infer(op.parse_attrs(dict(attrs)),
                   [(a.shape, torch.float32) for a in arrays])
    jop = jreg.get_op(name)
    jattrs = jop.parse_attrs(dict(attrs))
    want = jop.infer(jattrs, [(a.shape, np.float32) for a in arrays])
    want = want[:jop.n_out(jattrs)]
    assert [s for s, _ in got] == [tuple(s) for s, _ in want]


@pytest.mark.parametrize("name,arrays,attrs",
                         [c for c in CASES if c[0] in ("Convolution",
                                                       "BatchNorm")],
                         ids=[i for i, c in zip(IDS, CASES)
                              if c[0] in ("Convolution", "BatchNorm")])
def test_arg_shape_rule_matches_mxtpu(tt, name, arrays, attrs):
    """Weight / gamma / moving-stat shapes filled from the data shape."""
    _, mt = tt
    op = mt.ops.registry.get_op(name)
    jop = jreg.get_op(name)
    shapes = [arrays[0].shape] + [None] * (len(arrays) - 1)
    got = op.infer_args(op.parse_attrs(dict(attrs)), shapes)
    want = jop.infer_args(jop.parse_attrs(dict(attrs)), shapes)
    assert [tuple(s) for s in got] == [tuple(s) for s in want]
    assert [tuple(s) for s in got] == [a.shape for a in arrays]


BN_RELU = [((2, 4, 5, 3), 1, True), ((2, 4, 5, 3), 1, False),
           ((2, 5, 3, 6), 3, False), ((6, 7), 1, False)]


def _fused_and_bn_then_relu(tt, shape, axis, fix_gamma, bf16):
    """The port's fused step and mxtpu's BatchNorm then ReLU on the same
    inputs (data and parameters all in bf16 when ``bf16``), as f32
    numpy."""
    import jax.numpy as jnp
    torch, mt = tt
    from mxtpu_torch.ops.nn import bn_relu_inference
    _, arrays, attrs = _bn(shape, axis, 100 + axis, fix_gamma=fix_gamma,
                           eps=2e-5)
    if bf16:
        # round once, so both packages see the same bf16 values
        arrays = [np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                             .astype(jnp.float32)) for a in arrays]
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if bf16 else \
        (torch.float32, jnp.float32)
    _, _, outs = jreg.invoke("BatchNorm", [jnp.asarray(a).astype(jdt)
                                           for a in arrays], dict(attrs))
    _, _, outs = jreg.invoke("Activation", [outs[0]], {"act_type": "relu"})
    want = np.asarray(outs[0].astype(jnp.float32))
    got = bn_relu_inference(
        mt.ops.registry.get_op("BatchNorm").parse_attrs(attrs),
        *[torch.from_numpy(a.copy()).to(tdt) for a in arrays])
    assert got.dtype == tdt and outs[0].dtype == jdt
    return got.float().numpy(), want


@pytest.mark.parametrize("shape,axis,fix_gamma", BN_RELU)
def test_fused_bn_relu_matches_mxtpu_bn_then_relu(tt, shape, axis,
                                                  fix_gamma):
    got, want = _fused_and_bn_then_relu(tt, shape, axis, fix_gamma, False)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape,axis,fix_gamma", BN_RELU)
def test_fused_bn_relu_matches_mxtpu_bn_then_relu_in_bf16(tt, shape, axis,
                                                          fix_gamma):
    """In bf16 the fused step folds in f32 and rounds once, while mxtpu's
    BatchNorm rounds inv, x - mean, the product and the sum each to bf16.
    The outputs here reach |y| ~ 10, where one bf16 step is 2**-4; the two
    differ by at most that step (atol 2**-4, rtol 2**-6)."""
    got, want = _fused_and_bn_then_relu(tt, shape, axis, fix_gamma, True)
    np.testing.assert_allclose(got, want, rtol=2 ** -6, atol=2 ** -4)


def test_fused_bn_relu_takes_a_permuted_view_without_a_copy(tt):
    """An NHWC result viewed from NCHW memory (what a channels-last conv
    hands over) runs on its dense storage and comes back as the view."""
    torch, mt = tt
    from mxtpu_torch.ops.nn import bn_relu_inference
    _, arrays, attrs = _bn((2, 5, 3, 6), 3, 7, fix_gamma=False)
    nhwc = torch.from_numpy(arrays[0].copy())
    view = nhwc.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert not view.is_contiguous()
    op = mt.ops.registry.get_op("BatchNorm")
    a = op.parse_attrs(attrs)
    rest = [torch.from_numpy(x.copy()) for x in arrays[1:]]
    got = bn_relu_inference(a, view, *rest)
    assert got.shape == view.shape and got.stride() == view.stride()
    assert torch.equal(got, bn_relu_inference(a, nhwc, *rest))


def test_concat_composes_num_args_like_mxtpu(tt):
    """Symbol composition fills num_args, as MXNet does."""
    import mxtpu as mx
    _, mt = tt
    parts = ["a", "b", "c"]
    tsym = mt.sym.Concat(*[mt.sym.Variable(p) for p in parts], dim=1,
                         name="cat")
    jsym = mx.sym.Concat(*[mx.sym.Variable(p) for p in parts], dim=1,
                         name="cat")
    assert json.loads(tsym.tojson())["nodes"] == \
        json.loads(jsym.tojson())["nodes"]
    shapes = dict(a=(1, 2, 3), b=(1, 4, 3), c=(1, 1, 3))
    assert tsym.infer_shape(**shapes)[1] == [(1, 7, 3)]
