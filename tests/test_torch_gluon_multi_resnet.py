"""Gluon's narrow ResNetV2 over two contexts in mxtpu_torch vs mxtpu, on
the CPU.

The net is phase 8's one-step gate net (``ResNetV2(BasicBlockV2, [1, 1,
1], [16, 16, 32, 64], classes=10, thumbnail=True)``) at B=8, 16x16, on
[cpu(0), cpu(1)], from mxtpu's Xavier values: 2 SGD steps (lr 0.1,
momentum 0.9) with ``split_and_load``, SoftmaxCrossEntropyLoss under
``autograd.record()`` and ``Trainer(kvstore="device")``. Each context's
weights and moving statistics within 1e-4 of the largest of mxtpu's
imperative run (the tolerance of the 1-context test); the weights the
same bits on both contexts, the moving variances not (each context's
BatchNorm on its own rows, as in mxtpu's Gluon); the hybridized run bit
for bit the imperative one.
"""
import numpy as np
import pytest

import mxtpu as mx


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


B, SHAPE, CLASSES, LR = 8, (3, 16, 16), 10, 0.1


def _make(pkg):
    v = pkg.gluon.model_zoo.vision
    return v.ResNetV2(v.BasicBlockV2, [1, 1, 1], [16, 16, 32, 64],
                      classes=CLASSES, thumbnail=True)


def _stripped(net):
    return {k[len(net.prefix):]: v for k, v in net.collect_params().items()}


@pytest.fixture(scope="module")
def start():
    mx.random.seed(4)
    net = _make(mx)
    net.initialize(mx.initializer.Xavier(rnd_type="gaussian",
                                         factor_type="in", magnitude=2),
                   ctx=mx.cpu())
    net(mx.nd.ones((1,) + SHAPE))
    return {k: p.data().asnumpy() for k, p in _stripped(net).items()}


def _resnet_run(pkg, values, hybridize):
    rng = np.random.RandomState(11)
    x = rng.rand(2, B, *SHAPE).astype(np.float32)
    y = rng.randint(0, CLASSES, (2, B)).astype(np.float32)
    ctxs = [pkg.cpu(0), pkg.cpu(1)]
    net = _make(pkg)
    net.initialize(ctx=ctxs)
    with pkg.cpu():
        net(pkg.nd.ones((1,) + SHAPE))
    for k, p in _stripped(net).items():
        p.set_data(pkg.nd.array(values[k], ctx=pkg.cpu()))
    if hybridize:
        net.hybridize()
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": LR, "momentum": 0.9},
                                kvstore="device")
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    for i in range(2):
        xs = pkg.gluon.utils.split_and_load(
            pkg.nd.array(x[i], ctx=pkg.cpu()), ctxs)
        ys = pkg.gluon.utils.split_and_load(
            pkg.nd.array(y[i], ctx=pkg.cpu()), ctxs)
        with pkg.autograd.record():
            losses = [loss_fn(net(a), b) for a, b in zip(xs, ys)]
        pkg.autograd.backward(losses)
        trainer.step(B)
    return {k: [d.asnumpy().astype(np.float64) for d in p.list_data()]
            for k, p in _stripped(net).items()}


@pytest.fixture(scope="module")
def resnet_want(start):
    return _resnet_run(mx, start, False)


@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["imperative", "hybridized"])
def test_narrow_resnet_v2_over_two_contexts_matches_mxtpu(mt, start,
                                                          resnet_want,
                                                          hybridize):
    """mxtpu's hybridized block fails over several contexts (its cached
    op draws its random key on the first device and jit refuses the
    second device's input, a fault of the reference), so the port's
    hybridized run is held to mxtpu's imperative one, and to the port's
    imperative run bit for bit."""
    want = resnet_want
    with mt.cpu():
        got = _resnet_run(mt, start, hybridize)
        if hybridize:
            imperative = _resnet_run(mt, start, False)
            for k in got:
                for g, i in zip(got[k], imperative[k]):
                    np.testing.assert_array_equal(g, i, err_msg=k)
    assert sorted(got) == sorted(want)
    for k in want:
        for g, w in zip(got[k], want[k]):
            assert np.abs(g - w).max() / max(1.0, np.abs(w).max()) <= 1e-4, k
        if k.endswith("running_var"):  # each context's own rows
            assert not np.array_equal(*got[k]), k
        elif not k.endswith("running_mean"):
            np.testing.assert_array_equal(*got[k], err_msg=k)
