"""Gluon's narrow ResNets trained through the port's autograd and Trainer,
against mxtpu's Gluon and a float64 run, on the CPU.

The nets are the model zoo's classes at the size of phase 8's one-step
gate, cut to B=8 at 16x16: ``ResNetV2(BasicBlockV2, [1, 1, 1], [16, 16,
32, 64], classes=10, thumbnail=True)`` and the same ``ResNetV1``. mxtpu's
net is initialized (Xavier) and its values loaded into the port's by
their names without the block prefix. Then two SGD steps (lr 0.1,
momentum 0.9, ``trainer.step(B)``) of SoftmaxCrossEntropyLoss under
``autograd.record()``, imperative and hybridized:

- the port's losses, weights and moving statistics within 1e-4 of the
  largest value of mxtpu's (mxtpu's f32 BatchNorm gradient on XLA:CPU is
  a few percent off at narrow nets, ROADMAP C, so the first step is also
  held to the exact one: the port's f32 weights within 1e-6 of a float64
  run of the same step, started from the same values);
- the port's two paths (imperative and hybridized) bit for bit;
- the hybridized evaluation forward fuses exactly the graph's
  BatchNorm->ReLU pairs (counted on the Symbol the net traces to) and
  agrees with the imperative evaluation forward and with mxtpu's within
  1e-5 of the largest.

torch is imported lazily and pinned to one thread: several test workers
share the host."""
import numpy as np
import pytest

import mxtpu

B, SHAPE, CLASSES, LR = 8, (3, 16, 16), 10, 0.1


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


def _make(pkg, version):
    v = pkg.gluon.model_zoo.vision
    if version == 2:
        return v.ResNetV2(v.BasicBlockV2, [1, 1, 1], [16, 16, 32, 64],
                          classes=CLASSES, thumbnail=True)
    return v.ResNetV1(v.BasicBlockV1, [1, 1, 1], [16, 16, 32, 64],
                      classes=CLASSES, thumbnail=True)


def _data():
    rng = np.random.RandomState(11)
    x = rng.rand(2, B, *SHAPE).astype(np.float32)
    y = rng.randint(0, CLASSES, (2, B)).astype(np.float32)
    return x, y


def stripped(net):
    return {k[len(net.prefix):]: v for k, v in net.collect_params().items()}


@pytest.fixture(scope="module", params=[2, 1], ids=["v2", "v1"])
def start(request):
    """(version, mxtpu's initialized values by stripped name)."""
    mxtpu.random.seed(4)
    net = _make(mxtpu, request.param)
    net.initialize(mxtpu.initializer.Xavier(rnd_type="gaussian",
                                            factor_type="in", magnitude=2),
                   ctx=mxtpu.cpu())
    net(mxtpu.nd.ones((1,) + SHAPE))
    return request.param, {k: p.data().asnumpy()
                           for k, p in stripped(net).items()}


def _train(pkg, version, values, hybridize, dtype="float32", steps=2):
    """``steps`` SGD steps from ``values``: (losses, {name: value})."""
    x, y = _data()

    def run():
        net = _make(pkg, version)
        if pkg is mxtpu:
            net.initialize(ctx=mxtpu.cpu())
            net(mxtpu.nd.ones((1,) + SHAPE))
            for k, p in stripped(net).items():
                p.set_data(mxtpu.nd.array(values[k]))
        else:
            pkg.convert.gluon_params_from_mxtpu(values, pkg.cpu(),
                                                block=net)
            if dtype != "float32":
                net.cast(dtype)
        if hybridize:
            net.hybridize()
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": LR, "momentum": 0.9})
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        losses = []
        for i in range(steps):
            data = pkg.nd.array(x[i], dtype=dtype)
            label = pkg.nd.array(y[i], dtype=dtype)
            with pkg.autograd.record():
                loss = loss_fn(net(data), label)
            loss.backward()
            trainer.step(B)
            losses.append(float(loss.mean().asscalar()))
        return losses, {k: p.data().asnumpy().astype(np.float64)
                        for k, p in stripped(net).items()}

    if pkg is mxtpu:
        return run()
    with pkg.cpu():
        return run()


def _dist(a, b):
    return max(float(np.abs(a[k] - b[k]).max()) /
               max(1.0, float(np.abs(b[k]).max())) for k in b)


@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["imperative", "hybridized"])
def test_two_sgd_steps_match_mxtpu(mt, start, hybridize):
    version, values = start
    want_loss, want = _train(mxtpu, version, values, hybridize)
    got_loss, got = _train(mt, version, values, hybridize)
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)
    assert _dist(got, want) <= 1e-4, _dist(got, want)


def test_imperative_and_hybridized_steps_are_bit_identical(mt, start):
    version, values = start
    a = _train(mt, version, values, False)
    b = _train(mt, version, values, True)
    assert a[0] == b[0]
    for k in a[1]:
        np.testing.assert_array_equal(a[1][k], b[1][k], err_msg=k)


def test_first_step_is_the_exact_step(mt, start):
    """One step of the port in f32 against the same step in float64: the
    weights within 1e-6 of the largest (mxtpu's own f32 step is farther
    off at its BatchNorm gradients, ROADMAP C)."""
    version, values = start
    _, f32 = _train(mt, version, values, True, steps=1)
    _, f64 = _train(mt, version, values, True, dtype="float64", steps=1)
    assert _dist(f32, f64) <= 1e-6, _dist(f32, f64)


def _bn_relu_pairs(sym):
    """BatchNorm nodes whose one consumer is Activation(relu) and that
    are not a graph output: the pairs the inference plan may fuse."""
    topo = sym._topo()
    users = {}
    for node in topo:
        for n, _ in node.inputs:
            users.setdefault(id(n), []).append(node)
    outs = {id(n) for n, _ in sym._outputs}
    count = 0
    for node in topo:
        if node.is_variable or node.op.name != "BatchNorm":
            continue
        u = users.get(id(node), [])
        if id(node) not in outs and len(u) == 1 and \
                u[0].op.name == "Activation" and \
                u[0].parsed_attrs().act_type == "relu":
            count += 1
    return count


def test_hybridized_eval_forward_fuses_every_pair(mt, start):
    version, values = start
    x = _data()[0][0]
    jnet = _make(mxtpu, version)
    jnet.initialize(ctx=mxtpu.cpu())
    jnet(mxtpu.nd.ones((1,) + SHAPE))
    for k, p in stripped(jnet).items():
        p.set_data(mxtpu.nd.array(values[k]))
    want = jnet(mxtpu.nd.array(x)).asnumpy()
    with mt.cpu():
        net = _make(mt, version)
        mt.convert.gluon_params_from_mxtpu(values, mt.cpu(), block=net)
        plain = net(mt.nd.array(x)).asnumpy()
        pairs = _bn_relu_pairs(net(mt.sym.var("data")))
        net.hybridize()
        fused = net(mt.nd.array(x)).asnumpy()
    assert pairs == {2: 7, 1: 3}[version]
    assert net.fused_sites == pairs
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(fused - plain).max()) <= 1e-5 * scale
    assert float(np.abs(fused - want).max()) <= 1e-5 * scale
