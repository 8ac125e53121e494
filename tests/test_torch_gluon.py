"""mxtpu_torch.gluon against mxtpu.gluon, on the CPU.

- Every ported layer (Dense, Activation, BatchNorm, LayerNorm, LeakyReLU,
  Embedding, Flatten, Conv1D/2D/3D, the max, average and global pooling
  layers in 1-3 dimensions, HybridSequential, Lambda/HybridLambda), built
  alike in both packages, the port's parameters loaded from mxtpu's
  initialized ones by their names without the block prefix
  (``convert.gluon_params_from_mxtpu``); then one recorded forward and
  backward of ``0.5 * sum(y * y)`` in training mode, imperative and
  hybridized. Outputs within 1e-5 and gradients (of the input and of
  every parameter) within 1e-4 of the largest value of mxtpu's; the
  moving statistics BatchNorm writes back within 1e-5.
- Hybridized and imperative agree (the port's own two paths) within
  1e-5; BatchNorm's running statistics move in training and not at
  inference.
- Every ported loss (all of mxtpu's; CTCLoss in test_torch_ctc.py) with and
  without a sample weight, imperative and hybridized (MaxMargin:
  imperative, as in mxtpu), value and gradient of the prediction within
  1e-5 and 1e-4 of the largest.
- The Trainer's fused sweep against the Updater (bit for bit) and against
  mxtpu's Trainer (1e-4), SGD with momentum and Adam, ``.states`` files
  crossing from the sweep to the Updater; ``save_params`` files from
  mxtpu loaded by the port and back, bit for bit.
- ``split_and_load``, ``DataLoader`` (workers 0 and 2, shuffle,
  last_batch), and the twins of tests/test_gluon.py's cases.

torch is imported lazily and pinned to one thread: several test workers
share the host."""
import numpy as np
import pytest

import mxtpu

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


def _r(shape, seed, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            + shift).astype(np.float32)


def _close(got, want, tol, what=""):
    """Elementwise within ``tol`` of the largest value of ``want`` (at
    least 1)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, "%s: %g > %g" % (what, err, tol * scale)


def stripped(net):
    return {k[len(net.prefix):]: v for k, v in net.collect_params().items()}


def _with_ctx(pkg, fn):
    if pkg is mxtpu:
        return fn()
    with pkg.cpu():
        return fn()


def _mirror(mt, make, xs):
    """(mxtpu net, port net) built by ``make(pkg)``: mxtpu's initialized
    by its default initializer and a predict-mode forward (deferred
    shapes), the port's loaded from mxtpu's values."""
    jnet = make(mxtpu)
    jnet.initialize(ctx=mxtpu.cpu())
    jnet(*[mxtpu.nd.array(x) for x in xs])
    pnet = make(mt)
    mt.convert.gluon_params_from_mxtpu(
        {k: p.data().asnumpy() for k, p in stripped(jnet).items()},
        mt.cpu(), block=pnet)
    return jnet, pnet


def _train_step(pkg, net, xs, hybridize, input_grad=True, train=True):
    """One recorded forward of ``net`` and the backward of 0.5*sum(y*y):
    (y, the inputs' gradients, {param: gradient}, {param: value})."""
    def run():
        arrays = [pkg.nd.array(x) for x in xs]
        if input_grad:
            for a in arrays:
                a.attach_grad()
        if hybridize:
            net.hybridize()
        with pkg.autograd.record(train_mode=train):
            y = net(*arrays)
            loss = (y * y).sum() * 0.5
        loss.backward()
        ps = stripped(net)
        return (y.asnumpy(),
                [a.grad.asnumpy() for a in arrays] if input_grad else [],
                {k: p.grad().asnumpy() for k, p in ps.items()
                 if p.grad_req != "null"},
                {k: p.data().asnumpy() for k, p in ps.items()})
    return _with_ctx(pkg, run)


def _seq(pkg, *layers):
    def build():
        net = pkg.gluon.nn.HybridSequential()
        with net.name_scope():
            for make in layers:
                net.add(make(pkg.gluon.nn))
        return net
    return build


LAYERS = [
    ("dense", lambda nn: nn.Dense(5), [(3, 4)]),
    ("dense_nobias", lambda nn: nn.Dense(5, use_bias=False, in_units=4),
     [(3, 4)]),
    ("dense_noflatten", lambda nn: nn.Dense(6, flatten=False), [(2, 3, 4)]),
    ("dense_tanh", lambda nn: nn.Dense(4, activation="tanh"), [(2, 3, 2)]),
    ("relu", lambda nn: nn.Activation("relu"), [(3, 5)]),
    ("sigmoid", lambda nn: nn.Activation("sigmoid"), [(3, 5)]),
    ("tanh", lambda nn: nn.Activation("tanh"), [(3, 5)]),
    ("softrelu", lambda nn: nn.Activation("softrelu"), [(3, 5)]),
    ("batchnorm", lambda nn: nn.BatchNorm(), [(4, 3, 5, 5)]),
    ("batchnorm_fixed", lambda nn: nn.BatchNorm(scale=False, center=False),
     [(4, 3, 5, 5)]),
    ("batchnorm_2d", lambda nn: nn.BatchNorm(momentum=0.8),
     [(6, 4)]),
    ("layernorm", lambda nn: nn.LayerNorm(), [(2, 3, 6)]),
    ("leakyrelu", lambda nn: nn.LeakyReLU(0.1), [(3, 5)]),
    ("flatten", lambda nn: nn.Flatten(), [(2, 3, 4)]),
    ("conv1d", lambda nn: nn.Conv1D(4, 3), [(2, 3, 9)]),
    ("conv2d", lambda nn: nn.Conv2D(4, 3, strides=2, padding=1),
     [(2, 3, 9, 9)]),
    ("conv2d_dilated", lambda nn: nn.Conv2D(4, (3, 2), dilation=2,
                                            use_bias=False), [(2, 3, 9, 9)]),
    ("conv2d_groups", lambda nn: nn.Conv2D(6, 3, groups=3, in_channels=3,
                                           activation="relu"),
     [(2, 3, 7, 7)]),
    ("conv3d", lambda nn: nn.Conv3D(2, 2), [(1, 2, 5, 5, 5)]),
    ("maxpool1d", lambda nn: nn.MaxPool1D(2), [(2, 3, 8)]),
    ("maxpool2d", lambda nn: nn.MaxPool2D(3, 2, 1), [(2, 3, 9, 9)]),
    ("maxpool3d", lambda nn: nn.MaxPool3D(2), [(1, 2, 4, 4, 4)]),
    ("avgpool1d", lambda nn: nn.AvgPool1D(3, 2), [(2, 3, 9)]),
    ("avgpool2d", lambda nn: nn.AvgPool2D(2), [(2, 3, 8, 8)]),
    ("avgpool2d_ceil", lambda nn: nn.AvgPool2D(3, 2, 1, ceil_mode=True),
     [(2, 3, 8, 8)]),
    ("avgpool3d", lambda nn: nn.AvgPool3D(2), [(1, 2, 4, 4, 4)]),
    ("globalmax1d", lambda nn: nn.GlobalMaxPool1D(), [(2, 3, 7)]),
    ("globalmax2d", lambda nn: nn.GlobalMaxPool2D(), [(2, 3, 5, 5)]),
    ("globalmax3d", lambda nn: nn.GlobalMaxPool3D(), [(1, 2, 3, 3, 3)]),
    ("globalavg1d", lambda nn: nn.GlobalAvgPool1D(), [(2, 3, 7)]),
    ("globalavg2d", lambda nn: nn.GlobalAvgPool2D(), [(2, 3, 5, 5)]),
    ("globalavg3d", lambda nn: nn.GlobalAvgPool3D(), [(1, 2, 3, 3, 3)]),
    ("hybridlambda", lambda nn: nn.HybridLambda("relu"), [(3, 4)]),
    ("hybridlambda_fn", lambda nn: nn.HybridLambda(
        lambda F, x: F.LeakyReLU(x, slope=0.2)), [(3, 4)]),
]


def _layer_case(name, make, shapes):
    def build(pkg):
        return _seq(pkg, make)()
    return pytest.param(build, shapes, id=name)


CONVNET = ("convnet", lambda pkg: _seq(
    pkg, lambda nn: nn.Conv2D(4, 3, padding=1), lambda nn: nn.BatchNorm(),
    lambda nn: nn.Activation("relu"), lambda nn: nn.MaxPool2D(2, 2),
    lambda nn: nn.Flatten(), lambda nn: nn.Dense(3))(), [(4, 3, 8, 8)])


@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["imperative", "hybridized"])
@pytest.mark.parametrize(
    "make,shapes",
    [_layer_case(*c) for c in LAYERS] +
    [pytest.param(CONVNET[1], CONVNET[2], id=CONVNET[0])])
def test_layer_forward_and_gradient_match_mxtpu(mt, make, shapes,
                                                hybridize):
    xs = [_r(s, i + 1, shift=0.3) for i, s in enumerate(shapes)]
    jnet, pnet = _mirror(mt, make, xs)
    want = _train_step(mxtpu, jnet, xs, hybridize)
    got = _train_step(mt, pnet, xs, hybridize)
    _close(got[0], want[0], FWD_TOL, "output")
    for g, w in zip(got[1], want[1]):
        _close(g, w, GRAD_TOL, "input gradient")
    assert sorted(got[2]) == sorted(want[2])
    for k in want[2]:
        _close(got[2][k], want[2][k], GRAD_TOL, "gradient of " + k)
    for k in want[3]:  # BatchNorm's moving statistics, written back
        _close(got[3][k], want[3][k], FWD_TOL, "value of " + k)


def test_embedding_gradient_matches_mxtpu(mt):
    ids = np.array([[1, 3, 3], [9, 0, 3]], np.float32)  # repeated rows

    def build(pkg):
        return _seq(pkg, lambda nn: nn.Embedding(10, 4))()

    jnet, pnet = _mirror(mt, build, [ids])
    for hyb in (False, True):
        want = _train_step(mxtpu, jnet, [ids], hyb, input_grad=False)
        got = _train_step(mt, pnet, [ids], hyb, input_grad=False)
        _close(got[0], want[0], FWD_TOL, "output")
        for k in want[2]:
            _close(got[2][k], want[2][k], GRAD_TOL, k)


def test_dropout_in_training_and_at_inference(mt):
    """Dropout's mask is torch's generator's, not threefry's: at
    inference the identity in both packages, in training the same keep
    rate and scale."""
    x = np.ones((64, 64), np.float32)
    with mt.cpu():
        net = mt.gluon.nn.Dropout(0.25)
        for hyb in (False, True):
            net.hybridize(hyb)
            np.testing.assert_array_equal(net(mt.nd.array(x)).asnumpy(), x)
            with mt.autograd.record():
                y = net(mt.nd.array(x)).asnumpy()
            assert set(np.unique(y)) == {0.0, np.float32(1 / 0.75)}
            assert 0.2 < (y == 0).mean() < 0.3


def test_hybridized_equals_imperative_and_stats_move_in_training(mt):
    with mt.cpu():
        np.random.seed(3)
        net = _seq(mt, lambda nn: nn.Conv2D(4, 3, padding=1),
                   lambda nn: nn.BatchNorm(), lambda nn: nn.Activation("relu"),
                   lambda nn: nn.GlobalAvgPool2D(), lambda nn: nn.Dense(3))()
        net.initialize(mt.init.Xavier(), ctx=mt.cpu())
        x = mt.nd.array(_r((4, 3, 6, 6), 5, 3.0, 1.0))
        a = net(x).asnumpy()
        net.hybridize()
        b = net(x).asnumpy()
        _close(b, a, FWD_TOL, "hybridized vs imperative")
        bn = net[1]
        rm0 = bn.running_mean.data().asnumpy().copy()
        with mt.autograd.record():
            net(x)
        rm1 = bn.running_mean.data().asnumpy()
        assert not np.allclose(rm0, rm1)
        net(x)  # inference: no update
        np.testing.assert_array_equal(bn.running_mean.data().asnumpy(), rm1)
        # the hybridized inference plan fuses the one BatchNorm->ReLU pair
        assert net.fused_sites == 1


LOSSES = [
    ("L2Loss", {}, "dense"), ("L1Loss", {}, "dense"),
    ("SigmoidBinaryCrossEntropyLoss", {}, "binary"),
    ("SigmoidBinaryCrossEntropyLoss", {"from_sigmoid": True}, "prob"),
    ("SoftmaxCrossEntropyLoss", {}, "sparse"),
    ("SoftmaxCrossEntropyLoss", {"sparse_label": False}, "dist"),
    ("SoftmaxCrossEntropyLoss", {"from_logits": True}, "sparse_logp"),
    ("KLDivLoss", {}, "dist_logp"),
    ("KLDivLoss", {"from_logits": False}, "dist"),
    ("HuberLoss", {"rho": 0.5}, "dense"), ("HingeLoss", {}, "signed"),
    ("SquaredHingeLoss", {}, "signed"), ("LogisticLoss", {}, "signed"),
    ("LogisticLoss", {"label_format": "binary"}, "binary"),
    ("TripletLoss", {"margin": 0.5}, "triplet"),
    ("Huber", {"rho": 0.7}, "dense"),
    ("EpsilonInsensitive", {"epsilon": 0.2}, "dense"),
    ("SoftMargin", {}, "signed"), ("SquaredSoftMargin", {}, "signed"),
    ("Exponential", {}, "signed"), ("Logistic", {}, "signed"),
    ("Quantile", {"tau": 0.3}, "dense"), ("Langford", {}, "signed"),
    ("DualKL", {}, "signed"), ("RelativeNovelty", {"rho": 0.2}, "signed"),
    ("LogCosh", {}, "dense"), ("Poisson", {}, "positive"),
    ("MaxMargin", {}, "sparse")]


def _loss_inputs(kind):
    rng = np.random.RandomState(len(kind))
    pred = rng.randn(6, 5).astype(np.float32)
    if kind == "dense":
        return [pred, rng.randn(6, 5).astype(np.float32)]
    if kind == "binary":
        return [pred, rng.randint(0, 2, (6, 5)).astype(np.float32)]
    if kind == "prob":
        return [1 / (1 + np.exp(-pred)),
                rng.randint(0, 2, (6, 5)).astype(np.float32)]
    if kind in ("sparse", "sparse_logp"):
        if kind == "sparse_logp":
            pred = pred - np.log(np.exp(pred).sum(1, keepdims=True))
        return [pred, rng.randint(0, 5, 6).astype(np.float32)]
    if kind in ("dist", "dist_logp"):
        lab = np.exp(rng.randn(6, 5))
        lab = (lab / lab.sum(1, keepdims=True)).astype(np.float32)
        if kind == "dist_logp":
            pred = pred - np.log(np.exp(pred).sum(1, keepdims=True))
        return [pred.astype(np.float32), lab]
    if kind == "signed":
        return [pred, rng.choice([-1.0, 1.0], (6, 5)).astype(np.float32)]
    if kind == "positive":
        return [pred, np.abs(rng.randn(6, 5)).astype(np.float32)]
    if kind == "triplet":
        return [pred, rng.randn(6, 5).astype(np.float32),
                rng.randn(6, 5).astype(np.float32)]
    raise ValueError(kind)


def _loss_run(pkg, name, kw, arrays, weight, hybridize):
    def run():
        loss_fn = getattr(pkg.gluon.loss, name)(**kw)
        if hybridize:
            loss_fn.hybridize()
        nds = [pkg.nd.array(a) for a in arrays]
        nds[0].attach_grad()
        extra = [pkg.nd.array(weight)] if weight is not None else []
        with pkg.autograd.record():
            out = loss_fn(*(nds + extra))
            total = out.sum()
        total.backward()
        return out.asnumpy(), nds[0].grad.asnumpy()
    return _with_ctx(pkg, run)


def _loss_params():
    """Every loss, imperative and hybridized, with and without a sample
    weight, but TripletLoss takes no weight and MaxMargin hybridizes only
    with an explicit delta (as in mxtpu)."""
    out = []
    for i, (name, kw, kind) in enumerate(LOSSES):
        for hyb in (False, True):
            for weighted in (False, True):
                if (name == "TripletLoss" and weighted) or \
                        (name == "MaxMargin" and hyb):
                    continue
                out.append(pytest.param(
                    name, kw, kind, hyb, weighted, id="%s-%d-%s-%s" % (
                        name, i, "hybridized" if hyb else "imperative",
                        "sample_weight" if weighted else "plain")))
    return out


@pytest.mark.parametrize("name,kw,kind,hybridize,weighted", _loss_params())
def test_loss_matches_mxtpu(mt, name, kw, kind, hybridize, weighted):
    arrays = _loss_inputs(kind)
    weight = np.random.RandomState(7).rand(6, 1).astype(np.float32) \
        if weighted else None
    want = _loss_run(mxtpu, name, kw, arrays, weight, hybridize)
    got = _loss_run(mt, name, kw, arrays, weight, hybridize)
    _close(got[0], want[0], FWD_TOL, "loss")
    _close(got[1], want[1], GRAD_TOL, "gradient")


def test_ctc_loss_and_transposed_convolutions_raise(mt):
    """CTCLoss builds now (its op came with A.7; ``test_torch_ctc.py``
    holds it to mxtpu's) and raises only on a layout mxtpu refuses; the
    transposed convolutions and the rest of the zoo are ported and
    build."""
    for layout, label_layout in (("NTC", "NT"), ("TNC", "TN")):
        loss = mt.gluon.loss.CTCLoss(layout, label_layout)
        assert loss._batch_axis == label_layout.find("N")
    with pytest.raises(mt.MXNetError, match="CTCLoss"):
        mt.gluon.loss.CTCLoss("NCT")
    for cls in ("Conv1DTranspose", "Conv2DTranspose", "Conv3DTranspose"):
        layer = getattr(mt.gluon.nn, cls)(4, 3)
        assert layer._op_name == "Deconvolution"
    assert issubclass(mt.gluon.rnn.LSTM, mt.gluon.Block)  # ported now
    assert isinstance(mt.gluon.model_zoo.vision.get_model("alexnet"),
                      mt.gluon.model_zoo.vision.AlexNet)
    with pytest.raises(mt.MXNetError, match="pretrained"):
        mt.gluon.model_zoo.vision.resnet18_v1(pretrained=True)
    with pytest.raises(mt.MXNetError, match="fetches nothing"):
        mt.gluon.utils.download("http://localhost/x.params")


def _mlp(pkg):
    net = pkg.gluon.nn.Sequential()
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(16, activation="relu"))
        net.add(pkg.gluon.nn.Dense(4))
    return net


def _trainer_run(pkg, start, optimizer, params, fused=True, states_out=None,
                 states_in=None, steps=5):
    """``steps`` Trainer steps of the mlp from ``start`` (stripped names);
    returns {name: weight}. ``fused=False`` sends the port's Trainer down
    its Updater path, the one an optimizer without a fused rule takes."""

    def run():
        net = _mlp(pkg)
        net.initialize()
        rng = np.random.RandomState(0)
        X = pkg.nd.array(rng.randn(32, 8).astype("float32"))
        y = pkg.nd.array(rng.randint(0, 4, 32).astype("float32"))
        net(X)
        for k, p in stripped(net).items():
            p.set_data(pkg.nd.array(start[k]))
        trainer = pkg.gluon.Trainer(net.collect_params(), optimizer,
                                    dict(params))
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        for i in range(steps):
            with pkg.autograd.record():
                loss = loss_fn(net(X), y)
            loss.backward()
            trainer.step(32)
            if i == 1 and states_in:
                trainer.load_states(states_in)
        if states_out:
            trainer.save_states(states_out)
        return {k: p.data().asnumpy() for k, p in stripped(net).items()}
    if fused:
        return _with_ctx(pkg, run)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(pkg.gluon.Trainer, "_fused_sweep_ok", lambda self: False)
        return _with_ctx(pkg, run)


@pytest.fixture(scope="module")
def mlp_start():
    mxtpu.random.seed(9)
    net = _mlp(mxtpu)
    net.initialize(mxtpu.initializer.Xavier(), ctx=mxtpu.cpu())
    net(mxtpu.nd.ones((1, 8)))
    return {k: p.data().asnumpy() for k, p in stripped(net).items()}


@pytest.mark.parametrize("optimizer,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01, "wd": 1e-3})])
def test_trainer_fused_sweep_matches_updater_and_mxtpu(mt, mlp_start,
                                                       optimizer, params):
    fused = _trainer_run(mt, mlp_start, optimizer, params, True)
    plain = _trainer_run(mt, mlp_start, optimizer, params, False)
    want = _trainer_run(mxtpu, mlp_start, optimizer, params)
    for k in want:
        np.testing.assert_array_equal(fused[k], plain[k], err_msg=k)
        _close(fused[k], want[k], GRAD_TOL, k)


def test_trainer_states_cross_from_the_sweep_to_the_updater(mt, mlp_start,
                                                            tmp_path):
    """The twin of test_trainer_fused_sweep_matches_classic: a states file
    the fused sweep wrote, loaded after the second of five steps, gives
    the Updater path and the sweep the same weights bit for bit."""
    params = {"learning_rate": 0.1, "momentum": 0.9}
    sf = str(tmp_path / "fused.states")
    w_fused = _trainer_run(mt, mlp_start, "sgd", params, True,
                           states_out=sf)
    w_plain = _trainer_run(mt, mlp_start, "sgd", params, False,
                           states_in=sf)
    w_back = _trainer_run(mt, mlp_start, "sgd", params, True, states_in=sf)
    for k in w_fused:
        np.testing.assert_array_equal(w_plain[k], w_back[k], err_msg=k)
        # the loaded momentum took effect: not the run that kept its own
        assert np.abs(w_back[k] - w_fused[k]).max() > 0, k


def test_trainer_refuses_several_contexts_and_a_kvstore(mt):
    with mt.cpu():
        net = _mlp(mt)
        net.initialize()
        net(mt.nd.ones((1, 8)))
        with pytest.raises(mt.MXNetError, match="A.4"):
            mt.gluon.Trainer(net.collect_params(), "sgd",
                             kvstore="dist_async").step(1)
        with pytest.raises(mt.MXNetError, match="named twice"):
            mt.gluon.Parameter("w", shape=(2,)).initialize(
                ctx=[mt.cpu(0), mt.cpu(0)])
        tr = mt.gluon.Trainer(net.collect_params(), "sgd", kvstore=None)
        assert tr.learning_rate == 0.01
        tr.set_learning_rate(0.5)
        assert tr.learning_rate == 0.5


def _small_net(pkg, prefix):
    net = pkg.gluon.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(pkg.gluon.nn.Conv2D(3, 3, in_channels=2))
        net.add(pkg.gluon.nn.BatchNorm(in_channels=3))
        net.add(pkg.gluon.nn.Dense(4, in_units=3 * 4 * 4))
    return net


def test_save_params_cross_between_the_packages_bit_for_bit(mt, tmp_path):
    jnet = _small_net(mxtpu, "model_")
    jnet.initialize(mxtpu.initializer.Xavier(), ctx=mxtpu.cpu())
    want = {k: p.data().asnumpy() for k, p in stripped(jnet).items()}
    f1, f2 = str(tmp_path / "mx.params"), str(tmp_path / "pt.params")
    jnet.save_params(f1)
    with mt.cpu():
        pnet = _small_net(mt, "other_")  # another prefix: names strip
        pnet.load_params(f1, ctx=mt.cpu())
        got = {k: p.data().asnumpy() for k, p in stripped(pnet).items()}
        pnet.save_params(f2)
        x = mt.nd.array(_r((2, 2, 6, 6), 4))
        pout = pnet(x).asnumpy()
    back = _small_net(mxtpu, "again_")
    back.load_params(f2, ctx=mxtpu.cpu())
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(
            stripped(back)[k].data().asnumpy(), want[k], err_msg=k)
    _close(pout, back(mxtpu.nd.array(_r((2, 2, 6, 6), 4))).asnumpy(),
           FWD_TOL, "forward of the loaded nets")


def test_split_and_load(mt):
    data = np.arange(16).reshape(8, 2).astype("f4")
    parts = mt.gluon.utils.split_and_load(data, [mt.cpu(0), mt.cpu(1)])
    assert [p.shape for p in parts] == [(4, 2), (4, 2)]
    np.testing.assert_array_equal(parts[1].asnumpy(), data[4:])
    one = mt.gluon.utils.split_and_load(data, [mt.cpu()])
    assert len(one) == 1 and one[0].shape == (8, 2)
    with pytest.raises(ValueError):
        mt.gluon.utils.split_data(mt.nd.array(data, ctx=mt.cpu()), 3)
    cols = mt.gluon.utils.split_data(mt.nd.array(data, ctx=mt.cpu()), 2,
                                     batch_axis=1)
    np.testing.assert_array_equal(cols[1].asnumpy(), data[:, 1:])


def test_clip_global_norm_matches_mxtpu(mt):
    arrays = [_r((3, 4), 1, 3.0), _r((5,), 2, 3.0)]
    jarr = [mxtpu.nd.array(a) for a in arrays]
    want = mxtpu.gluon.utils.clip_global_norm(jarr, 1.0)
    with mt.cpu():
        parr = [mt.nd.array(a) for a in arrays]
        got = mt.gluon.utils.clip_global_norm(parr, 1.0)
    assert abs(got - want) <= 1e-5 * want
    for p, j in zip(parr, jarr):
        _close(p.asnumpy(), j.asnumpy(), FWD_TOL, "clipped")


@pytest.mark.parametrize("num_workers", [0, 2])
def test_dataset_dataloader(mt, num_workers):
    X = np.random.RandomState(0).randn(32, 3).astype("f4")
    y = np.arange(32).astype("f4")
    with mt.cpu():
        ds = mt.gluon.data.ArrayDataset(X, y)
        assert len(ds) == 32
        loader = mt.gluon.data.DataLoader(ds, batch_size=8, shuffle=True,
                                          num_workers=num_workers)
        seen = []
        for data, label in loader:
            assert data.shape == (8, 3) and data.context == mt.cpu()
            np.testing.assert_array_equal(data.asnumpy(),
                                          X[label.asnumpy().astype(int)])
            seen += label.asnumpy().tolist()
        assert sorted(seen) == list(range(32))
        assert len(loader) == 4
        keep = mt.gluon.data.DataLoader(ds, batch_size=10,
                                        num_workers=num_workers)
        assert [d.shape[0] for d, _ in keep] == [10, 10, 10, 2]
        drop = mt.gluon.data.DataLoader(ds, batch_size=10,
                                        last_batch="discard",
                                        num_workers=num_workers)
        assert [d.shape[0] for d, _ in drop] == [10, 10, 10]
        it = iter(mt.gluon.data.DataLoader(ds, batch_size=4,
                                           num_workers=num_workers))
        next(it)
        it.close()  # an abandoned iteration stops its producer
        simple = mt.gluon.data.SimpleDataset([mt.nd.array(X[i])
                                              for i in range(4)])
        batch = next(iter(mt.gluon.data.DataLoader(simple, batch_size=4)))
        np.testing.assert_array_equal(batch.asnumpy(), X[:4])
        tf = ds.transform_first(lambda x: x * 2)
        np.testing.assert_array_equal(tf[3][0], X[3] * 2)


# ---------------------------------------------- twins of test_gluon.py
def test_parameter(mt):
    p = mt.gluon.Parameter("weight", shape=(4, 3))
    p.initialize(init=mt.initializer.One(), ctx=mt.cpu())
    assert np.allclose(p.data().asnumpy(), 1)
    assert p.list_ctx() == [mt.cpu()]
    p.zero_grad()
    assert np.allclose(p.grad().asnumpy(), 0)
    with pytest.raises(mt.MXNetError, match="context"):
        p.data(mt.gpu(0))


def test_parameter_dict(mt):
    params = mt.gluon.ParameterDict("net_")
    w = params.get("w", shape=(2, 2))
    assert w.name == "net_w"
    assert params.get("w") is w
    params.initialize(ctx=mt.cpu())
    assert w.data().shape == (2, 2)


def test_dense_forward_and_deferred_init(mt):
    with mt.cpu():
        layer = mt.gluon.nn.Dense(8, in_units=4)
        layer.initialize()
        assert layer(mt.nd.ones((2, 4))).shape == (2, 8)
        layer = mt.gluon.nn.Dense(8)
        layer.initialize()
        assert layer(mt.nd.ones((2, 5))).shape == (2, 8)
        assert layer.weight.shape == (8, 5)


def test_initialize_defaults_to_the_card(mt):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    net = mt.gluon.nn.Dense(2, in_units=2)
    with pytest.raises(mt.MXNetError, match="CUDA"):
        net.initialize()


def test_sequential_and_training(mt):
    np.random.seed(5)
    rng = np.random.RandomState(0)
    centers = rng.randn(4, 16) * 3
    y = rng.randint(0, 4, 512)
    X = (centers[y] + rng.randn(512, 16)).astype("float32")
    with mt.cpu():
        net = mt.gluon.nn.HybridSequential()
        net.add(mt.gluon.nn.Dense(32, activation="relu"))
        net.add(mt.gluon.nn.Dense(4))
        net.initialize(init=mt.initializer.Xavier())
        trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.5, "momentum": 0.9})
        loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
        for _ in range(10):
            for i in range(0, 512, 64):
                data = mt.nd.array(X[i:i + 64])
                label = mt.nd.array(y[i:i + 64].astype("float32"))
                with mt.autograd.record():
                    loss = loss_fn(net(data), label)
                loss.backward()
                trainer.step(64)
        preds = net(mt.nd.array(X)).asnumpy().argmax(axis=1)
    assert (preds == y).mean() > 0.9


def test_hybridize_training_reaches_the_parameters(mt):
    with mt.cpu():
        net = mt.gluon.nn.HybridSequential()
        net.add(mt.gluon.nn.Dense(8, activation="relu"))
        net.add(mt.gluon.nn.Dense(2))
        net.initialize()
        net.hybridize()
        x = mt.nd.array(np.random.RandomState(1).randn(4, 6).astype("f4"))
        with mt.autograd.record():
            out = net(x)
            loss = (out * out).sum()
        loss.backward()
        assert float(np.abs(net[0].weight.grad().asnumpy()).sum()) > 0
        assert net[0].weight.data()._data.grad is None


def test_model_zoo_resnet_tiny(mt):
    with mt.cpu():
        net = mt.gluon.model_zoo.vision.resnet18_v1(classes=10)
        net.initialize(init=mt.initializer.Xavier())
        assert net(mt.nd.ones((1, 3, 32, 32))).shape == (1, 10)
        net = mt.gluon.model_zoo.vision.get_model("resnet18_v2", classes=10)
        net.initialize(init=mt.initializer.Xavier())
        net.hybridize()
        assert net(mt.nd.ones((1, 3, 32, 32))).shape == (1, 10)
        assert net.fused_sites == 18


def test_symbol_block_runs_a_symbol(mt):
    with mt.cpu():
        data = mt.sym.var("data")
        out = mt.sym.Activation(mt.sym.FullyConnected(
            data, num_hidden=3, name="fc"), act_type="relu")
        blk = mt.gluon.SymbolBlock(out, data)
        blk.initialize()
        y = blk(mt.nd.ones((2, 5)))
        assert y.shape == (2, 3)
        assert sorted(blk.collect_params().keys()) == ["fc_bias",
                                                       "fc_weight"]


def test_layernorm_block(mt):
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 5, 8) * 10 + 100).astype("float32")
    with mt.cpu():
        net = mt.gluon.nn.HybridSequential()
        with net.name_scope():
            net.add(mt.gluon.nn.LayerNorm())
        net.initialize()
        net.hybridize()
        with mt.autograd.record():
            y = net(mt.nd.array(x))
            loss = (y * y).mean()
        loss.backward()
        ref = (x - x.mean(-1, keepdims=True)) / \
            np.sqrt(x.var(-1, keepdims=True) + 1e-5)
        np.testing.assert_allclose(y.asnumpy(), ref, rtol=1e-4, atol=1e-4)
        gamma = [p for k, p in net.collect_params().items()
                 if k.endswith("gamma")][0]
        assert gamma.shape == (8,)
        assert float(np.abs(gamma.grad().asnumpy()).sum()) > 0


def test_recorded_inference_plan_is_unfused_and_differentiable(mt,
                                                               monkeypatch):
    """A hybridized net recorded in predict mode runs the inference plan
    without the BatchNorm->ReLU fusion (the epilogue kernel has no
    gradient), so its gradients equal the imperative path's; outside
    record() the same plan fuses."""
    from mxtpu_torch.ops import nn as nn_ops
    calls = []
    real = nn_ops.bn_apply_relu_add

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(nn_ops, "bn_apply_relu_add", counted)
    x = _r((4, 3, 6, 6), 8, 2.0, 0.5)
    with mt.cpu():
        np.random.seed(2)
        net = _seq(mt, lambda nn: nn.Conv2D(4, 3, padding=1),
                   lambda nn: nn.BatchNorm(), lambda nn: nn.Activation("relu"),
                   lambda nn: nn.Dense(3))()
        net.initialize(mt.init.Xavier())
        net(mt.nd.array(x))
        grads = []
        for hyb in (False, True):
            net.hybridize(hyb)
            with mt.autograd.record(train_mode=False):
                loss = net(mt.nd.array(x)).sum()
            loss.backward()
            grads.append({k: p.grad().asnumpy() for k, p in
                          stripped(net).items() if p.grad_req != "null"})
        assert not calls
        net(mt.nd.array(x))
        assert len(calls) == 1 and net.fused_sites == 1
    for k in grads[0]:
        _close(grads[1][k], grads[0][k], FWD_TOL, k)
