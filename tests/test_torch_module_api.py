"""The port's Module-level inference surface against mxtpu's, from the
same numpy-seeded weights and data: ``predict``/``iter_predict`` (twin of
tests/test_module.py:55: the pad trimmed, batches merged or not,
``always_output_list``; bit for bit with each other, within 1e-5 of
mxtpu's), ``output_shapes``, ``prepare``; a BatchNorm net's fused predict
against its unfused walk (within 1e-5); ``SequentialModule`` (twin of
:144, and three SGD steps of a conv trunk + head against the single
Module, within 1e-5); ``BucketingModule``'s ``predict`` through the base
class, ``output_shapes`` and ``install_monitor`` over later buckets;
``FeedForward`` (twin of tests/test_misc_modules.py:172: fit, predict in
row order, ``return_data``, ``score``, ``save``/``load``, ``create``);
the twin of examples/module/python_loss.py (``chip_smoke.
python_loss_twin``) against mxtpu's example; and every name of the
surface present in the port with mxtpu's signature."""
import importlib.util
import inspect
import logging
import pathlib

import numpy as np
import pytest

import mxtpu as mx

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


def _quiet():
    log = logging.getLogger("test_torch_module_api")
    log.setLevel(logging.ERROR)
    return log


def _mlp(pk, classes=4):
    net = pk.sym.FullyConnected(pk.sym.Variable("data"), num_hidden=16,
                                name="fc1")
    net = pk.sym.Activation(net, act_type="relu")
    net = pk.sym.FullyConnected(net, num_hidden=classes, name="fc2")
    return pk.sym.SoftmaxOutput(net, name="softmax")


def _conv_bn(pk, classes=3):
    net = pk.sym.Convolution(pk.sym.Variable("data"), num_filter=4,
                             kernel=(3, 3), pad=(1, 1), name="conv0")
    net = pk.sym.BatchNorm(net, name="bn0")
    net = pk.sym.Activation(net, act_type="relu", name="relu0")
    net = pk.sym.Flatten(net, name="flat")
    net = pk.sym.FullyConnected(net, num_hidden=classes, name="fc")
    return pk.sym.SoftmaxOutput(net, name="softmax")


def _params(sym, data_shape, seed=0):
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=data_shape)
    args = {n: rng.randn(*s).astype(np.float32) * 0.3
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: rng.rand(*s).astype(np.float32) + 0.5
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _nd(pk, d):
    return {k: pk.nd.array(v, ctx=pk.cpu()) for k, v in d.items()}


def _module(pk, sym, it, args, aux, for_training=False, **kw):
    ctx = {} if pk is mx else {"context": pk.cpu()}
    mod = pk.mod.Module(sym, logger=_quiet(), **ctx, **kw)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
             for_training=for_training)
    mod.init_params(arg_params=_nd(pk, args), aux_params=_nd(pk, aux))
    return mod


def _data(n=70, dim=10, classes=4, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, dim).astype(np.float32),
            rng.randint(0, classes, n).astype(np.float32))


def test_module_predict_and_params(mt):
    """Twin of test_module.py:55 with a padded last batch (70 rows at
    B=16): the pad trimmed, merged outputs within 1e-5 of mxtpu's, the
    port's predict bit for bit the concatenation of iter_predict's."""
    x, y = _data()
    args, aux = _params(_mlp(mt), (16, 10))
    preds, parts = [], None
    for pk in (mt, mx):
        it = pk.io.NDArrayIter(x, y, batch_size=16)
        mod = _module(pk, _mlp(pk), it, args, aux)
        out = mod.predict(it)
        assert out.shape == (70, 4)
        preds.append(out.asnumpy())
        assert "fc1_weight" in mod.get_params()[0]
        if pk is mt:
            assert mod.output_shapes == [("softmax_output", (16, 4))]
            steps = list(mod.iter_predict(it))
            assert [n for _, n, _ in steps] == [0, 1, 2, 3, 4]
            assert [o[0].shape[0] for o, _, _ in steps] == \
                [16, 16, 16, 16, 6]
            parts = np.concatenate([o[0].asnumpy() for o, _, _ in steps])
            listed = mod.predict(it, merge_batches=False)
            assert len(listed) == 5 and listed[-1][0].shape == (6, 4)
            assert len(mod.predict(it, always_output_list=True)) == 1
            assert mod.predict(it, num_batch=2).shape == (32, 4)
            assert mod.prepare(next(iter(it))) is None
    np.testing.assert_array_equal(preds[0], parts)
    np.testing.assert_allclose(preds[0], preds[1], rtol=0, atol=1e-5)


def test_predict_of_a_batchnorm_net_is_its_unfused_walk(mt):
    """The fused inference walk (BatchNorm->ReLU as one epilogue step)
    within 1e-5 of the unfused walk and of mxtpu's predict."""
    rng = np.random.RandomState(2)
    x = rng.randn(12, 3, 6, 6).astype(np.float32)
    y = rng.randint(0, 3, 12).astype(np.float32)
    args, aux = _params(_conv_bn(mt), (4, 3, 6, 6))
    outs = []
    for pk in (mt, mx):
        it = pk.io.NDArrayIter(x, y, batch_size=4)
        outs.append(_module(pk, _conv_bn(pk), it, args, aux)
                    .predict(it).asnumpy())
    it = mt.io.NDArrayIter(x, y, batch_size=4)
    mod = _module(mt, _conv_bn(mt), it, args, aux)
    ex = mod._exec_group.execs[0]
    assert ex.fused_sites == 1
    unfused = []
    for batch in it:
        mod._exec_group.load_batch(batch)
        run = ex._run(False, fuse=False)
        unfused.append(run({k: a._data for k, a in ex.arg_dict.items()},
                           {k: a._data for k, a in ex.aux_dict.items()})
                       [0][0].numpy())
    assert run.fused_sites == 0
    np.testing.assert_allclose(outs[0], np.concatenate(unfused), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=1e-5)


def test_sequential_module(mt):
    """Twin of test_module.py:144: two modules chained with auto_wiring
    and take_labels; the forward against mxtpu's from the same weights,
    and the first module's input gradient after backward."""
    outs = []
    w = np.random.RandomState(3)
    vals = {"fc1_weight": w.randn(8, 16).astype(np.float32) * 0.2,
            "fc1_bias": w.randn(8).astype(np.float32) * 0.1,
            "fc2_weight": w.randn(4, 8).astype(np.float32) * 0.2,
            "fc2_bias": w.randn(4).astype(np.float32) * 0.1}
    for pk in (mt, mx):
        ctx = {"context": pk.cpu()}
        net1 = pk.sym.FullyConnected(pk.sym.Variable("data"), num_hidden=8,
                                     name="fc1")
        net2 = pk.sym.SoftmaxOutput(pk.sym.FullyConnected(
            pk.sym.Variable("fc1_output"), num_hidden=4, name="fc2"),
            name="softmax")
        mod = pk.mod.SequentialModule(logger=_quiet())
        mod.add(pk.mod.Module(net1, label_names=None, logger=_quiet(),
                              **ctx))
        mod.add(pk.mod.Module(net2, data_names=("fc1_output",),
                              logger=_quiet(), **ctx),
                take_labels=True, auto_wiring=True)
        mod.bind(data_shapes=[("data", (4, 16))],
                 label_shapes=[("softmax_label", (4,))],
                 inputs_need_grad=True)
        mod.init_params(arg_params=_nd(pk, vals))
        mod.init_optimizer()
        batch = pk.io.DataBatch(
            data=[pk.nd.array(np.linspace(-1, 1, 64).reshape(4, 16),
                              ctx=pk.cpu())],
            label=[pk.nd.array(np.array([0, 1, 2, 3.0]), ctx=pk.cpu())])
        mod.forward(batch, is_train=True)
        mod.backward()
        # mxtpu's bind never sets inputs_need_grad, so its
        # get_input_grads fails its own assertion: read the first module's
        first = mod if pk is mt else mod._modules[0]
        outs.append((mod.get_outputs()[0].asnumpy(),
                     first.get_input_grads()[0].asnumpy()))
        assert mod.output_shapes[0][1] == (4, 4)
        assert sorted(mod.get_params()[0]) == sorted(vals)
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_sequential_module_trains_as_the_single_module(mt):
    """A conv+BatchNorm trunk and a fc+SoftmaxOutput head as a
    SequentialModule take three SGD steps (momentum) to within 1e-5 of
    the single Module from the same weights: the head's input gradient
    is the trunk's head gradient."""
    full = _conv_bn(mt)
    trunk = full.get_children()[0].get_children()[0]
    head = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
        mt.sym.Variable("data"), num_hidden=3, name="fc"), name="softmax")
    args, aux = _params(full, (4, 3, 6, 6))
    rng = np.random.RandomState(4)
    batches = [mt.io.DataBatch(
        [mt.nd.array(rng.randn(4, 3, 6, 6), ctx=mt.cpu())],
        [mt.nd.array(rng.randint(0, 3, 4).astype(np.float32),
                     ctx=mt.cpu())]) for _ in range(3)]
    single = mt.mod.Module(full, context=mt.cpu(), logger=_quiet())
    seq = mt.mod.SequentialModule(logger=_quiet())
    seq.add(mt.mod.Module(trunk, label_names=None, context=mt.cpu(),
                          logger=_quiet()))
    seq.add(mt.mod.Module(head, context=mt.cpu(), logger=_quiet()),
            take_labels=True, auto_wiring=True)
    for mod in (single, seq):
        mod.bind(data_shapes=[("data", (4, 3, 6, 6))],
                 label_shapes=[("softmax_label", (4,))])
        mod.init_params(arg_params=_nd(mt, args), aux_params=_nd(mt, aux),
                        allow_extra=True)
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9})
        for batch in batches:
            mod.forward_backward(batch)
            mod.update()
    for got, want in zip(seq.get_params(), single.get_params()):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].asnumpy(), want[k].asnumpy(),
                                       rtol=0, atol=1e-5, err_msg=k)
    moved = max(np.abs(single.get_params()[0][k].asnumpy() - v).max()
                for k, v in args.items())
    assert moved > 1e-3


class _Buckets:
    """An NDArrayIter whose batches carry ``bucket_key`` (the default
    bucket), as a BucketSentenceIter's do."""

    def __init__(self, it, key):
        self.it, self.key = it, key
        self.provide_data, self.provide_label = it.provide_data, \
            it.provide_label

    def reset(self):
        self.it.reset()

    def __iter__(self):
        for batch in self.it:
            batch.bucket_key = self.key
            batch.provide_data = self.provide_data
            batch.provide_label = self.provide_label
            yield batch


def test_bucketing_module_predicts_through_the_base_class(mt):
    """BucketingModule.predict/iter_predict are BaseModule's, its
    output_shapes the current bucket's, and install_monitor reaches a
    bucket bound after it."""
    x, y = _data(n=40, dim=6)
    args, aux = _params(_mlp(mt), (8, 6))
    preds = []
    for pk in (mt, mx):
        ctx = {} if pk is mx else {"context": pk.cpu()}
        gen = (lambda key, pk=pk: (_mlp(pk), ("data",), ("softmax_label",)))
        mod = pk.mod.BucketingModule(gen, default_bucket_key=8,
                                     logger=_quiet(), **ctx)
        it = _Buckets(pk.io.NDArrayIter(x, y, batch_size=8), 8)
        mod.bind(data_shapes=it.provide_data,
                 label_shapes=it.provide_label, for_training=False)
        mod.init_params(arg_params=_nd(pk, args), aux_params=_nd(pk, aux))
        preds.append(mod.predict(it).asnumpy())
        if pk is mt:
            assert mod.output_shapes == [("softmax_output", (8, 4))]
            stats = []
            mon = mt.monitor.Monitor(
                1, stat_func=lambda a: stats.append(a.shape) or 0.0,
                pattern="fc1_output")
            mod.install_monitor(mon)
            later = mt.io.DataBatch(
                [mt.nd.array(x[:4], ctx=mt.cpu())],
                [mt.nd.array(y[:4], ctx=mt.cpu())], bucket_key=4,
                provide_data=[("data", (4, 6))],
                provide_label=[("softmax_label", (4,))])
            mon.tic()
            mod.forward(later, is_train=False)
            mon.toc()
            assert stats == [(4, 16)]
            assert sorted(mod._buckets) == [4, 8]
    assert preds[0].shape == (40, 4)
    np.testing.assert_allclose(preds[0], preds[1], rtol=0, atol=1e-5)


def _blobs(mt):
    net = [pk.sym.SoftmaxOutput(pk.sym.FullyConnected(
        pk.sym.Variable("data"), num_hidden=3, name="fc"), name="softmax")
        for pk in (mt, mx)]
    rng = np.random.RandomState(0)
    centers = rng.randn(3, 6) * 3
    y = rng.randint(0, 3, 90)
    x = (centers[y] + rng.randn(90, 6)).astype("float32")
    return net, x, y.astype("float32")


def test_feedforward_predict_row_order(mt, tmp_path):
    """Twin of test_misc_modules.py:172: fit on blobs, predict in the
    caller's row order (accuracy > 0.9 in both packages), score; from the
    same weights the port's predictions are mxtpu's within 1e-5;
    return_data gives the rows it ran; save/load and create."""
    (tnet, jnet), x, y = _blobs(mt)
    np.random.seed(4)
    mx.random.seed(4)
    jff = mx.model.FeedForward(symbol=jnet, num_epoch=8, learning_rate=0.3,
                               numpy_batch_size=30)
    jff.fit(X=x, y=y)
    tff = mt.model.FeedForward(symbol=tnet, ctx=mt.cpu(), num_epoch=8,
                               learning_rate=0.3, numpy_batch_size=30)
    tff.fit(X=x, y=y)
    for ff, pk in ((tff, mt), (jff, mx)):
        assert (ff.predict(x).argmax(1) == y).mean() > 0.9
        assert ff.score(pk.io.NDArrayIter(x, y, batch_size=30)) > 0.9
    same = mt.model.FeedForward(
        symbol=tnet, ctx=mt.cpu(), numpy_batch_size=30,
        arg_params={k: mt.nd.array(v.asnumpy(), ctx=mt.cpu())
                    for k, v in jff.arg_params.items()})
    np.testing.assert_allclose(same.predict(x), jff.predict(x), rtol=0,
                               atol=1e-5)
    out, data, label = same.predict(x[:70], return_data=True)
    np.testing.assert_array_equal(data, x[:70])
    assert label is None and out.shape == (70, 3)
    np.testing.assert_array_equal(out, same.predict(x[:70]))
    prefix = str(tmp_path / "ff")
    tff.save(prefix, 8)
    back = mt.model.FeedForward.load(prefix, 8, ctx=mt.cpu(),
                                     numpy_batch_size=30)
    np.testing.assert_array_equal(back.predict(x), tff.predict(x))
    made = mt.model.FeedForward.create(tnet, x, y, ctx=mt.cpu(),
                                       num_epoch=2, learning_rate=0.3,
                                       numpy_batch_size=30)
    assert made.predict(x).shape == (90, 3)
    assert mt.model.wait_checkpoints(prefix) is None
    param = mt.model.BatchEndParam(epoch=1, nbatch=2, eval_metric=None,
                                   locals=None)
    assert param == mx.model.BatchEndParam(1, 2, None, None)


def _python_loss_example():
    spec = importlib.util.spec_from_file_location(
        "python_loss_example", REPO / "examples" / "module" /
        "python_loss.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mxtpu_python_loss(example, arg_params, seed=4, epochs=8):
    """examples/module/python_loss.py's main with the trunk's initial
    weights given."""
    mx.random.seed(seed)
    np.random.seed(seed)
    x, y = example.synth(1024, np.random.RandomState(seed))
    nval = 256
    train = mx.io.NDArrayIter(x[:-nval], y[:-nval], 32, shuffle=True,
                              label_name="softmax_label")
    val = mx.io.NDArrayIter(x[-nval:], y[-nval:], 32,
                            label_name="softmax_label")
    net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=64,
                                name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=5, name="fc2")
    mod = mx.mod.SequentialModule()
    mod.add(mx.mod.Module(net, context=mx.cpu(0), label_names=()),
            auto_wiring=True)
    mod.add(mx.mod.PythonLossModule(grad_func=example.mc_hinge_grad),
            take_labels=True, auto_wiring=True)
    mod.fit(train, eval_data=val, num_epoch=epochs, optimizer="sgd",
            optimizer_params={"learning_rate": 0.5, "momentum": 0.9},
            eval_metric="acc", arg_params=arg_params)
    val.reset()
    return mod.score(val, mx.metric.Accuracy())[0][1]


def test_python_loss_twin_scores_as_mxtpus_example(mt):
    """chip_smoke's port twin of examples/module/python_loss.py: its own
    Xavier draw passes the example's 0.9 gate as mxtpu's example does at
    the gate's seed; from the same initial trunk weights the two packages
    reach the same validation accuracy (within one example of 256)."""
    import chip_smoke
    example = _python_loss_example()
    rng = np.random.RandomState(11)
    init = {"fc1_weight": rng.randn(64, 32) * 0.2,
            "fc1_bias": np.zeros(64), "fc2_weight": rng.randn(5, 64) * 0.2,
            "fc2_bias": np.zeros(5)}
    ours = chip_smoke.python_loss_twin(
        mt, mt.cpu(), arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                                  for k, v in init.items()})
    theirs = _mxtpu_python_loss(
        example, {k: mx.nd.array(v) for k, v in init.items()})
    assert abs(ours - theirs) <= 1.0 / 256 + 1e-9, (ours, theirs)
    assert chip_smoke.python_loss_twin(mt, mt.cpu()) > 0.9
    mx.random.seed(42)
    np.random.seed(42)
    assert example.main(["--epochs", "8"]) > 0.9
    grads = [f(mt.nd.array(np.eye(3, 5), ctx=mt.cpu()),
               mt.nd.array(np.array([0, 4, 1.0]), ctx=mt.cpu()))
             for f in (chip_smoke.mc_hinge_grad, example.mc_hinge_grad)]
    np.testing.assert_array_equal(grads[0], grads[1])


SURFACE = [
    ("module.Module", ["predict", "iter_predict", "install_monitor",
                       "prepare", "output_shapes"]),
    ("module.BucketingModule", ["predict", "iter_predict",
                                "install_monitor", "output_shapes"]),
    ("executor.Executor", ["arg_arrays", "aux_arrays", "copy_params_from",
                           "reshape", "set_monitor_callback",
                           "simple_bind"]),
    ("symbol.Symbol", ["get_internals", "get_children", "list_inputs",
                       "list_attr", "infer_type", "infer_shape_partial",
                       "eval", "grad", "debug_str"]),
    ("predict.Predictor", ["__init__", "partial_forward", "num_steps",
                           "forward_batch", "reshaped", "num_outputs",
                           "symbol_hash"]),
    ("predict", ["create", "load_checkpoint_predictor"]),
    ("model", ["FeedForward", "BatchEndParam", "wait_checkpoints"]),
    ("model.FeedForward", ["__init__", "fit", "predict", "score", "save",
                           "load", "create"]),
    ("module", ["PythonModule", "PythonLossModule", "SequentialModule"]),
    ("module.PythonModule", ["__init__", "bind", "install_monitor",
                             "output_shapes"]),
    ("module.PythonLossModule", ["__init__", "forward", "backward",
                                 "get_input_grads", "get_outputs"]),
    ("module.SequentialModule", ["__init__", "add", "bind", "forward",
                                 "backward", "update", "init_params",
                                 "init_optimizer", "install_monitor",
                                 "output_shapes"]),
    ("monitor.Monitor", ["__init__", "tic", "toc", "toc_print", "install",
                         "interval", "sort"]),
    ("monitor", ["Monitor"]),
]


def _resolve(pkg, path):
    obj = pkg
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


@pytest.mark.parametrize("path,names", SURFACE,
                         ids=[p for p, _ in SURFACE])
def test_every_surface_name_has_mxtpus_signature(mt, path, names):
    """Each name exists in the port where mxtpu has it; a callable has
    mxtpu's signature, a property is a property in both (a Monitor's
    ``interval``/``sort`` are attributes of an instance)."""
    ours, theirs = _resolve(mt, path), _resolve(mx, path)
    if path == "monitor.Monitor":
        inst = [c(2, pattern="x", sort=True) for c in (ours, theirs)]
        assert inst[0].interval == inst[1].interval == 2
        assert inst[0].sort and inst[0].re_prog.pattern == "x"
    for name in names:
        if path == "monitor.Monitor" and name in ("interval", "sort"):
            continue
        a = inspect.getattr_static(ours, name)
        b = inspect.getattr_static(theirs, name)
        if isinstance(b, property):
            assert isinstance(a, property), (path, name)
            continue
        a, b = getattr(ours, name), getattr(theirs, name)
        if inspect.isclass(b) and not callable(getattr(b, "__init__", 0)):
            continue
        if name == "BatchEndParam":
            assert a._fields == b._fields
            continue
        assert inspect.signature(a) == inspect.signature(b), (path, name)
