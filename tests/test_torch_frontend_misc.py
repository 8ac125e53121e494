"""The rest of the port's Python frontend against mxtpu's, on the CPU:
``visualization.print_summary`` of ResNet-50 v2 (the text, the parameter
count and the memory line, equal to mxtpu's) and ``plot_network``'s
graph; ``executor_manager`` (the batch split by work load, its errors,
the duplicate-name check, the legacy manager driving a step);
``libinfo`` (the port's native library, built on first use, and
``__version__``); ``symbol_doc``; the callbacks ``ProgressBar`` and
``LogValidationMetricsCallback``; ``context.num_devices``; and every
name of this slice present with mxtpu's signature.

torch is imported lazily and pinned to one thread: several test workers
share the host."""
import contextlib
import importlib
import inspect
import io
import json
import logging
import os
import re

import numpy as np
import pytest

import mxtpu as mx


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


def _printed(fn, *args, **kwargs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kwargs)
    return buf.getvalue()


def _canonical(text, sym):
    """``text`` with the counters of ``sym``'s automatic node names
    (``flatten3``: each package numbers the unnamed ops it has made in
    the process) and the padding after them taken out."""
    for op in {n["op"] for n in json.loads(sym.tojson())["nodes"]}:
        text = re.sub(r"\b%s\d+\b" % re.escape(op), op.lower() + "#",
                      text, flags=re.IGNORECASE)
    return re.sub(r" +", " ", text)


@pytest.mark.parametrize("shape", [None, (2, 3, 224, 224)])
def test_print_summary_of_resnet50_equals_mxtpus(mt, shape):
    kw = {} if shape is None else {"shape": {"data": shape}}
    tsym, jsym = mt.models.get_resnet(), mx.models.get_resnet()
    got = _printed(mt.viz.print_summary, tsym, **kw)
    want = _printed(mx.viz.print_summary, jsym, **kw)
    assert _canonical(got, tsym) == _canonical(want, jsym)
    total = [ln for ln in got.splitlines() if ln.startswith("Total params")]
    if shape is not None:
        assert total == ["Total params: 25549480"]


def test_print_summary_with_legacy_positions(mt):
    tsym, jsym = mt.models.get_mlp(10), mx.models.get_mlp(10)
    for positions in ((.4, .6, .8, 1.), (.5, 1.)):
        got = _printed(mt.visualization.print_summary, tsym,
                       shape={"data": (4, 784)}, positions=positions,
                       line_length=100)
        want = _printed(mx.visualization.print_summary, jsym,
                        shape={"data": (4, 784)}, positions=positions,
                        line_length=100)
        assert _canonical(got, tsym) == _canonical(want, jsym)


def test_plot_network_builds_mxtpus_graph(mt):
    pytest.importorskip("graphviz")
    tsym, jsym = mt.models.get_lenet(10), mx.models.get_lenet(10)
    got = mt.viz.plot_network(tsym, title="lenet")
    want = mx.viz.plot_network(jsym, title="lenet")
    assert _canonical(got.source, tsym) == _canonical(want.source, jsym)


@pytest.mark.parametrize("batch,loads", [(10, [1, 1]), (10, [1, 2, 2]),
                                         (7, [3, 1]), (4, [1, 1, 1, 1]),
                                         (9, [0.5, 0.25, 0.25])])
def test_split_input_slice_as_mxtpu(mt, batch, loads):
    from mxtpu import executor_manager as jem
    from mxtpu_torch import executor_manager as tem
    assert tem._split_input_slice(batch, loads) == \
        jem._split_input_slice(batch, loads)


def test_executor_manager_errors_as_mxtpu(mt):
    from mxtpu import executor_manager as jem
    from mxtpu_torch import executor_manager as tem
    for em, err in ((tem, mt.MXNetError), (jem, mx.MXNetError)):
        with pytest.raises(err, match="smaller than the device count"):
            em._split_input_slice(2, [1, 1, 1])
    for pkg, em in ((mt, tem), (mx, jem)):
        net = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=2,
                                     name="fc")
        names, aux = em._check_arguments(net)
        assert names == ["data", "fc_weight", "fc_bias"] and aux == []
        a = pkg.sym.Variable("a")
        dup = pkg.sym.Group([pkg.sym.FullyConnected(a, num_hidden=2,
                                                    name="fc"),
                             pkg.sym.FullyConnected(a, num_hidden=2,
                                                    name="fc")])
        with pytest.raises(pkg.MXNetError, match="duplicate arguments"):
            em._check_arguments(dup)


def test_legacy_manager_drives_a_step_on_two_contexts(mt):
    from mxtpu_torch import executor_manager as tem
    rng = np.random.RandomState(0)
    x = rng.rand(8, 6).astype(np.float32)
    y = rng.randint(0, 3, 8).astype(np.float32)
    it = mt.io.NDArrayIter(x, y, batch_size=8)
    net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
        mt.sym.Variable("data"), num_hidden=3, name="fc"), name="softmax")
    man = tem.DataParallelExecutorManager(net, [mt.cpu(0), mt.cpu(1)], it,
                                          work_load_list=[1, 3])
    assert man.slices == [slice(0, 2), slice(2, 8)]
    assert man.param_names == ["fc_weight", "fc_bias"]
    with mt.cpu():
        w = mt.nd.array(rng.randn(3, 6).astype(np.float32))
        man.set_params({"fc_weight": w, "fc_bias": mt.nd.zeros((3,))}, {})
        batch = it.next()
        man.load_data_batch(batch)
        man.forward(is_train=True)
        man.backward()
        metric = mt.metric.Accuracy()
        man.update_metric(metric, batch.label)
    assert metric.num_inst == 8
    grads = [g.asnumpy() for g in man.grad_arrays[0]]
    assert len(grads) == 2 and all(np.isfinite(g).all() for g in grads)


def test_libinfo_finds_the_native_library_and_the_version(mt):
    paths = mt.libinfo.find_lib_path()
    assert len(paths) == 1 and os.path.isfile(paths[0])
    assert paths[0] == str(mt._native.library_path())
    assert mt.__version__ == mt.libinfo.__version__ == mx.__version__


def test_symbol_doc_as_mxtpu(mt):
    got = mt.symbol_doc.SymbolDoc.get_output_shape(
        mt.models.get_mlp(10), data=(4, 784))
    want = mx.symbol_doc.SymbolDoc.get_output_shape(
        mx.models.get_mlp(10), data=(4, 784))
    assert got == want == {"softmax_output": (4, 10)}
    for name in dir(mx.symbol_doc):
        if name.endswith("Doc"):
            assert issubclass(getattr(mt.symbol_doc, name),
                              mt.symbol_doc.SymbolDoc)


def _param(pkg, nbatch, metric=None):
    return pkg.model.BatchEndParam(epoch=1, nbatch=nbatch,
                                   eval_metric=metric, locals=None)


def test_progress_bar_as_mxtpu(mt):
    for n in (0, 3, 7, 10, 12):
        got = _printed(mt.callback.ProgressBar(10, length=20),
                       _param(mt, n))
        want = _printed(mx.callback.ProgressBar(10, length=20),
                        _param(mx, n))
        assert got == want


def test_log_validation_metrics_as_mxtpu(mt, caplog):
    logs = []
    for pkg in (mt, mx):
        metric = pkg.metric.create(["acc", "mse"])
        with pkg.cpu():
            metric.update([pkg.nd.array(np.array([0, 1], np.float32))],
                          [pkg.nd.array(np.array([[.9, .1], [.2, .8]],
                                                 np.float32))])
        caplog.clear()
        with caplog.at_level(logging.INFO):
            pkg.callback.LogValidationMetricsCallback()(_param(pkg, 0,
                                                               metric))
            pkg.callback.LogValidationMetricsCallback()(_param(pkg, 0))
        logs.append([r.getMessage() for r in caplog.records])
    assert logs[0] == logs[1] and len(logs[0]) == 2
    assert logs[0][0] == "Epoch[1] Validation-accuracy=1.000000"


def test_num_devices_counts_the_cards_and_the_host(mt):
    import torch
    assert mt.context.num_devices() == torch.cuda.device_count() + 1
    assert mx.context.num_devices() == len(__import__("jax").devices())


# (module, names) of this slice, each present in the port with mxtpu's
# signature; engine goes with A.8's telemetry and fault hooks
SURFACE = [
    ("metric", ["F1", "MAE", "MSE", "RMSE", "PearsonCorrelation", "Loss",
                "Torch", "Caffe", "CustomMetric", "np", "create"]),
    ("optimizer", ["AdaDelta", "Adamax", "Nadam", "Ftrl", "SGLD", "DCASGD",
                   "Test", "ccSGD", "SGD"]),
    ("initializer", ["Orthogonal", "MSRAPrelu", "Bilinear", "Mixed",
                     "Load"]),
    ("callback", ["ProgressBar", "LogValidationMetricsCallback"]),
    ("context", ["num_devices"]),
    ("random", ["uniform", "normal", "gamma", "exponential", "poisson",
                "negative_binomial", "generalized_negative_binomial",
                "multinomial"]),
    ("visualization", ["print_summary", "plot_network"]),
    ("executor_manager", ["DataParallelExecutorManager",
                          "_split_input_slice", "_check_arguments"]),
    ("libinfo", ["find_lib_path"]),
    ("symbol_doc", ["SymbolDoc"]),
]


def _signature(obj):
    target = obj.__init__ if inspect.isclass(obj) else obj
    return [(p.name, p.default) for p in
            inspect.signature(target).parameters.values()]


@pytest.mark.parametrize("module,names", SURFACE,
                         ids=[s[0] for s in SURFACE])
def test_every_name_has_mxtpus_signature(mt, module, names):
    tmod = importlib.import_module("mxtpu_torch." + module)
    jmod = importlib.import_module("mxtpu." + module)
    for name in names:
        got, want = getattr(tmod, name), getattr(jmod, name)
        assert _signature(got) == _signature(want), (module, name)
    for alias in ("viz", "rnd"):
        assert hasattr(mt, alias) and hasattr(mx, alias)
