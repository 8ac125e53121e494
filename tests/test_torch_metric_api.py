"""The metrics this slice adds to the port (F1, MAE, MSE, RMSE,
PearsonCorrelation, Loss and its Torch/Caffe names, CustomMetric and
``np``) against mxtpu's: the same seeded numpy labels and outputs,
batch by batch, through both packages' ``update``/``get`` (within 1e-6
relative); the device kernels of MAE, MSE, RMSE and Loss in
``DeviceMetricAccum`` against the port's own host path (within 1e-6);
and ``create`` by name, alias, list and callable.

torch is imported lazily and pinned to one thread: several test workers
share the host."""
import numpy as np
import pytest

import mxtpu as mx

RTOL = 1e-6


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


def _batches(kind, n=3, seed=0):
    """[(label, pred)] numpy batches for a metric family."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        b = 8 + i
        if kind == "binary":
            pred = rng.rand(b, 2).astype(np.float32)
            label = rng.randint(0, 2, b).astype(np.float32)
        elif kind == "column":
            pred = rng.randn(b, 1).astype(np.float32)
            label = rng.randn(b).astype(np.float32)
        elif kind == "wide":
            pred = rng.rand(b, 5).astype(np.float32)
            label = rng.rand(b, 5).astype(np.float32)
        else:  # a loss head's outputs
            pred = rng.rand(b, 3).astype(np.float32)
            label = rng.randint(0, 3, b).astype(np.float32)
        out.append((label, pred))
    return out


def _feval(label, pred):
    return float(np.abs(label.ravel() - pred[:, 0]).sum()), label.size


METRICS = [
    ("F1", {}, "binary"),
    ("MAE", {}, "column"),
    ("MAE", {}, "wide"),
    ("MSE", {}, "column"),
    ("MSE", {}, "wide"),
    ("RMSE", {}, "column"),
    ("RMSE", {}, "wide"),
    ("PearsonCorrelation", {}, "wide"),
    ("Loss", {}, "loss"),
    ("Torch", {}, "loss"),
    ("Caffe", {}, "loss"),
    ("CustomMetric", {"feval": _feval}, "column"),
]


def _run(pkg, name, kw, batches):
    m = getattr(pkg.metric, name)(**kw)
    for label, pred in batches:
        m.update([pkg.nd.array(label)], [pkg.nd.array(pred)])
    return m.get()


@pytest.mark.parametrize("name,kw,kind", METRICS,
                         ids=["%s-%s" % (m[0], m[2]) for m in METRICS])
def test_update_and_get_match_mxtpu(mt, name, kw, kind):
    batches = _batches(kind)
    with mt.cpu():
        got = _run(mt, name, kw, batches)
    with mx.cpu():
        want = _run(mx, name, kw, batches)
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL)


def test_rmse_is_a_mean_of_batch_roots(mt):
    """RMSE averages each batch's root mean square error (mxtpu's and the
    reference's rule), not one root of the whole set's mean."""
    batches = _batches("column")
    with mt.cpu():
        _, got = _run(mt, "RMSE", {}, batches)
    roots = [np.sqrt(((l.reshape(-1, 1) - p) ** 2).mean()) for l, p in
             batches]
    np.testing.assert_allclose(got, np.mean(roots), rtol=RTOL)
    whole = np.sqrt(np.mean(np.concatenate(
        [((l.reshape(-1, 1) - p) ** 2).ravel() for l, p in batches])))
    assert abs(got - whole) > 1e-6


def test_np_wraps_a_numpy_function_as_mxtpu(mt):
    batches = _batches("column")

    def mean_abs(label, pred):
        return float(np.abs(label.ravel() - pred.ravel()).mean())

    got = mt.metric.np(mean_abs)
    want = mx.metric.np(mean_abs)
    for label, pred in batches:
        with mt.cpu():
            got.update([mt.nd.array(label)], [mt.nd.array(pred)])
        with mx.cpu():
            want.update([mx.nd.array(label)], [mx.nd.array(pred)])
    assert got.get()[0] == want.get()[0] == "mean_abs"
    np.testing.assert_allclose(got.get()[1], want.get()[1], rtol=RTOL)


DEVICE = [("MAE", "column"), ("MAE", "wide"), ("MSE", "column"),
          ("MSE", "wide"), ("RMSE", "column"), ("RMSE", "wide"),
          ("Loss", "loss")]


@pytest.mark.parametrize("name,kind", DEVICE,
                         ids=["%s-%s" % d for d in DEVICE])
def test_device_kernel_equals_the_host_path(mt, name, kind):
    batches = _batches(kind, n=4)
    with mt.cpu():
        host = _run(mt, name, {}, batches)
        metric = getattr(mt.metric, name)()
        accum = mt.metric.DeviceMetricAccum.wrap(metric)
        assert accum is not None
        for label, pred in batches:
            accum.update([mt.nd.array(label)], [mt.nd.array(pred)])
        got = dict(accum.sync())
    assert accum.syncs == 1
    np.testing.assert_allclose(got[host[0]], host[1], rtol=RTOL)


def test_composite_of_device_kernels_accumulates_on_the_device(mt):
    """A composite of every device-kernel metric wraps as one accumulator
    (F1, Pearson and custom metrics keep the host path: no wrap)."""
    rng = np.random.RandomState(3)
    with mt.cpu():
        comp = mt.metric.create(["acc", "ce", "mse", "rmse", "mae",
                                 mt.metric.TopKAccuracy(top_k=2)])
        host = mt.metric.create(["acc", "ce", "mse", "rmse", "mae",
                                 mt.metric.TopKAccuracy(top_k=2)])
        accum = mt.metric.DeviceMetricAccum.wrap(comp)
        for _ in range(3):
            pred = rng.rand(6, 4).astype(np.float32)
            pred /= pred.sum(axis=1, keepdims=True)
            label = rng.randint(0, 4, 6).astype(np.float32)
            accum.update([mt.nd.array(label)], [mt.nd.array(pred)])
            host.update([mt.nd.array(label)], [mt.nd.array(pred)])
        got = dict(accum.sync())
        for m in ("f1", "pearsonr"):
            assert mt.metric.DeviceMetricAccum.wrap(
                mt.metric.create(m)) is None
    for name, value in host.get_name_value():
        np.testing.assert_allclose(got[name], value, rtol=RTOL)


ALIASES = ["acc", "accuracy", "top_k_acc", "top_k_accuracy", "f1", "mae",
           "mse", "rmse", "ce", "cross-entropy", "pearsonr",
           "pearsoncorrelation", "loss", "torch", "caffe", "perplexity",
           "composite"]


@pytest.mark.parametrize("alias", ALIASES)
def test_create_by_name_and_alias_as_mxtpu(mt, alias):
    kw = {"top_k": 3} if alias.startswith("top_k") else \
        {"ignore_label": None} if alias == "perplexity" else {}
    got = mt.metric.create(alias, **kw)
    want = mx.metric.create(alias, **kw)
    assert type(got).__name__ == type(want).__name__
    assert got.name == want.name


def test_create_of_a_callable_and_a_list(mt):
    got = mt.metric.create(_feval)
    want = mx.metric.create(_feval)
    assert isinstance(got, mt.metric.CustomMetric)
    assert got.name == want.name == "_feval"
    lam = mt.metric.create(lambda l, p: 0.0)
    assert lam.name == "custom(<lambda>)"
    comp = mt.metric.create(["mse", "rmse"])
    assert [type(m).__name__ for m in comp.metrics] == ["MSE", "RMSE"]
