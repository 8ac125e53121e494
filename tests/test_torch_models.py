"""The image-classification zoo in mxtpu_torch vs mxtpu.

- Each copied symbol factory builds the graph mxtpu's builds for the same
  arguments (ops, attrs, wiring and variable names) and infers the same
  shapes.
- Served forward parity: weights carried by ``convert.params_from_mxtpu``
  with random, non-trivial BatchNorm statistics, requests through
  ``ServingSession(contexts=[cpu()])`` against ``mxtpu.predict.Predictor``
  on each request alone, atol 1e-5 on the probabilities. The port runs
  each BatchNorm->ReLU pair through the epilogue's plain version, which
  rounds as ``x*scale+shift`` where mxtpu's BatchNorm rounds as
  ``(x-mean)*(g*inv)+beta``; the tolerance covers that.
- The executor's count of fused BatchNorm->ReLU sites on each model, and
  which BatchNorms it leaves alone.
"""
import json

import numpy as np
import pytest

import mxtpu as mx

ATOL = 1e-5


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


def _graph(js):
    """Ops, attrs and wiring of a symbol JSON (auto-generated op names
    depend on each process's name counters, so they are left out)."""
    nodes = json.loads(js)["nodes"]
    return [(n["op"], n["name"] if n["op"] == "null" else None,
             n.get("attrs"), n["inputs"]) for n in nodes]


IMAGENET = (3, 224, 224)
FACTORIES = [
    ("resnet", dict(num_classes=1000, num_layers=50, image_shape=IMAGENET),
     IMAGENET),
    ("resnet", dict(num_classes=1000, num_layers=18, image_shape=IMAGENET),
     IMAGENET),
    ("resnet", dict(num_classes=10, num_layers=8, image_shape=(3, 28, 28)),
     (3, 28, 28)),
    ("resnet", dict(num_classes=10, num_layers=164,
                    image_shape=(3, 28, 28)), (3, 28, 28)),
    ("resnet_v1", dict(num_classes=1000, num_layers=50), IMAGENET),
    ("resnet_v1", dict(num_classes=10, num_layers=20,
                       image_shape=(3, 32, 32)), (3, 32, 32)),
    ("resnext", dict(num_classes=1000, num_layers=50), IMAGENET),
    ("resnext", dict(num_classes=10, num_layers=29,
                     image_shape=(3, 32, 32), num_group=8), (3, 32, 32)),
    ("mobilenet", dict(num_classes=1000), IMAGENET),
    ("mobilenet", dict(num_classes=10, multiplier=0.25), (3, 64, 64)),
    ("inception_bn", dict(num_classes=1000), IMAGENET),
    ("resnet_v1", dict(num_classes=1000, num_layers=18), IMAGENET),
    ("resnext", dict(num_classes=1000, num_layers=101), IMAGENET),
    ("vgg", dict(num_classes=1000, num_layers=19, batch_norm=True),
     IMAGENET),
    ("vgg", dict(num_classes=1000, num_layers=16), IMAGENET),
    ("vgg", dict(num_classes=100, num_layers=11, batch_norm=True),
     IMAGENET),
    ("alexnet", dict(num_classes=1000), IMAGENET),
    ("lenet", dict(num_classes=10), (1, 28, 28)),
    ("mlp", dict(num_classes=10), (784,)),
    ("googlenet", dict(num_classes=1000), IMAGENET),
    ("inception_v3", dict(num_classes=1000), (3, 299, 299)),
    ("inception_v4", dict(num_classes=1000), (3, 299, 299)),
    ("inception_resnet_v2", dict(num_classes=1000), (3, 299, 299)),
    ("googlenet", dict(num_classes=10), (3, 96, 96)),
]
FACTORY_IDS = ["%s-%d" % (f[0], i) for i, f in enumerate(FACTORIES)]


@pytest.mark.parametrize("name,kw,shape", FACTORIES, ids=FACTORY_IDS)
def test_port_factory_builds_the_mxtpu_graph(mt, name, kw, shape):
    jsym = getattr(mx.models, name).get_symbol(**kw)
    tsym = getattr(mt.models, name).get_symbol(**kw)
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_auxiliary_states() == jsym.list_auxiliary_states()
    assert tsym.list_outputs() == jsym.list_outputs()
    assert _graph(tsym.tojson()) == _graph(jsym.tojson())
    loaded = mt.symbol.load_json(jsym.tojson())
    assert _graph(loaded.tojson()) == _graph(jsym.tojson())
    data = (2,) + shape
    got = loaded.infer_shape(data=data)
    want = jsym.infer_shape(data=data)
    assert [list(map(tuple, x)) for x in got] == \
        [list(map(tuple, x)) for x in want]


# expected fused BatchNorm->ReLU sites, counted by hand from the factories
SITES = [
    ("resnet", dict(num_layers=50), 50),           # bn0 + 3 x 16 units + bn1
    ("resnet", dict(num_layers=18), 18),           # bn0 + 2 x 8 units + bn1
    ("resnet_v1", dict(num_layers=50), 33),        # bn0 + 2 x 16 units
    ("resnext", dict(num_layers=50), 33),          # bn0 + 2 x 16 units
    ("mobilenet", dict(), 27),                     # conv1 + 2 x 13 blocks
    ("vgg", dict(num_layers=16, batch_norm=True), 13),
    ("vgg", dict(num_layers=16), 0),
    ("googlenet", dict(), 0),                      # no BatchNorm
    ("inception_v3", dict(), 94),                  # every BN but the aux
    ("inception_v4", dict(), 149),
    ("inception_resnet_v2", dict(), 204),
]


@pytest.mark.parametrize("name,kw,sites", SITES,
                         ids=["%s-%d" % (s[0], s[2]) for s in SITES])
def test_fused_site_count_of_the_zoo(mt, name, kw, sites):
    from mxtpu_torch.executor import _trace_graph
    sym = getattr(mt.models, name).get_symbol(num_classes=1000, **kw)
    assert _trace_graph(sym, is_train=False).fused_sites == sites


def test_inception_bn_fuses_every_conv_factory(mt):
    from mxtpu_torch.executor import _trace_graph
    sym = mt.models.inception_bn.get_symbol(num_classes=1000)
    n_bn = sum(1 for n in sym._topo() if not n.is_variable
               and n.op.name == "BatchNorm")
    assert n_bn > 50
    assert _trace_graph(sym, is_train=False).fused_sites == n_bn


def test_only_a_bn_with_one_relu_consumer_fuses(mt):
    """Fused: bn_ok. Not fused: a BN that is a graph output, a BN read by
    two ops, a BN before a non-ReLU activation, a BN with
    output_mean_var; and nothing in training mode."""
    from mxtpu_torch.executor import _trace_graph
    sym = mt.sym
    ok = sym.Activation(sym.BatchNorm(sym.Variable("data"), name="bn_ok"),
                        act_type="relu")
    out = sym.BatchNorm(ok, name="bn_out")
    shared = sym.BatchNorm(ok, name="bn_shared")
    tanh = sym.Activation(sym.BatchNorm(ok, name="bn_tanh"),
                          act_type="tanh")
    mv = sym.BatchNorm(ok, output_mean_var=True, name="bn_mv")
    g = sym.Group([out, sym.Activation(out, act_type="relu"),
                   sym.Activation(shared, act_type="relu") + shared, tanh,
                   mv])
    assert _trace_graph(g, is_train=False).fused_sites == 1
    assert _trace_graph(g, is_train=True).fused_sites == 0


def _params(sym, shape, seed):
    """He-scaled weights and random, non-trivial BN parameters and
    statistics (numpy, mxtpu's checkpoint naming)."""
    rng = np.random.RandomState(seed)
    args, _, aux = sym.infer_shape(data=shape)
    params = {}
    for n, s in zip(sym.list_arguments(), args):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_gamma"):
            v = rng.uniform(0.5, 1.5, s)
        elif n.endswith(("_beta", "_bias")):
            v = rng.uniform(-0.1, 0.1, s)
        else:
            v = rng.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))
        params["arg:" + n] = v.astype(np.float32)
    for n, s in zip(sym.list_auxiliary_states(), aux):
        v = rng.randn(*s) * 0.1 if n.endswith("_moving_mean") else \
            rng.uniform(0.5, 1.5, s)
        params["aux:" + n] = v.astype(np.float32)
    return params


def _tiny_resnet(mod, image_shape):
    return mod.resnet.resnet(units=[1, 1, 1, 1], num_stages=4,
                             filter_list=[8, 16, 32, 64, 128],
                             num_classes=10, image_shape=image_shape)


def _tiny_resnext(mod, image_shape):
    return mod.resnext.resnext(units=[1, 1, 1], num_stages=3,
                               filter_list=[8, 32, 64, 128], num_classes=10,
                               image_shape=image_shape, num_group=4)


SERVED = [
    # (id, build(models module) -> symbol, per-request shape, sites)
    ("mlp", lambda m: m.mlp.get_symbol(num_classes=10), (1, 784), 0),
    ("lenet", lambda m: m.lenet.get_symbol(num_classes=10), (1, 1, 28, 28),
     0),
    ("resnet8-fixture", lambda m: m.resnet.get_symbol(
        num_classes=10, num_layers=8, image_shape=(3, 28, 28)),
     (1, 3, 28, 28), 7),
    ("resnet-small-stem", lambda m: _tiny_resnet(m, (3, 32, 32)),
     (1, 3, 32, 32), 13),
    ("resnet-imagenet-stem", lambda m: _tiny_resnet(m, (3, 64, 64)),
     (1, 3, 64, 64), 14),
    ("resnext-groups", lambda m: _tiny_resnext(m, (3, 28, 28)),
     (1, 3, 28, 28), 6),
]


@pytest.mark.parametrize("build,shape,sites", [s[1:] for s in SERVED],
                         ids=[s[0] for s in SERVED])
def test_served_model_matches_mxtpu_predictor(mt, build, shape, sites):
    jsym = build(mx.models)
    js = build(mt.models).tojson()
    assert _graph(js) == _graph(jsym.tojson())
    params = _params(jsym, shape, seed=sites + 3)
    ref = mx.predict.Predictor(jsym.tojson(),
                               {k: mx.nd.array(v) for k, v in params.items()},
                               ctx=mx.cpu(), input_shapes={"data": shape})
    rng = np.random.RandomState(5)
    reqs = [rng.randn(*shape).astype(np.float32) for _ in range(3)]
    with mt.serving.ServingSession(
            js, mt.convert.params_from_mxtpu(params, mt.cpu()),
            {"data": shape}, buckets=(1, 4), contexts=[mt.cpu()],
            max_delay_ms=20.0) as sess:
        answers = [f.wait(120)[0] for f in
                   [sess.predict_async({"data": r}) for r in reqs]]
        ex = sess.pool.replicas[0].base._executor
        assert ex.fused_sites == sites
    for r, got in zip(reqs, answers):
        ref.forward(data=r)
        want = ref.get_output(0)
        assert got.shape == want.shape == (1, 10)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_executor_routes_each_fused_site_through_the_epilogue(mt,
                                                              monkeypatch):
    """One epilogue call per fused site per forward: what chip_smoke.py
    checks on the card with the kernel's launch count."""
    from mxtpu_torch.ops import nn as tnn
    calls = []
    real = tnn.bn_apply_relu_add

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(tnn, "bn_apply_relu_add", counting)
    sym = _tiny_resnet(mt.models, (3, 64, 64))
    params = _params(sym, (2, 3, 64, 64), seed=1)
    pred = mt.Predictor(sym.tojson(), params, ctx=mt.cpu(),
                        input_shapes={"data": (2, 3, 64, 64)})
    assert calls == [] and pred._executor.fused_sites == 14
    pred.forward(data=np.ones((2, 3, 64, 64), np.float32))
    pred.forward(data=np.zeros((2, 3, 64, 64), np.float32))
    assert len(calls) == 2 * 14
    assert calls[0] == (2, 8, 32, 32) and calls[13] == (2, 128, 2, 2)


def test_serving_fixtures_match_mxtpu(mt):
    for name in sorted(mx.models.serving_fixtures.FIXTURES):
        js, params, shapes = mt.models.get_serving_fixture(name, seed=3)
        jjs, jparams, jshapes = mx.models.get_serving_fixture(name, seed=3)
        assert _graph(js) == _graph(jjs) and shapes == jshapes
        assert sorted(params) == sorted(jparams)
        for k, v in jparams.items():
            assert np.array_equal(params[k], v.asnumpy()), k
