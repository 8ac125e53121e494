"""Gluon over several contexts in mxtpu_torch vs mxtpu, on the CPU.

- A Parameter on [cpu(0), cpu(1)]: one copy and one gradient buffer per
  context from one initialization (``list_data``, ``list_grad``,
  ``list_ctx``, ``data(ctx)``, ``grad(ctx)``), each its own tensor;
  ``set_data``, ``zero_grad``, ``reset_ctx``, ``cast`` and a load act on
  every copy; a context named twice raises.
- ``split_and_load`` puts each slice on its context as a copy;
  ``clip_global_norm`` over arrays on both contexts; each against mxtpu.
- The Trainer over 2 contexts with kvstore "device", "local" and None,
  and ``update_on_kvstore`` both ways (``_create_kvstore`` patched in
  both packages to say False): two SGD steps of a Dense net on each
  context's half of the batch, every context's weights within 1e-6 of
  mxtpu's, and ``save_states``/``load_states`` (through the store when
  it updates) resuming bit for bit.

The narrow ResNetV2 over two contexts is in
``test_torch_gluon_multi_resnet.py`` (mxtpu compiles its ops for each
device, ~50 s on its own).
"""
import numpy as np
import pytest

import mxtpu as mx

PKGS = ["mxtpu", "mxtpu_torch"]


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


def _pkg(name, mt):
    return mx if name == "mxtpu" else mt


def test_parameter_on_two_contexts(mt):
    torch = pytest.importorskip("torch")
    ctxs = [mt.cpu(0), mt.cpu(1)]
    p = mt.gluon.Parameter("w", shape=(3, 2))
    p.initialize(mt.init.Uniform(0.5), ctx=ctxs)
    assert p.list_ctx() == ctxs
    d0, d1 = p.list_data()
    assert d0.context == ctxs[0] and d1.context == ctxs[1]
    assert d0._data is not d1._data
    np.testing.assert_array_equal(d0.asnumpy(), d1.asnumpy())
    assert p.data(mt.cpu(1)) is d1 and p.grad(mt.cpu(1)) is p.list_grad()[1]
    with mt.cpu(1):
        assert p.data() is d1
    with pytest.raises(mt.MXNetError, match="not initialized on context"):
        p.data(mt.cpu(2))
    p.set_data(mt.nd.ones((3, 2), ctx=mt.cpu()))
    for d in p.list_data():
        np.testing.assert_array_equal(d.asnumpy(), np.ones((3, 2)))
    for g in p.list_grad():
        g[:] = 2.0
    p.zero_grad()
    for g in p.list_grad():
        assert not g.asnumpy().any()
    held = [d._data for d in p.list_data()]
    p.set_data(np.full((3, 2), 3.0, np.float32))
    assert [d._data for d in p.list_data()] == held  # written in place
    p.reset_ctx([mt.cpu(2), mt.cpu(0), mt.cpu(3)])
    assert p.list_ctx() == [mt.cpu(2), mt.cpu(0), mt.cpu(3)]
    for d in p.list_data():
        np.testing.assert_array_equal(d.asnumpy(), np.full((3, 2), 3.0))
    p.cast("float64")
    assert all(d.dtype == torch.float64 for d in p.list_data())
    assert all(g.dtype == torch.float64 for g in p.list_grad())
    with pytest.raises(mt.MXNetError, match="named twice"):
        mt.gluon.Parameter("v", shape=(2,)).initialize(
            ctx=[mt.cpu(1), mt.cpu(1)])


def test_parameter_lists_match_mxtpu(mt, tmp_path):
    """The same Dense net on two contexts in both packages: the same
    contexts, values on each, and a load writing every copy."""
    got = {}
    for name in PKGS:
        pkg = _pkg(name, mt)
        net = pkg.gluon.nn.Dense(3, in_units=4, prefix="d_")
        net.initialize(pkg.init.Constant(0.25), ctx=[pkg.cpu(0),
                                                     pkg.cpu(1)])
        w = net.weight
        assert [str(c) for c in w.list_ctx()] == ["cpu(0)", "cpu(1)"]
        got[name] = [d.asnumpy() for d in w.list_data()]
    for a, b in zip(got["mxtpu"], got["mxtpu_torch"]):
        np.testing.assert_array_equal(a, b)
    fname = str(tmp_path / "d.params")
    src = mx.gluon.nn.Dense(3, in_units=4, prefix="d_")
    src.initialize(mx.init.Uniform(0.3), ctx=mx.cpu())
    src.save_params(fname)
    net = mt.gluon.nn.Dense(3, in_units=4, prefix="d_")
    net.load_params(fname, ctx=[mt.cpu(0), mt.cpu(1)])
    for d in net.weight.list_data():
        np.testing.assert_array_equal(d.asnumpy(),
                                      src.weight.data().asnumpy())


@pytest.mark.parametrize("name", PKGS)
def test_split_and_load_and_clip_global_norm(mt, name):
    pkg = _pkg(name, mt)
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    with pkg.cpu():
        src = pkg.nd.array(x)
        parts = pkg.gluon.utils.split_and_load(src, [pkg.cpu(0),
                                                     pkg.cpu(1)])
        assert [str(p.context) for p in parts] == ["cpu(0)", "cpu(1)"]
        np.testing.assert_array_equal(parts[0].asnumpy(), x[:3])
        np.testing.assert_array_equal(parts[1].asnumpy(), x[3:])
        if name == "mxtpu_torch":
            assert parts[1]._data.data_ptr() != src._data.data_ptr()
        arrays = [pkg.nd.array(x[:3], ctx=pkg.cpu(0)),
                  pkg.nd.array(x[3:], ctx=pkg.cpu(1))]
        norm = pkg.gluon.utils.clip_global_norm(arrays, 10.0)
    np.testing.assert_allclose(norm, np.sqrt((x ** 2).sum()), rtol=1e-6)
    scale = 10.0 / (np.sqrt((x ** 2).sum()) + 1e-8)
    np.testing.assert_allclose(np.concatenate([a.asnumpy() for a in arrays]),
                               x * scale, rtol=1e-6)


def _dense_run(pkg, kvstore, update_on_kvstore, steps=2, states=None):
    """Two SGD steps of a 2-layer Dense net on [cpu(0), cpu(1)], each
    context on its half of a batch of 8: every context's weights."""
    rng = np.random.RandomState(8)
    x = rng.randn(steps, 8, 5).astype(np.float32)
    y = rng.randint(0, 3, (steps, 8)).astype(np.float32)
    ctxs = [pkg.cpu(0), pkg.cpu(1)]
    net = pkg.gluon.nn.Sequential(prefix="net_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(6, in_units=5, activation="tanh"))
        net.add(pkg.gluon.nn.Dense(3, in_units=6))
    net.initialize(pkg.init.Xavier(), ctx=ctxs)
    w0 = np.random.RandomState(9)
    for p in net.collect_params().values():
        p.set_data(pkg.nd.array(w0.randn(*p.shape).astype(np.float32) * 0.4,
                                ctx=pkg.cpu()))
    kw = {"learning_rate": 0.1, "momentum": 0.9}
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd", kw,
                                kvstore=kvstore)
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    for i in range(steps):
        if i == 1 and states is not None:
            trainer.save_states(states)
            trainer.load_states(states)
        xs = pkg.gluon.utils.split_and_load(pkg.nd.array(x[i],
                                                         ctx=pkg.cpu()), ctxs)
        ys = pkg.gluon.utils.split_and_load(pkg.nd.array(y[i],
                                                         ctx=pkg.cpu()), ctxs)
        with pkg.autograd.record():
            losses = [loss_fn(net(a), b) for a, b in zip(xs, ys)]
        pkg.autograd.backward(losses)
        trainer.step(8)
    return {k: [d.asnumpy() for d in p.list_data()]
            for k, p in net.collect_params().items()}


@pytest.mark.parametrize("kvstore,update_on_kvstore",
                         [("device", True), ("device", False),
                          ("local", True), ("local", False), (None, False)])
def test_trainer_over_two_contexts_matches_mxtpu(mt, kvstore,
                                                 update_on_kvstore,
                                                 tmp_path):
    from mxtpu.gluon import trainer as jtrainer
    from mxtpu_torch.gluon import trainer as ttrainer
    got = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, mod in (("mxtpu", jtrainer), ("mxtpu_torch", ttrainer)):
            real = mod._create_kvstore

            def decide(kv, n, params, real=real):
                store, _ = real(kv, n, params)
                return store, update_on_kvstore and store is not None

            mp.setattr(mod, "_create_kvstore", decide)
            got[name] = _dense_run(_pkg(name, mt), kvstore,
                                   update_on_kvstore)
        resumed = _dense_run(mt, kvstore, update_on_kvstore,
                             states=str(tmp_path / "t.states"))
    for k in got["mxtpu"]:
        for a, b, c in zip(got["mxtpu"][k], got["mxtpu_torch"][k],
                           resumed[k]):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6, err_msg=k)
            if kvstore is not None:
                np.testing.assert_array_equal(c, b, err_msg=k)
    # with no store each context trains on its own half, its momentum its
    # own, and a states file (the first Updater's, as mxtpu writes it)
    # restores the first context's momentum on both
    same = all(np.array_equal(*v) for v in got["mxtpu_torch"].values())
    assert same == (kvstore is not None)
