"""Training through the port's Module against mxtpu's, on the CPU.

From the same initial weights (mxtpu's, carried over with
``convert.params_from_mxtpu``) and the same batches:

- mlp and lenet ``fit`` (SGD, 2 epochs, metric [acc, ce] as mxtpu's
  bf16 parity gate reads it): accuracy exact or within 2/256, cross-
  entropy within 1e-2, trained weights within 1e-4 (f32 sums in other
  orders over 8 steps);
- the transformer LM (2 layers, d_model 32, T 16, vocab 20; mxtpu's
  flash forward runs its Pallas kernel in interpret mode at this size)
  after 3 Adam steps of forward_backward/update: weights within 2e-5
  (Adam moves every weight by about lr = 1e-2 a step, whatever its
  gradient's size, so rounding shows up only in its small terms). The
  key projections' biases are held only to |w - w0| <= 3 lr: their exact
  gradient is 0 (adding q.b to every score of a row leaves its softmax
  as it is), so each package's gradient there is rounding noise, which
  Adam scales up to about lr a step.

Also the Executor's gradients (grad_req write/add/null, head gradients),
the fused update against the Updater (equal), the device metric
accumulator, and the knobs the port refuses."""
import logging

import numpy as np
import pytest

import mxtpu as mx


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(2)
    import mxtpu_torch
    return mxtpu_torch


def _quiet():
    log = logging.getLogger("quiet")
    log.setLevel(logging.ERROR)
    return log


def _data(image, n=256, classes=10):
    rng = np.random.RandomState(0)
    x = rng.rand(n, 1, 28, 28) if image else rng.rand(n, 784)
    y = np.random.RandomState(1).randint(0, classes, n)
    return x.astype(np.float32), y.astype(np.float32)


def _mx_init(sym, shapes, seed):
    mod = mx.mod.Module(sym, context=mx.cpu(), logger=_quiet())
    mod.bind(data_shapes=shapes[:1], label_shapes=shapes[1:])
    mx.random.seed(seed)
    mod.init_params(mx.initializer.Xavier())
    args, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in args.items()}


@pytest.mark.parametrize("model", ["mlp", "lenet"])
def test_fit_matches_mxtpu(mt, model):
    image = model == "lenet"
    x, y = _data(image)
    jsym = (mx.models.get_lenet if image else mx.models.get_mlp)(10)
    tsym = (mt.models.get_lenet if image else mt.models.get_mlp)(10)
    w0 = _mx_init(jsym, [("data", (64,) + x.shape[1:]),
                         ("softmax_label", (64,))], seed=3)
    kw = dict(num_epoch=2, optimizer="sgd",
              optimizer_params={"learning_rate": 0.1, "momentum": 0.9})

    jmod = mx.mod.Module(jsym, context=mx.cpu(), logger=_quiet())
    jmetric = mx.metric.create(["acc", "ce"])
    jmod.fit(mx.io.NDArrayIter(x, y, batch_size=64),
             arg_params={k: mx.nd.array(v) for k, v in w0.items()},
             eval_metric=jmetric, **kw)
    want = dict(zip(*jmetric.get()))

    tmod = mt.mod.Module(tsym, context=mt.cpu(), logger=_quiet())
    tmetric = mt.metric.create(["acc", "ce"])
    tmod.fit(mt.io.NDArrayIter(x, y, batch_size=64),
             arg_params=mt.convert.params_from_mxtpu(w0, mt.cpu()),
             eval_metric=tmetric, **kw)
    got = dict(zip(*tmetric.get()))
    assert tmod._fused is not None  # fit ran the fused step

    assert abs(got["accuracy"] - want["accuracy"]) <= 2 / 256.0, (got,
                                                                  want)
    assert abs(got["cross-entropy"] - want["cross-entropy"]) < 1e-2
    jw = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    tw = {k: v.asnumpy() for k, v in tmod.get_params()[0].items()}
    assert sorted(jw) == sorted(tw)
    for k in jw:
        np.testing.assert_allclose(tw[k], jw[k], rtol=0, atol=1e-4,
                                   err_msg=k)
        assert not np.array_equal(tw[k], w0[k])  # it trained


def _lm_batches(n_steps, b=4, t=16, vocab=20):
    rng = np.random.RandomState(5)
    ids = rng.randint(0, vocab, (n_steps, b, t + 1)).astype(np.float32)
    return [(s[:, :-1], s[:, 1:].reshape(-1)) for s in ids]


def test_lm_adam_steps_match_mxtpu(mt):
    cfg = dict(vocab_size=20, seq_len=16, num_layers=2, num_heads=2,
               d_model=32)
    shapes = [("data", (4, 16)), ("softmax_label", (64,))]
    jsym = mx.models.get_transformer_lm(**cfg)
    w0 = _mx_init(jsym, shapes, seed=4)
    batches = _lm_batches(3)
    opt = dict(optimizer="adam", optimizer_params={"learning_rate": 1e-2})

    jmod = mx.mod.Module(jsym, context=mx.cpu(), logger=_quiet())
    jmod.bind(data_shapes=shapes[:1], label_shapes=shapes[1:])
    jmod.init_params(arg_params={k: mx.nd.array(v) for k, v in w0.items()})
    jmod.init_optimizer(**opt)
    tmod = mt.mod.Module(mt.models.get_transformer_lm(**cfg),
                         context=mt.cpu(), logger=_quiet())
    tmod.bind(data_shapes=shapes[:1], label_shapes=shapes[1:])
    tmod.init_params(arg_params=mt.convert.params_from_mxtpu(w0, "cpu"))
    tmod.init_optimizer(**opt)
    for xb, yb in batches:
        jmod.forward_backward(mx.io.DataBatch([mx.nd.array(xb)],
                                              [mx.nd.array(yb)]))
        jmod.update()
        tmod.forward_backward(mt.io.DataBatch(
            [mt.nd.array(xb, ctx=mt.cpu())], [mt.nd.array(yb, ctx=mt.cpu())]))
        tmod.update()
    np.testing.assert_allclose(tmod.get_outputs()[0].asnumpy(),
                               jmod.get_outputs()[0].asnumpy(), rtol=0,
                               atol=1e-5)
    jw = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    tw = {k: v.asnumpy() for k, v in tmod.get_params()[0].items()}
    for k in jw:
        if k.endswith("_k_bias"):
            assert np.abs(tw[k] - w0[k]).max() <= 3 * 1e-2 + 1e-6
            continue
        np.testing.assert_allclose(tw[k], jw[k], rtol=0, atol=2e-5,
                                   err_msg=k)


def test_fused_step_equals_unfused_path(mt):
    """SGD with momentum through the fused update (its rule over every
    parameter in one call) and through the Updater (an SGD subclass,
    which has no fused rule) give the same weights and outputs, whether
    the loop calls forward_backward or forward and backward one by one;
    get_outputs is the executor's own output tensor (no copy)."""
    import torch

    class SGDByUpdater(mt.optimizer.SGD):
        pass

    cfg = dict(vocab_size=20, seq_len=16, num_layers=1, num_heads=2,
               d_model=32)
    batches = _lm_batches(2)
    mods = []
    for fused in (True, False):
        np.random.seed(0)
        mod = mt.mod.Module(mt.models.get_transformer_lm(**cfg),
                            context=mt.cpu(), logger=_quiet())
        mod.bind(data_shapes=[("data", (4, 16))],
                 label_shapes=[("softmax_label", (64,))])
        mod.init_params(mt.init.Xavier())
        params = dict(learning_rate=0.1, momentum=0.9, rescale_grad=0.25)
        mod.init_optimizer(optimizer=mt.optimizer.SGD(**params) if fused
                           else SGDByUpdater(**params))
        assert (mod._fused is not None) == fused
        for i, (xb, yb) in enumerate(batches):
            db = mt.io.DataBatch([mt.nd.array(xb, ctx=mt.cpu())],
                                 [mt.nd.array(yb, ctx=mt.cpu())])
            if i % 2:
                mod.forward(db, is_train=True)
                mod.backward()
            else:
                mod.forward_backward(db)
            mod.update()
        mods.append(mod)
    assert mods[0].get_outputs()[0]._data is mods[0]._exec_group.execs[0].outputs[0]._data
    assert not mods[0]._updater.states
    assert len(mods[1]._updater.states) == len(mods[1]._param_names)
    torch.testing.assert_close(mods[0].get_outputs()[0]._data,
                               mods[1].get_outputs()[0]._data, rtol=0,
                               atol=1e-6)
    w0, w1 = mods[0].get_params()[0], mods[1].get_params()[0]
    for k in w0:
        torch.testing.assert_close(w0[k]._data, w1[k]._data, rtol=0,
                                   atol=1e-6)


def test_executor_gradients_write_add_null(mt):
    import torch
    sym = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=3,
                                name="fc")
    x = mt.nd.array(np.ones((2, 4)), ctx=mt.cpu())
    w = mt.nd.array(np.full((3, 4), 0.5), ctx=mt.cpu())
    b = mt.nd.array(np.zeros(3), ctx=mt.cpu())
    grads = {n: mt.nd.zeros(s, ctx=mt.cpu())
             for n, s in (("fc_weight", (3, 4)), ("fc_bias", (3,)))}
    exe = sym.bind(mt.cpu(), {"data": x, "fc_weight": w, "fc_bias": b},
                   args_grad=grads, grad_req={"fc_weight": "add",
                                              "fc_bias": "write"})
    with pytest.raises(mt.MXNetError, match="forward"):
        exe.backward()
    for _ in range(2):
        exe.forward(is_train=True)
        exe.backward(out_grads=[mt.nd.array(np.full((2, 3), 2.0),
                                            ctx=mt.cpu())])
    torch.testing.assert_close(grads["fc_weight"]._data,
                               torch.full((3, 4), 8.0))  # 2 x (2 x 2)
    torch.testing.assert_close(grads["fc_bias"]._data,
                               torch.full((3,), 4.0))
    out = exe.forward(is_train=False)[0]
    assert not out._data.requires_grad
    assert exe.grad_arrays[1] is grads["fc_weight"]
    with pytest.raises(mt.MXNetError, match="grad_req"):
        sym.bind(mt.cpu(), {"data": x, "fc_weight": w, "fc_bias": b},
                 grad_req="sometimes")


def test_device_metric_accum_syncs_at_the_cadence(mt):
    import torch
    metric = mt.metric.create(["acc", "ce"])
    accum = mt.metric.DeviceMetricAccum.wrap(metric)
    assert accum is not None
    assert mt.metric.DeviceMetricAccum.wrap(
        mt.metric.Perplexity(None)) is None  # numpy path only
    rng = np.random.RandomState(0)
    p = torch.softmax(torch.from_numpy(rng.randn(3, 8, 5)), -1).float()
    y = torch.from_numpy(rng.randint(0, 5, (3, 8))).float()
    ref = mt.metric.create(["acc", "ce"])
    for i in range(3):
        accum.update([y[i]], [p[i]])
        ref.update([y[i]], [p[i]])
    assert accum.syncs == 0 and metric.num_inst == 0  # nothing on host
    snap = accum.sync()
    assert accum.syncs == 1
    for (n1, v1), (n2, v2) in zip(snap, ref.get_name_value()):
        assert n1 == n2 and abs(v1 - v2) < 1e-6


def test_fit_refuses_unported_knobs_and_contexts(mt, tmp_path):
    sym = mt.models.get_mlp(4)
    x, y = np.zeros((8, 5), np.float32), np.zeros(8, np.float32)
    mod = mt.mod.Module(sym, context=mt.cpu(), logger=_quiet())
    # dist_async is ported: with no cluster the store is one worker and
    # the fit trains on the kvstore's updater
    mod.fit(mt.io.NDArrayIter(x, y, batch_size=4), num_epoch=1,
            kvstore="dist_async")
    assert mod._kvstore.type == "dist_async" and mod._update_on_kvstore
    assert mod._kvstore.num_workers == 1 and mod._fused is None
    mod = mt.mod.Module(sym, context=mt.cpu(), logger=_quiet())
    # elastic and resume are ported: the fit snapshots at its epoch end,
    # resume=True needs the prefix that elastic names, and a resumed fit
    # past its last epoch trains no step
    prefix = str(tmp_path / "el")
    mod.fit(mt.io.NDArrayIter(x, y, batch_size=4), num_epoch=1,
            elastic=prefix)
    assert mt.elastic.list_generations(prefix) == [1]
    with pytest.raises(mt.MXNetError, match="needs elastic="):
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=4), num_epoch=1,
                resume=True)
    w = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    mod.fit(mt.io.NDArrayIter(x, y, batch_size=4), num_epoch=1,
            elastic=prefix, resume=True, force_init=True)
    for k, v in mod.get_params()[0].items():
        np.testing.assert_array_equal(v.asnumpy(), w[k], err_msg=k)
    # health is ported: the fit trains with the health session armed
    mod.fit(mt.io.NDArrayIter(x, y, batch_size=4), num_epoch=1,
            health=True)
    assert mod._health_session is not None
    assert mod._health_session.cadences >= 1
    # tuned is ported: an artifact path that cannot be read is refused
    with pytest.raises(mt.MXNetError, match="cannot read"):
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=4), num_epoch=1,
                tuned="t.json")
    # mesh is ported: its default devices are the CUDA devices, so on a
    # host without one it raises naming that, not silently on the CPU
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(mt.MXNetError, match="no CUDA device"):
            mod.fit(mt.io.NDArrayIter(x, y, batch_size=4), num_epoch=1,
                    mesh="all")
    with pytest.raises(mt.MXNetError, match="named twice"):
        mt.mod.Module(sym, context=[mt.cpu(0), mt.cpu(0)])


def test_metric_sync_cadence_and_callbacks(mt, caplog):
    """The cadence is the gcd of the Speedometers' ``frequent``, every
    batch with another callback, epoch end only with none; a fit with a
    Speedometer and log_train_metric logs from the synced snapshot."""
    from mxtpu_torch.module.base_module import _metric_sync
    cb = mt.callback
    assert _metric_sync([cb.Speedometer(8, 4), cb.Speedometer(8, 6)]) == 2
    assert _metric_sync([cb.Speedometer(8, 4), lambda p: None]) == 1
    assert _metric_sync([]) == 0
    x = np.random.RandomState(0).rand(64, 5).astype(np.float32)
    y = (x[:, 0] > 0.5).astype(np.float32)
    mod = mt.mod.Module(mt.models.get_mlp(2), context=mt.cpu(),
                        logger=_quiet())
    with caplog.at_level(logging.INFO):
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=8), num_epoch=1,
                batch_end_callback=[cb.Speedometer(8, 2),
                                    cb.log_train_metric(4)])
    assert "samples/sec" in caplog.text and "Train-accuracy" in caplog.text


def test_fused_step_names_the_indices_it_assigns(mt):
    """An optimizer given as an object carries no index->name map; the
    fused step assigns the indices and maps each to its parameter's name,
    so name-keyed settings (an lr_mult of 0 here) reach the update."""
    x = np.random.RandomState(0).rand(8, 5).astype(np.float32)
    mod = mt.mod.Module(mt.models.get_mlp(3), context=mt.cpu(),
                        logger=_quiet())
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", (8,))])
    mod.init_params(mt.init.Xavier())
    o = mt.optimizer.SGD(learning_rate=0.5)
    o.set_lr_mult({"fc1_weight": 0.0})
    mod.init_optimizer(optimizer=o)
    assert sorted(o.idx2name.values()) == sorted(mod._param_names)
    before = mod.get_params()[0]
    mod.forward_backward(mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())],
                                         [mt.nd.zeros((8,), ctx=mt.cpu())]))
    mod.update()
    after = mod.get_params()[0]
    np.testing.assert_array_equal(after["fc1_weight"].asnumpy(),
                                  before["fc1_weight"].asnumpy())
    assert not np.array_equal(after["fc2_weight"].asnumpy(),
                              before["fc2_weight"].asnumpy())
