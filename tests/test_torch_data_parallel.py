"""Module over several contexts in mxtpu_torch vs mxtpu, on the CPU.

``cpu(0)`` and ``cpu(1)`` are distinct contexts on the one host device in
the port, as they are distinct XLA host devices in mxtpu (the reference's
own trick for testing multi-device paths).

- The two multi-context semantics of mxtpu, on a BatchNorm ->
  FullyConnected -> SoftmaxOutput net whose batch halves have means 20
  apart: the fused step (the default) normalizes by the whole batch's
  statistics; the legacy executor group (reached by an uneven
  ``work_load_list`` and by ``inputs_need_grad``) by each context's
  rows, its moving statistics averaged on the host at each epoch end.
  Moving statistics within 1e-5 relative and weights within 1e-5 of
  mxtpu's on each path.
- The gradient over replicas: a 2-context fused step equals a 1-context
  step on the whole batch within 1e-6 (a non-differentiable cross-device
  sum would drop the cross-replica terms of BatchNorm's gradient; the
  forward would still agree).
- resnet-8 over 2 contexts, 2 SGD steps from mxtpu's weights: weights and
  statistics within 1e-4 of mxtpu's 2-context run (PR 6's tolerance),
  the first step within 1e-6 of the float64 step of the whole batch; the
  replicas bit-identical after 3 steps.
- mxtpu's ``test_module_multi_device`` as a twin, a repeated context
  raising, and a 2-context checkpoint that loads bit for bit into mxtpu
  and into a 1-context port Module.
"""
import logging

import numpy as np
import pytest

import mxtpu as mx


@pytest.fixture(scope="module")
def tt():
    import torch
    torch.set_num_threads(2)
    import mxtpu_torch
    return torch, mxtpu_torch


def _quiet():
    log = logging.getLogger("quiet")
    log.setLevel(logging.ERROR)
    return log


# ---------------------------------------------------------------- BN net
def _bn_data():
    rng = np.random.RandomState(0)
    x = (rng.randn(8, 4) * 3).astype(np.float32)
    x[4:] += 20.0  # the halves' means 20 apart
    y = rng.randint(0, 3, 8).astype(np.float32)
    return x, y


BN_W0 = {"bn_gamma": np.full(4, 1.5, np.float32),
         "bn_beta": np.full(4, 0.1, np.float32),
         "fc_weight": (np.random.RandomState(3).randn(3, 4) * 0.3)
         .astype(np.float32),
         "fc_bias": np.zeros(3, np.float32)}


def _bn_net(pkg):
    s = pkg.sym
    h = s.BatchNorm(s.Variable("data"), name="bn", fix_gamma=False)
    h = s.FullyConnected(h, num_hidden=3, name="fc")
    return s.SoftmaxOutput(h, name="softmax")


def _bn_fit(pkg, contexts, path, num_epoch=3, batch=8):
    """Fit the BN net through ``pkg``; returns (weights, statistics,
    module) as numpy dicts."""
    x, y = _bn_data()
    mod = pkg.mod.Module(_bn_net(pkg), context=contexts, logger=_quiet(),
                         work_load_list=[1, 1.0000001]
                         if path == "uneven" else None)
    it = pkg.io.NDArrayIter(x, y, batch_size=batch)
    if path == "inputs_need_grad":
        mod.bind(it.provide_data, it.provide_label, inputs_need_grad=True)
    mod.fit(it, num_epoch=num_epoch, kvstore="device", optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                        for k, v in BN_W0.items()})
    w, a = [{k: v.asnumpy() for k, v in d.items()}
            for d in mod.get_params()]
    return w, a, mod


@pytest.mark.parametrize("path", ["fused", "uneven", "inputs_need_grad"])
def test_batchnorm_over_two_contexts_matches_mxtpu(tt, path):
    """Each path's moving statistics within 1e-5 relative of mxtpu's and
    its weights within 1e-5; the fused path normalizes by the whole
    batch (variance ~100 from the halves' means), the legacy paths by
    each half (variance ~9)."""
    _, mt = tt
    jw, ja, _ = _bn_fit(mx, [mx.cpu(0), mx.cpu(1)], path)
    tw, ta, tmod = _bn_fit(mt, [mt.cpu(0), mt.cpu(1)], path)
    assert (tmod._fused is not None) == (path == "fused")
    for k in ja:
        np.testing.assert_allclose(ta[k], ja[k], rtol=1e-5, atol=0,
                                   err_msg=k)
    for k in jw:
        np.testing.assert_allclose(tw[k], jw[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    var = ta["bn_moving_var"]
    if path == "fused":
        assert var.min() > 10.0
    else:
        assert var.max() < 10.0


def test_two_context_fused_step_is_the_whole_batch_step(tt):
    """The gradient through the replica walk: 2 contexts fused equal 1
    context on the whole batch (weights and statistics within 1e-6),
    where the per-context path does not."""
    _, mt = tt
    one = _bn_fit(mt, [mt.cpu(0)], "fused")
    two = _bn_fit(mt, [mt.cpu(0), mt.cpu(1)], "fused")
    legacy = _bn_fit(mt, [mt.cpu(0), mt.cpu(1)], "uneven")
    for k in one[0]:
        np.testing.assert_allclose(two[0][k], one[0][k], atol=1e-6,
                                   rtol=0, err_msg=k)
    for k in one[1]:
        np.testing.assert_allclose(two[1][k], one[1][k], atol=1e-6,
                                   rtol=1e-6, err_msg=k)
    assert max(np.abs(legacy[0][k] - one[0][k]).max()
               for k in one[0]) > 1e-3


def test_normalized_loss_divides_by_the_whole_batch(tt):
    """SoftmaxOutput with normalization "batch" and "valid" over 2
    contexts equals 1 context on the whole batch (weights within 1e-6)."""
    _, mt = tt
    x, y = _bn_data()
    y[1] = y[6] = -1.0  # ignored rows, both halves

    def run(contexts, norm):
        s = mt.sym
        h = s.FullyConnected(s.Variable("data"), num_hidden=3, name="fc")
        net = s.SoftmaxOutput(h, name="softmax", normalization=norm,
                              use_ignore=True, ignore_label=-1)
        mod = mt.mod.Module(net, context=contexts, logger=_quiet())
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=8), num_epoch=2,
                optimizer="sgd", optimizer_params={
                    "learning_rate": 0.1, "rescale_grad": 1.0},
                arg_params={k: mt.nd.array(BN_W0[k], ctx=mt.cpu())
                            for k in ("fc_weight", "fc_bias")})
        return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}

    for norm in ("batch", "valid"):
        one = run([mt.cpu(0)], norm)
        two = run([mt.cpu(0), mt.cpu(1)], norm)
        for k in one:
            np.testing.assert_allclose(two[k], one[k], atol=1e-6, rtol=0,
                                       err_msg=(norm, k))


def test_an_op_that_couples_rows_without_a_group_form_raises(tt):
    """A graph reducing over the batch axis cannot train as one batch
    over several contexts: the fused multi-context step refuses it."""
    _, mt = tt
    s = mt.sym
    h = s.FullyConnected(s.Variable("data"), num_hidden=3, name="fc")
    h = s.broadcast_sub(h, s.mean(h, axis=0, keepdims=True))
    net = s.SoftmaxOutput(h, name="softmax")
    x, y = _bn_data()
    mod = mt.mod.Module(net, context=[mt.cpu(0), mt.cpu(1)],
                        logger=_quiet())
    with pytest.raises(mt.MXNetError, match="couples rows"):
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=8), num_epoch=1)


# ---------------------------------------------------------------- resnet-8
RESNET8 = (10, 8, (3, 28, 28))
SGD = dict(optimizer="sgd",
           optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                             "rescale_grad": 1.0 / 32})


def _resnet8_data(n):
    x = np.random.RandomState(0).rand(n, 3, 28, 28).astype(np.float32)
    y = np.random.RandomState(1).randint(0, 10, n).astype(np.float32)
    return x, y


@pytest.fixture(scope="module")
def resnet8_start():
    """mxtpu's Xavier weights for resnet-8 and moving statistics moved off
    their initial values, as numpy."""
    init = mx.mod.Module(mx.models.resnet.get_symbol(*RESNET8),
                         context=mx.cpu(), logger=_quiet())
    init.bind(data_shapes=[("data", (32, 3, 28, 28))],
              label_shapes=[("softmax_label", (32,))])
    mx.random.seed(4)
    init.init_params(mx.initializer.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2))
    w0, a0 = [{k: v.asnumpy() for k, v in d.items()}
              for d in init.get_params()]
    a0 = {k: (v + 0.1 if k.endswith("_moving_mean") else v * 1.5)
          for k, v in a0.items()}
    return w0, a0


def _float64_step(tt, w0, a0, xb, yb):
    """One SGD step (momentum from zero) of the whole batch through the
    port's executor in float64: the exact step, as numpy."""
    torch, mt = tt
    sym = mt.models.get_resnet(*RESNET8)

    def f64(v):
        return mt.nd.NDArray(torch.from_numpy(np.array(v, np.float64)),
                             mt.cpu())

    args = {k: f64(v) for k, v in w0.items()}
    args["data"], args["softmax_label"] = f64(xb), f64(yb)
    aux = {k: f64(v) for k, v in a0.items()}
    grads = {k: f64(np.zeros_like(v)) for k, v in w0.items()}
    exe = sym.bind(mt.cpu(), args, args_grad=grads, aux_states=aux)
    exe.forward(is_train=True)
    exe.backward()
    p = SGD["optimizer_params"]
    lr, rescale = p["learning_rate"], p["rescale_grad"]
    return ({k: (args[k]._data - lr * rescale * grads[k]._data).numpy()
             for k in w0}, {k: v._data.numpy() for k, v in aux.items()})


def _dist(a, b):
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


def _resnet8_modules(tt, w0, a0):
    torch, mt = tt
    shapes = [("data", (32, 3, 28, 28)), ("softmax_label", (32,))]
    jmod = mx.mod.Module(mx.models.resnet.get_symbol(*RESNET8),
                         context=[mx.cpu(0), mx.cpu(1)], logger=_quiet())
    jmod.bind(data_shapes=shapes[:1], label_shapes=shapes[1:])
    jmod.init_params(arg_params={k: mx.nd.array(v) for k, v in w0.items()},
                     aux_params={k: mx.nd.array(v) for k, v in a0.items()})
    jmod.init_optimizer(kvstore="device", **SGD)
    tmod = mt.mod.Module(mt.models.get_resnet(*RESNET8),
                         context=[mt.cpu(0), mt.cpu(1)], logger=_quiet())
    tmod.bind(data_shapes=shapes[:1], label_shapes=shapes[1:])
    tmod.init_params(arg_params=mt.convert.params_from_mxtpu(w0, "cpu"),
                     aux_params=mt.convert.params_from_mxtpu(a0, "cpu"))
    tmod.init_optimizer(kvstore="device", **SGD)
    return jmod, tmod


def test_resnet8_over_two_contexts_matches_mxtpu_and_float64(
        tt, resnet8_start):
    """Two fused steps over [cpu(0), cpu(1)]: weights and statistics
    within 1e-4 of mxtpu's after each; the first within 1e-6 of the
    float64 step of the whole batch and no farther from it than
    mxtpu's."""
    _, mt = tt
    w0, a0 = resnet8_start
    x, y = _resnet8_data(64)
    jmod, tmod = _resnet8_modules(tt, w0, a0)
    assert tmod._fused is not None
    for step, i in enumerate((0, 32)):
        xb, yb = x[i:i + 32], y[i:i + 32]
        jmod.forward_backward(mx.io.DataBatch([mx.nd.array(xb)],
                                              [mx.nd.array(yb)]))
        jmod.update()
        tmod.forward_backward(mt.io.DataBatch(
            [mt.nd.array(xb, ctx=mt.cpu())], [mt.nd.array(yb, ctx=mt.cpu())]))
        tmod.update()
        jw, ja = [{k: v.asnumpy() for k, v in d.items()}
                  for d in jmod.get_params()]
        tw, ta = [{k: v.asnumpy() for k, v in d.items()}
                  for d in tmod.get_params()]
        assert _dist(tw, jw) <= 1e-4, step
        assert _dist(ta, ja) <= 1e-4, step
        if step == 0:
            ew, ea = _float64_step(tt, w0, a0, xb, yb)
            assert _dist(tw, ew) <= 1e-6
            assert _dist(ta, ea) <= 1e-6
            assert _dist(tw, ew) <= _dist(jw, ew)
            assert _dist(tw, w0) > 1e-4  # it moved


def test_replicas_stay_bit_identical(tt, resnet8_start):
    """After 3 fused steps the two replicas' weights, momenta and moving
    statistics are the same bits: every replica updates from one sum."""
    torch, mt = tt
    w0, a0 = resnet8_start
    x, y = _resnet8_data(96)
    _, tmod = _resnet8_modules(tt, w0, a0)
    for i in (0, 32, 64):
        tmod.forward_backward(mt.io.DataBatch(
            [mt.nd.array(x[i:i + 32], ctx=mt.cpu())],
            [mt.nd.array(y[i:i + 32], ctx=mt.cpu())]))
        tmod.update()
    e0, e1 = tmod._exec_group.execs
    for k in w0:
        assert torch.equal(e0.arg_dict[k]._data, e1.arg_dict[k]._data), k
        assert torch.equal(tmod._fused.opt_state[0][k],
                           tmod._fused.opt_state[1][k]), k
    for k in a0:
        assert torch.equal(e0.aux_dict[k]._data, e1.aux_dict[k]._data), k
        assert not np.array_equal(e0.aux_dict[k].asnumpy(), a0[k])


# ---------------------------------------------------------------- twins
def _toy_data(n=512, dim=16, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(classes, dim) * 3
    y = rng.randint(0, classes, n)
    x = (centers[y] + rng.randn(n, dim)).astype("float32")
    return x, y.astype("float32")


def _mlp(pkg, classes=4):
    s = pkg.sym
    net = s.FullyConnected(s.Variable("data"), num_hidden=32, name="fc1")
    net = s.Activation(net, act_type="relu")
    net = s.FullyConnected(net, num_hidden=classes, name="fc2")
    return s.SoftmaxOutput(net, name="softmax")


@pytest.mark.parametrize("pkg_name", ["mxtpu", "mxtpu_torch"])
def test_module_multi_device(tt, pkg_name):
    """mxtpu's tests/test_module.py::test_module_multi_device, one body
    through both packages: an mlp over [cpu(0), cpu(1)] with the local
    kvstore reaches accuracy > 0.85."""
    pkg = mx if pkg_name == "mxtpu" else tt[1]
    pkg.random.seed(7)
    np.random.seed(7)
    x, y = _toy_data()
    train = pkg.io.NDArrayIter(x, y, batch_size=32, shuffle=True)
    mod = pkg.mod.Module(_mlp(pkg), context=[pkg.cpu(0), pkg.cpu(1)],
                         logger=_quiet())
    mod.fit(train, num_epoch=10, kvstore="local",
            optimizer_params={"learning_rate": 0.5, "momentum": 0.9},
            initializer=pkg.initializer.Xavier())
    score = mod.score(pkg.io.NDArrayIter(x, y, batch_size=32), "acc")
    assert score[0][1] > 0.85, "multi-device accuracy %f" % score[0][1]


def test_a_repeated_context_raises(tt):
    _, mt = tt
    with pytest.raises(mt.MXNetError, match="cpu\\(1\\) is named twice"):
        mt.mod.Module(_mlp(mt), context=[mt.cpu(0), mt.cpu(1), mt.cpu(1)])
    with pytest.raises(mt.MXNetError, match="named twice"):
        mt.context.context_list([mt.cpu(), mt.cpu(0)])
    assert mt.context.context_list(mt.cpu(1)) == [mt.cpu(1)]


def test_two_context_checkpoint_loads_in_mxtpu_and_one_context(
        tt, tmp_path):
    """A checkpoint of a 2-context fit (legacy path: its statistics are
    the contexts' average) loads bit for bit into mxtpu's Module and
    into a 1-context port Module."""
    _, mt = tt
    _, _, tmod = _bn_fit(mt, [mt.cpu(0), mt.cpu(1)], "uneven")
    prefix = str(tmp_path / "bn")
    tmod.save_checkpoint(prefix, 3)
    w, a = [{k: v.asnumpy() for k, v in d.items()}
            for d in tmod.get_params()]
    shapes = dict(data_shapes=[("data", (8, 4))],
                  label_shapes=[("softmax_label", (8,))])
    jmod = mx.mod.Module.load(prefix, 3, context=mx.cpu(), logger=_quiet())
    jmod.bind(**shapes)
    one = mt.mod.Module.load(prefix, 3, context=mt.cpu(), logger=_quiet())
    one.bind(**shapes)
    for mod in (jmod, one):
        gw, ga = [{k: v.asnumpy() for k, v in d.items()}
                  for d in mod.get_params()]
        assert sorted(gw) == sorted(w) and sorted(ga) == sorted(a)
        for k in w:
            np.testing.assert_array_equal(gw[k], w[k], err_msg=k)
        for k in a:
            np.testing.assert_array_equal(ga[k], a[k], err_msg=k)
