"""The port's Monitor against mxtpu's, twins of tests/test_monitor.py:34,
54, 73 and 121 run by one body through both packages from the same
numpy-seeded weights and batches: stats collected while training (names
and values; the values within 1e-5 relative, f32 in other summation
orders), interval and pattern, ``toc(sort=True)`` and its clean
deactivation when ``stat_func`` raises, ``fit(monitor=)``. Then the
port's fused/unfused rule: a sampled inference batch walks the graph
unfused, so the BatchNorm outputs are seen (mxtpu's per-op walk names
them too), and an unsampled one keeps the fused BatchNorm->ReLU step;
``install_monitor`` of a Monitor with its own ``stat_func`` disarms the
fused update and still trains to the same weights; a rebind (a new batch
shape) keeps the monitor. The default statistic takes the device adapter
in both packages (the first four twins hold the two adapters' stats);
the adapter cases at the end hold its taps to the per-op path."""
import logging

import numpy as np
import pytest

import mxtpu as mx


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


def _quiet():
    log = logging.getLogger("test_torch_monitor")
    log.setLevel(logging.ERROR)
    return log


def _mlp(pk):
    net = pk.sym.FullyConnected(pk.sym.Variable("data"), num_hidden=16,
                                name="fc1")
    net = pk.sym.Activation(net, act_type="relu", name="relu1")
    net = pk.sym.FullyConnected(net, num_hidden=3, name="fc2")
    return pk.sym.SoftmaxOutput(net, name="softmax")


def _bn_net(pk):
    net = pk.sym.Convolution(pk.sym.Variable("data"), num_filter=4,
                             kernel=(3, 3), pad=(1, 1), name="conv0")
    net = pk.sym.BatchNorm(net, name="bn0")
    net = pk.sym.Activation(net, act_type="relu", name="relu0")
    net = pk.sym.FullyConnected(pk.sym.Flatten(net, name="flat"),
                                num_hidden=3, name="fc")
    return pk.sym.SoftmaxOutput(net, name="softmax")


def _params(sym, shapes, seed=0):
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args = {n: rng.randn(*s).astype(np.float32) * 0.3
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}
    aux = {n: rng.rand(*s).astype(np.float32) + 0.5
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _module(pk, net=_mlp, data=(16, 8), lr=0.1):
    sym = net(pk)
    ctx = {"context": pk.cpu()} if pk is not mx else {}
    mod = pk.mod.Module(sym, logger=_quiet(), **ctx)
    shapes = {"data": data, "softmax_label": (data[0],)}
    mod.bind(data_shapes=[("data", data)],
             label_shapes=[("softmax_label", (data[0],))])
    args, aux = _params(sym, shapes)
    mod.init_params(arg_params={k: pk.nd.array(v, ctx=pk.cpu())
                                for k, v in args.items()},
                    aux_params={k: pk.nd.array(v, ctx=pk.cpu())
                                for k, v in aux.items()})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": lr})
    return mod


def _batch(pk, data=(16, 8), classes=3, seed=0):
    rng = np.random.RandomState(seed)
    return pk.io.DataBatch(
        data=[pk.nd.array(rng.randn(*data).astype("float32"),
                          ctx=pk.cpu())],
        label=[pk.nd.array(rng.randint(0, classes, (data[0],))
                           .astype("float32"), ctx=pk.cpu())])


def _train_monitored(pk, mon, steps=1, net=_mlp, data=(16, 8)):
    mod = _module(pk, net, data)
    mod.install_monitor(mon)
    seen = []
    for i in range(steps):
        mon.tic()
        mod.forward_backward(_batch(pk, data, seed=i))
        mod.update()
        seen.append(mon.toc())
    return mod, seen


def _stats(res):
    return {k: float(s.split()[0]) for _, k, s in res}


def test_monitor_collects_stats_during_training(mt):
    """Twin of test_monitor.py:34: per-op outputs, not only the graph's,
    with the same names and stats as mxtpu's."""
    got = [_stats(_train_monitored(pk, pk.monitor.Monitor(1))[1][0])
           for pk in (mt, mx)]
    assert any("fc1" in n for n in got[0])
    assert any("softmax" in n for n in got[0])
    assert sorted(got[0]) == sorted(got[1])
    for name, value in got[0].items():
        assert np.isfinite(value)
        assert abs(value - got[1][name]) <= 1e-5 * max(1.0, abs(value)), \
            name


def test_monitor_interval_and_pattern(mt):
    """Twin of test_monitor.py:54."""
    for pk in (mt, mx):
        _, seen = _train_monitored(
            pk, pk.monitor.Monitor(interval=2, pattern=".*fc2.*"), steps=4)
        assert seen[0] and seen[2] and not seen[1] and not seen[3]
        assert all("fc2" in name for res in (seen[0], seen[2])
                   for _, name, _ in res)
    ours, theirs = (
        [sorted(_stats(r)) for r in _train_monitored(
            pk, pk.monitor.Monitor(interval=2, pattern=".*fc2.*"),
            steps=3)[1]] for pk in (mt, mx))
    assert ours == theirs


def test_monitor_toc_sort_and_clean_deactivation(mt):
    """Twin of test_monitor.py:73."""
    _, seen = _train_monitored(mt, mt.monitor.Monitor(1, sort=True))
    names = [k for _, k, _ in seen[0]]
    assert names == sorted(names)
    empty = mt.monitor.Monitor(interval=1, pattern="no_such_tensor",
                               sort=True)
    empty.tic()
    assert empty.activated and empty.toc() == []
    assert not empty.activated and empty.queue == []

    def boom(arr):
        raise RuntimeError("bad stat")

    class FakeExe:
        output_names = ["some_output"]
        outputs = [object()]

    angry = mt.monitor.Monitor(interval=1, stat_func=boom, sort=True)
    angry.exes.append(FakeExe())
    angry.tic()
    with pytest.raises(RuntimeError):
        angry.toc()
    assert not angry.activated and angry.queue == []
    angry.stat_func = lambda x: 1.0
    angry.tic()
    assert angry.toc()


def test_monitor_through_fit_loop(mt, caplog):
    """Twin of test_monitor.py:121: fit(monitor=) arms tic/toc_print
    around every batch and logs the stats."""
    rng = np.random.RandomState(0)
    x = rng.randn(64, 8).astype("float32")
    y = rng.randint(0, 3, 64).astype("float32")
    for pk in (mt, mx):
        mod = _module(pk)
        mon = pk.monitor.Monitor(interval=1, pattern=".*softmax.*")
        with caplog.at_level(logging.INFO):
            mod.fit(pk.io.NDArrayIter(x, y, batch_size=16), num_epoch=1,
                    monitor=mon, optimizer="sgd",
                    optimizer_params={"learning_rate": 0.1})
        assert mon.step >= 4
    assert "softmax_output" in caplog.text


def test_sampled_inference_sees_batchnorm_unsampled_stays_fused(
        mt, monkeypatch):
    """A sampled batch walks unfused: 'bn0_output' is among the stats
    (as in mxtpu) and no fused step runs; an unsampled batch runs the
    fused BatchNorm->ReLU step once, and both give the same output
    (within the fused site's 1e-5)."""
    fused = []
    real = mt.executor.bn_relu_inference

    def counted(*a, **k):
        fused.append(1)
        return real(*a, **k)
    monkeypatch.setattr(mt.executor, "bn_relu_inference", counted)
    data = (2, 3, 6, 6)
    names, outs = [], []
    for pk in (mt, mx):
        mod = _module(pk, _bn_net, data)
        # a stat of its own keeps mxtpu on its per-op path too (its
        # default stat rides the fused step's device taps)
        mon = pk.monitor.Monitor(interval=2, pattern=".*",
                                 stat_func=lambda x: abs(x.asnumpy()).mean())
        mod.install_monitor(mon)
        batch = _batch(pk, data, seed=5)
        per_batch = []
        for _ in range(2):  # sampled, then unsampled
            mon.tic()
            mod.forward(batch, is_train=False)
            per_batch.append(mod.get_outputs()[0].asnumpy())
            if pk is mt:
                per_batch.append(len(fused))
            names.append(sorted(_stats(mon.toc())))
        outs.append(per_batch)
    assert "bn0_output" in names[0] and names[0] == names[2]
    assert names[1] == names[3] == []
    assert outs[0][1] == 0 and outs[0][3] == 1  # fused only unsampled
    np.testing.assert_allclose(outs[0][0], outs[0][2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=0, atol=1e-5)


def test_install_monitor_disarms_the_fused_step_and_trains_alike(mt):
    """A Monitor with a stat of its own (mxtpu's per-op branch; the
    default stat rides the fused step's taps) updates through the
    Updater and reaches the unmonitored fused Module's weights; a new
    batch shape rebinds the executors and the monitor follows them."""
    plain = _module(mt)
    assert plain._fused is not None
    mon = mt.monitor.Monitor(1, pattern="fc1_output",
                             stat_func=lambda x: abs(x.asnumpy()).mean())
    mod, _ = _train_monitored(mt, mon, steps=2)
    assert mod._fused is None
    for i in range(2):
        plain.forward_backward(_batch(mt, seed=i))
        plain.update()
    got, want = mod.get_params()[0], plain.get_params()[0]
    for k in want:
        np.testing.assert_allclose(got[k].asnumpy(), want[k].asnumpy(),
                                   rtol=0, atol=1e-6, err_msg=k)
    mon.tic()
    mod.forward(_batch(mt, (8, 8), seed=9), is_train=False)
    res = mon.toc()
    assert [k for _, k, _ in res] == ["fc1_output"]
    assert len(mon.exes) == 1 and mon.exes[0].outputs[0].shape == (8, 3)


# ------------------------------------------------------ the device adapter
def _monitor_values(pk, mon, steps=1, net=_mlp, data=(16, 8)):
    mod, seen = _train_monitored(pk, mon, steps, net, data)
    return mod, [_stats(r) for r in seen]


@pytest.mark.parametrize("net,data", [(_mlp, (16, 8)),
                                      (_bn_net, (2, 3, 6, 6))])
def test_adapter_values_match_the_per_op_path_and_mxtpus_adapter(
        mt, net, data):
    """The default stat rides the fused step's device taps (the fused
    step stays armed, mon._adapter is the module) and gives each op
    output the per-op path's value within 1e-5 relative (f32 abs-means
    in other orders), over two steps; mxtpu's adapter gives the same
    names and values."""
    ad_mod, ad = _monitor_values(mt, mt.monitor.Monitor(1), 2, net, data)
    mon = mt.monitor.Monitor(1, stat_func=lambda x: abs(x.asnumpy()).mean())
    per_mod, per = _monitor_values(mt, mon, 2, net, data)
    ref_mod, ref = _monitor_values(mx, mx.monitor.Monitor(1), 2, net, data)
    assert ad_mod._fused is not None and per_mod._fused is None
    assert ref_mod._monitor_adapter is not None
    for step in range(2):
        assert sorted(ad[step]) == sorted(ref[step])
        # the per-op path also reports the graph outputs once more
        assert set(ad[step]) == set(per[step])
        for name, v in ad[step].items():
            assert v == pytest.approx(per[step][name], rel=1e-5), name
            assert v == pytest.approx(ref[step][name], rel=1e-5), name


def test_custom_stat_func_keeps_the_per_op_path(mt):
    mon = mt.monitor.Monitor(1, stat_func=lambda x: float(
        np.max(np.abs(x.asnumpy()))))
    mod, seen = _train_monitored(mt, mon)
    assert mon._adapter is None and not mon._default_stat
    assert mod._fused is None and mon.exes
    assert seen[0] and all(np.isfinite(float(v.split()[0]))
                           for _, _, v in seen[0])


def test_adapter_env_opt_out_and_declined_fused_step(mt, monkeypatch):
    """``MXTPU_MONITOR_ADAPTER=0`` keeps the per-op path; a monitor
    installed before an optimizer without a fused rule falls back to it
    at init_optimizer (mxtpu :387-396)."""
    monkeypatch.setenv("MXTPU_MONITOR_ADAPTER", "0")
    mon = mt.monitor.Monitor(1)
    mod, _ = _train_monitored(mt, mon)
    assert mon._adapter is None and mod._fused is None
    monkeypatch.delenv("MXTPU_MONITOR_ADAPTER")
    sym = _mlp(mt)
    mod = mt.mod.Module(sym, context=mt.cpu(), logger=_quiet())
    mod.bind(data_shapes=[("data", (16, 8))],
             label_shapes=[("softmax_label", (16,))])
    mon = mt.monitor.Monitor(1)
    mod.install_monitor(mon)
    assert mon._adapter is mod
    mod.init_params()
    mod.init_optimizer(optimizer="nadam")
    assert mod._fused is None and mon._adapter is None and mon.exes


def test_adapter_through_fit_rides_the_cadence(mt):
    """fit(monitor=) with the default stat: device metrics stay on, the
    sampled batches' taps ride the health session's cadence transfer
    (no per-tensor copy), and the fused step trains to the weights of
    an unmonitored fit."""
    rng = np.random.RandomState(0)
    x = rng.randn(64, 8).astype("float32")
    y = rng.randint(0, 3, 64).astype("float32")
    delivered, weights = [], []
    for monitored in (True, False):
        mod = _module(mt)
        mon = mt.monitor.Monitor(2, pattern=".*fc.*") if monitored else None
        if mon is not None:
            real = mon._deliver_taps

            def spy(host, real=real):
                delivered.append(dict(host))
                real(host)
            mon._deliver_taps = spy
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=16), num_epoch=1,
                monitor=mon, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1})
        assert mod._fused is not None
        weights.append({k: v.asnumpy()
                        for k, v in mod.get_params()[0].items()})
    assert len(delivered) == 2
    assert set(delivered[0]) == {"fc1_output", "fc2_output"}
    for k in weights[0]:
        np.testing.assert_array_equal(weights[0][k], weights[1][k])
