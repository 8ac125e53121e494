"""BucketingModule, the Module's shared-module surface and group2ctx
placement in the port against mxtpu's, on the CPU.

- ``BucketingModule.fit`` of a narrow 2-layer LSTM LM (stacked
  ``LSTMCell.unroll`` and ``FusedRNNCell``; buckets 5 and 9 interleaved
  as ``BucketSentenceIter`` shuffles them) with config 4's optimizer (SGD,
  momentum 0.9, wd 1e-5, clip 1.0), from mxtpu's initial weights and the
  same Python and numpy seeds: the trained weights within 1e-4 of
  mxtpu's and the per-epoch perplexity within 1e-4 relative, through the
  fused update and through the Updater. Every bucket's Module runs over
  the same parameter, gradient and aux tensors and one optimizer state.
- ``Module(state_names=...)`` (no gradient, not a parameter, the fused
  step disarmed, as mxtpu's), ``get_states``/``set_states`` against
  mxtpu's Module fed the same values as data; ``bind(shared_module=...)``
  over the same storage.
- ``Symbol.bind(group2ctx=...)`` on cpu(0)/cpu(1) (the twin of
  tests/test_parallel.py:153), with its gradients, ``simple_bind``
  placing each variable on its group's context, and 3 SGD steps of the
  model-parallel LSTM of examples/rnn/model_parallel_lstm.py against
  mxtpu's: outputs within 1e-5 relative, weights within 1e-5.

torch is imported lazily and pinned to one thread: several test workers
share the host."""
import logging
import random

import numpy as np
import pytest

import mxtpu as mx

W_TOL = 1e-4
VOCAB, E, H, B = 20, 8, 12, 8
BUCKETS = [5, 9]


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


def _quiet():
    log = logging.getLogger("quiet")
    log.setLevel(logging.ERROR)
    return log


def _sentences():
    rng = np.random.RandomState(0)
    out = []
    for _ in range(70):
        start = rng.randint(1, VOCAB)
        out.append([(start + i) % (VOCAB - 1) + 1
                    for i in range(rng.randint(2, 10))])
    return out


def _iter(pkg, seed):
    random.seed(seed)
    np.random.seed(seed)
    return pkg.rnn.BucketSentenceIter(_sentences(), B, buckets=list(BUCKETS),
                                      invalid_label=0)


def _sym_gen(pkg, fused):
    def sym_gen(seq_len):
        data = pkg.sym.Variable("data")
        label = pkg.sym.Variable("softmax_label")
        embed = pkg.sym.Embedding(data=data, input_dim=VOCAB, output_dim=E,
                                  name="embed")
        if fused:
            stack = pkg.rnn.FusedRNNCell(H, num_layers=2, mode="lstm",
                                         prefix="lstm_")
        else:
            stack = pkg.rnn.SequentialRNNCell()
            for i in range(2):
                stack.add(pkg.rnn.LSTMCell(num_hidden=H,
                                           prefix="lstm_l%d_" % i))
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = pkg.sym.Reshape(outputs, shape=(-1, H))
        pred = pkg.sym.FullyConnected(data=pred, num_hidden=VOCAB,
                                      name="pred")
        label = pkg.sym.Reshape(label, shape=(-1,))
        pred = pkg.sym.SoftmaxOutput(data=pred, label=label, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-5,
       "clip_gradient": 1.0}


def _initial(fused):
    it = _iter(mx, 1)
    mod = mx.mod.Module(_sym_gen(mx, fused)(it.default_bucket_key)[0],
                        context=mx.cpu(), logger=_quiet())
    mod.bind(it.provide_data, it.provide_label)
    mx.random.seed(5)
    mod.init_params(mx.init.Xavier(factor_type="in", magnitude=2.34))
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _fit(pkg, fused, w0, optimizer="sgd", epochs=2):
    ctx = pkg.cpu()
    it = _iter(pkg, 2)
    mod = pkg.mod.BucketingModule(_sym_gen(pkg, fused),
                                  default_bucket_key=it.default_bucket_key,
                                  context=ctx, logger=_quiet())
    ppl = []

    def record(epoch, symbol, arg, aux):
        del epoch, symbol, arg, aux
        ppl.append(metric.get()[1])

    metric = pkg.metric.Perplexity(ignore_label=0)
    arg = {k: pkg.nd.array(v, ctx=ctx) for k, v in w0.items()}
    mod.fit(it, num_epoch=epochs, eval_metric=metric,
            optimizer=optimizer if isinstance(optimizer, str) else
            optimizer(rescale_grad=1.0 / B, **OPT),
            optimizer_params=OPT, arg_params=arg,
            epoch_end_callback=record)
    return mod, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}, ppl


def _sgd_by_updater(**kw):
    """An SGD subclass of the port: no fused rule, so the Updater."""
    import mxtpu_torch

    class SGDUpdater(mxtpu_torch.optimizer.SGD):
        pass
    return SGDUpdater(**kw)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("update", ["fused_step", "updater"])
def test_bucketing_fit_matches_mxtpu(mt, fused, update):
    w0 = _initial(fused)
    _, want, want_ppl = _fit(mx, fused, w0)
    mod, got, got_ppl = _fit(mt, fused, w0, "sgd" if update == "fused_step"
                             else _sgd_by_updater)
    modules = mod.buckets
    assert sorted(modules) == BUCKETS
    for m in modules.values():
        assert (m._fused is not None) == (update == "fused_step")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=W_TOL,
                                   err_msg=k)
        assert not np.array_equal(got[k], w0[k])
    np.testing.assert_allclose(got_ppl, want_ppl, rtol=1e-4)
    assert got_ppl[-1] < got_ppl[0]


def test_buckets_share_storage_and_state(mt):
    """After fit every bucket's parameters, gradients and optimizer state
    are the default bucket's tensors; an update through one bucket is
    seen by the other."""
    mod, _, _ = _fit(mt, False, _initial(False), epochs=1)
    first, second = (mod.buckets[k] for k in BUCKETS)
    e1, e2 = first._exec_group.execs[0], second._exec_group.execs[0]
    for n in first._param_names:
        assert e1.arg_dict[n]._data.data_ptr() == \
            e2.arg_dict[n]._data.data_ptr()
        assert e1.grad_dict[n]._data.data_ptr() == \
            e2.grad_dict[n]._data.data_ptr()
    assert first._fused.opt_state is second._fused.opt_state
    assert first._optimizer is second._optimizer
    before = e2.arg_dict["pred_weight"].asnumpy()
    it = _iter(mt, 9)
    batch = next(b for b in it if b.bucket_key == BUCKETS[0])
    mod.forward_backward(batch)
    mod.update()
    assert mod._curr_module is first
    assert not np.array_equal(e2.arg_dict["pred_weight"].asnumpy(), before)


def _state_sym(pkg):
    data = pkg.sym.Variable("data")
    h = pkg.sym.Variable("h", shape=(4, 3))
    fc = pkg.sym.FullyConnected(data, num_hidden=3, name="fc")
    return pkg.sym.Activation(fc + h, act_type="tanh")


def test_state_names_and_shared_module(mt):
    """A state input is neither data nor parameter, takes no gradient and
    keeps the fused step disarmed (as mxtpu's); set_states/get_states
    write and read it; the outputs and the parameter gradient equal
    mxtpu's Module fed the same state as data. A module bound with
    shared_module runs over the same storage."""
    x = np.random.RandomState(0).rand(4, 5).astype(np.float32)
    state = np.random.RandomState(1).rand(4, 3).astype(np.float32)
    jmod = mx.mod.Module(_state_sym(mx), data_names=("data",),
                         label_names=None, state_names=("h",),
                         context=mx.cpu(), logger=_quiet())
    tmod = mt.mod.Module(_state_sym(mt), data_names=("data",),
                         label_names=None, state_names=("h",),
                         context=mt.cpu(), logger=_quiet())
    assert tmod._param_names == jmod._param_names == ["fc_weight",
                                                      "fc_bias"]
    with pytest.raises(mt.MXNetError, match="state name"):
        mt.mod.Module(_state_sym(mt), state_names=("nope",),
                      context=mt.cpu())
    feed = mx.mod.Module(_state_sym(mx), data_names=("data", "h"),
                         label_names=None, context=mx.cpu(), logger=_quiet())
    for m in (jmod, tmod):
        m.bind([("data", x.shape)], None)
    feed.bind([("data", x.shape), ("h", state.shape)], None)
    mx.random.seed(2)
    feed.init_params(mx.init.Xavier())
    w0 = {k: v.asnumpy() for k, v in feed.get_params()[0].items()}
    jmod.init_params(arg_params={k: mx.nd.array(v) for k, v in w0.items()})
    tmod.init_params(arg_params=mt.convert.params_from_mxtpu(w0, mt.cpu()))
    for m in (jmod, tmod):
        m.init_optimizer(optimizer="sgd")
    assert jmod._fused is None and tmod._fused is None
    assert jmod.get_states() == []  # mxtpu's Module keeps no states
    tmod.set_states(value=0.5)
    np.testing.assert_array_equal(tmod.get_states()[0].asnumpy(),
                                  np.full((4, 3), 0.5, np.float32))
    tmod.set_states(states=[mt.nd.array(state, ctx=mt.cpu())])
    np.testing.assert_array_equal(tmod.get_states()[0].asnumpy(), state)
    tmod.forward(mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())], []),
                 is_train=True)
    tmod.backward([mt.nd.ones((4, 3), ctx=mt.cpu())])
    feed.forward(mx.io.DataBatch([mx.nd.array(x), mx.nd.array(state)], []),
                 is_train=True)
    feed.backward([mx.nd.ones((4, 3))])
    np.testing.assert_allclose(tmod.get_outputs()[0].asnumpy(),
                               feed.get_outputs()[0].asnumpy(), rtol=1e-5,
                               atol=1e-6)
    ex = tmod._exec_group.execs[0]
    assert "h" not in ex.grad_dict
    jg = feed._exec_group.execs[0].grad_dict
    for n in ("fc_weight", "fc_bias"):
        np.testing.assert_allclose(ex.grad_dict[n].asnumpy(),
                                   jg[n].asnumpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tmod.get_states()[0].asnumpy(), state)

    other = mt.mod.Module(_state_sym(mt), label_names=None,
                          state_names=("h",), context=mt.cpu())
    other.bind([("data", (4, 5))], None, shared_module=tmod)
    assert other.params_initialized
    oe = other._exec_group.execs[0]
    for n in ("fc_weight", "fc_bias"):
        assert oe.arg_dict[n]._data.data_ptr() == \
            ex.arg_dict[n]._data.data_ptr()
        assert oe.grad_dict[n]._data.data_ptr() == \
            ex.grad_dict[n]._data.data_ptr()
    other.borrow_optimizer(tmod)
    assert other._updater is tmod._updater


def _two_groups(pkg):
    with pkg.AttrScope(ctx_group="dev1"):
        data = pkg.sym.Variable("data")
        fc1 = pkg.sym.FullyConnected(data, num_hidden=8, name="fc1")
        act1 = pkg.sym.Activation(fc1, act_type="relu")
    with pkg.AttrScope(ctx_group="dev2"):
        fc2 = pkg.sym.FullyConnected(act1, num_hidden=4, name="fc2")
        return pkg.sym.Activation(fc2, act_type="tanh")


@pytest.mark.parametrize("pkg_name", ["mxtpu", "mxtpu_torch"])
def test_group2ctx_model_parallel(mt, pkg_name):
    """tests/test_parallel.py:153's body through either package: the
    split executor equals the single one."""
    pkg = mx if pkg_name == "mxtpu" else mt
    net = _two_groups(pkg)
    rng = np.random.RandomState(0)
    shapes, _, _ = net.infer_shape(data=(2, 6))
    args = {n: pkg.nd.array(rng.rand(*s).astype("float32") * 0.1,
                            ctx=pkg.cpu())
            for n, s in zip(net.list_arguments(), shapes)}
    exe = net.bind(pkg.cpu(), args,
                   group2ctx={"dev1": pkg.cpu(0), "dev2": pkg.cpu(1)})
    exe.forward(is_train=False)
    split_out = exe.outputs[0].asnumpy()
    exe_single = net.bind(pkg.cpu(), args)
    exe_single.forward(is_train=False)
    np.testing.assert_allclose(split_out, exe_single.outputs[0].asnumpy(),
                               rtol=1e-5, atol=1e-6)


def test_group2ctx_training_and_simple_bind(mt):
    """The port's split executor trains as mxtpu's: the nodes carry their
    groups, the gradients equal mxtpu's; simple_bind puts each variable
    on its group's context."""
    jnet, tnet = _two_groups(mx), _two_groups(mt)
    assert tnet.attr("__ctx_group__") == jnet.attr("__ctx_group__") == "dev2"
    assert tnet.attr_dict()["fc1_weight"]["__ctx_group__"] == "dev1"
    rng = np.random.RandomState(1)
    shapes, _, _ = jnet.infer_shape(data=(2, 6))
    vals = {n: rng.rand(*s).astype("float32") - 0.5
            for n, s in zip(jnet.list_arguments(), shapes)}
    res = []
    for pkg, net in ((mx, jnet), (mt, tnet)):
        args = {n: pkg.nd.array(v, ctx=pkg.cpu()) for n, v in vals.items()}
        grads = {n: pkg.nd.zeros(v.shape, ctx=pkg.cpu())
                 for n, v in vals.items()}
        exe = net.bind(pkg.cpu(), args, args_grad=grads,
                       group2ctx={"dev1": pkg.cpu(0), "dev2": pkg.cpu(1)})
        out = exe.forward(is_train=True)[0].asnumpy()
        exe.backward([pkg.nd.ones(out.shape, ctx=pkg.cpu())])
        res.append((out, {n: g.asnumpy() for n, g in grads.items()}))
    np.testing.assert_allclose(res[1][0], res[0][0], rtol=1e-5, atol=1e-6)
    for n in vals:
        np.testing.assert_allclose(res[1][1][n], res[0][1][n], rtol=1e-5,
                                   atol=1e-6, err_msg=n)
    exe = tnet.simple_bind(mt.cpu(), data=(2, 6),
                           group2ctx={"dev1": mt.cpu(0), "dev2": mt.cpu(1)})
    assert exe.arg_dict["fc2_weight"].context == mt.cpu(1)
    assert exe.arg_dict["fc1_weight"].context == mt.cpu(0)
    assert exe.grad_dict["fc2_bias"].context == mt.cpu(1)
    shared = tnet.simple_bind(mt.cpu(), data=(2, 6), shared_exec=exe)
    assert shared.arg_dict["fc1_weight"] is exe.arg_dict["fc1_weight"]
    assert shared.arg_dict["data"] is exe.arg_dict["data"]
    bigger = tnet.simple_bind(mt.cpu(), data=(3, 6), shared_exec=exe)
    assert bigger.arg_dict["data"] is not exe.arg_dict["data"]
    assert exe.forward()[0].shape == (2, 4) and exe.cross_device_copies == 0
    # a group on another device: its node's inputs from elsewhere cross
    # (act1's output), its own weights do not; counted per run
    import torch
    from mxtpu_torch.executor import _trace_graph
    run = _trace_graph(tnet, False, placements={"dev2": torch.device(
        "meta")}, default_device=torch.device("cpu"))
    args = {n: torch.zeros(a.shape, device="meta" if n.startswith("fc2")
                           else "cpu") for n, a in exe.arg_dict.items()}
    outs, _ = run(args, {})
    assert outs[0].device.type == "meta" and run.copies == 1


def _model_parallel(pkg, vocab=40, hidden=16, seq_len=6):
    """examples/rnn/model_parallel_lstm.py's build_symbol."""
    with pkg.AttrScope(ctx_group="embed_rnn1"):
        data = pkg.sym.Variable("data")
        label = pkg.sym.Variable("softmax_label")
        embed = pkg.sym.Embedding(data, input_dim=vocab, output_dim=hidden,
                                  name="embed")
        cell1 = pkg.rnn.LSTMCell(num_hidden=hidden, prefix="lstm1_")
        out1, _ = cell1.unroll(seq_len, inputs=embed, merge_outputs=True,
                               layout="NTC")
    with pkg.AttrScope(ctx_group="rnn2_head"):
        cell2 = pkg.rnn.LSTMCell(num_hidden=hidden, prefix="lstm2_")
        out2, _ = cell2.unroll(seq_len, inputs=out1, merge_outputs=True,
                               layout="NTC")
        flat = pkg.sym.Reshape(out2, shape=(-1, hidden))
        fc = pkg.sym.FullyConnected(flat, num_hidden=vocab, name="fc")
        lbl = pkg.sym.Reshape(label, shape=(-1,))
        return pkg.sym.SoftmaxOutput(fc, lbl, name="softmax",
                                     normalization="batch")


def test_model_parallel_lstm_steps_match_mxtpu(mt):
    """3 SGD steps (lr 0.5) of the model-parallel LSTM, embed_rnn1 on
    cpu(0) and rnn2_head on cpu(1), in both packages from the same
    weights and batches."""
    batch, seq_len, vocab = 8, 6, 40
    rng = np.random.RandomState(3)
    xs = rng.randint(0, vocab, (3, batch, seq_len + 1)).astype(np.float32)
    jnet = _model_parallel(mx)
    shapes = dict(zip(jnet.list_arguments(), jnet.infer_shape(
        data=(batch, seq_len), softmax_label=(batch, seq_len))[0]))
    w0 = {n: (rng.rand(*s).astype(np.float32) - 0.5) * 0.4
          for n, s in shapes.items() if n not in ("data", "softmax_label")}
    res = []
    for pkg in (mx, mt):
        net = jnet if pkg is mx else _model_parallel(mt)
        ctx = pkg.cpu()
        arrs = {n: pkg.nd.zeros(s, ctx=ctx) for n, s in shapes.items()}
        grads = {n: pkg.nd.zeros(shapes[n], ctx=ctx) for n in w0}
        for n, v in w0.items():
            arrs[n][:] = pkg.nd.array(v, ctx=ctx)
        exe = net.bind(ctx, arrs, args_grad=grads,
                       group2ctx={"embed_rnn1": pkg.cpu(0),
                                  "rnn2_head": pkg.cpu(1)})
        outs = []
        for step in xs:
            arrs["data"][:] = pkg.nd.array(step[:, :-1], ctx=ctx)
            arrs["softmax_label"][:] = pkg.nd.array(step[:, 1:], ctx=ctx)
            outs.append(exe.forward(is_train=True)[0].asnumpy())
            exe.backward()
            for n, g in grads.items():
                arrs[n][:] = arrs[n] - 0.5 * g
        res.append((outs, {n: arrs[n].asnumpy() for n in w0}))
    for got, want in zip(res[1][0], res[0][0]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for n in w0:
        np.testing.assert_allclose(res[1][1][n], res[0][1][n], rtol=0,
                                   atol=1e-5, err_msg=n)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_bucketing_checkpoints_cross_packages(mt, tmp_path, fused):
    """A BucketingModule's checkpoint (the default bucket's symbol and
    the shared weights; the fused cell's flat vector as it is) loads in
    mxtpu bit for bit, and mxtpu's loads into the port's."""
    w0 = _initial(fused)
    mod, got, _ = _fit(mt, fused, w0, epochs=1)
    prefix = str(tmp_path / "lm")
    mod.save_checkpoint(prefix, 1)
    sym, args, aux = mx.model.load_checkpoint(prefix, 1)
    assert aux == {}
    assert sym.list_arguments() == \
        mod.buckets[max(BUCKETS)].symbol.list_arguments()
    assert sorted(args) == sorted(got)
    for k, v in got.items():
        np.testing.assert_array_equal(args[k].asnumpy(), v)
    jprefix = str(tmp_path / "jlm")
    mx.model.save_checkpoint(jprefix, 3, sym, args, {})
    back = mt.mod.Module.load(jprefix, 3, context=mt.cpu(),
                              logger=_quiet())
    it = _iter(mt, 2)
    back.bind(it.provide_data, it.provide_label)
    for k, v in back.get_params()[0].items():
        np.testing.assert_array_equal(v.asnumpy(), got[k])
