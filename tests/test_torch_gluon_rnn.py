"""Gluon's recurrent cells and RNN/LSTM/GRU layers in the port against
mxtpu's Gluon, on the CPU.

From the same weights (mxtpu's, loaded into the port's block by name
with its prefix stripped, ``convert.gluon_params_from_mxtpu``) and
inputs, under ``autograd.record()`` with one random head gradient:
outputs and final states within 1e-5 relative (1e-6 absolute), the
gradients of every parameter and of the input within 1e-4 of the
largest (the sums run in other orders). The layers (``nd.RNN``: the
per-step loop here, cuDNN on the card) run in both layouts, one and two
layers, one and two directions, with and without given states; the
cells unroll imperatively and hybridized (the traced step through the
executor's walk). Then an Embedding -> LSTM -> Dense net takes two
``Trainer.step``s of SGD against mxtpu's.

torch is imported lazily and pinned to one thread: several test workers
share the host."""
import numpy as np
import pytest

import mxtpu as mx

FWD_RTOL = 1e-5
FWD_ATOL = 1e-6
GRAD_TOL = 1e-4
T, N, C, H = 4, 3, 5, 6


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


def _r(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _pair(mt, build):
    """The block built in both packages, the port's holding mxtpu's
    (Xavier) weights."""
    jb = build(mx)
    jb.collect_params().initialize(mx.init.Xavier(), ctx=mx.cpu())
    tb = build(mt)
    tb.collect_params().initialize(mt.init.Xavier(), ctx=mt.cpu())
    return jb, tb


def _sync(mt, jb, tb):
    w = {k[len(jb.prefix):]: p.data().asnumpy()
         for k, p in jb.collect_params().items()}
    mt.convert.gluon_params_from_mxtpu(w, mt.cpu(), tb)


def _grads(block):
    return {k[len(block.prefix):]: p.grad().asnumpy()
            for k, p in block.collect_params().items()
            if p.grad_req != "null"}


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _flat(o)]
    return [out]


def _run(pkg, block, call, inputs, heads_seed):
    """(outputs, gradients of the parameters and of input 0)."""
    ctx = pkg.cpu()
    xs = [pkg.nd.array(x, ctx=ctx) for x in inputs]
    xs[0].attach_grad()
    with pkg.autograd.record():
        outs = _flat(call(block, xs))
        loss = None
        for i, o in enumerate(outs):
            term = pkg.nd.sum(o * pkg.nd.array(
                _r(o.shape, heads_seed + i), ctx=ctx))
            loss = term if loss is None else loss + term
    loss.backward()
    grads = _grads(block)
    grads["__input__"] = xs[0].grad.asnumpy()
    return [o.asnumpy() for o in outs], grads


def _close(got, want):
    (go, gg), (wo, wg) = got, want
    assert len(go) == len(wo)
    for g, w in zip(go, wo):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=FWD_RTOL, atol=FWD_ATOL)
    assert sorted(gg) == sorted(wg)
    scale = max(1.0, max(float(np.abs(w).max()) for w in wg.values()))
    for k in wg:
        np.testing.assert_allclose(gg[k], wg[k], rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=k)


def _layer_cases():
    """Each layer: one layer forward in TNC, two bidirectional layers
    with given states in TNC, and two bidirectional layers in NTC."""
    out = []
    for kind in ("RNN", "LSTM", "GRU"):
        for layout, layers, bi, states in (("TNC", 1, False, False),
                                           ("TNC", 2, True, True),
                                           ("NTC", 2, True, False)):
            out.append(pytest.param(
                kind, layout, layers, bi, states,
                id="%s-%s-L%d%s-%s" % (kind, layout, layers,
                                       "-bi" if bi else "",
                                       "states" if states else "nostates")))
    return out


@pytest.mark.parametrize("kind,layout,layers,bi,states", _layer_cases())
def test_layer_matches_mxtpu(mt, kind, layout, layers, bi, states):
    def build(pkg):
        kw = {"activation": "tanh"} if kind == "RNN" else {}
        return getattr(pkg.gluon.rnn, kind)(
            H, num_layers=layers, layout=layout, bidirectional=bi,
            input_size=C, **kw)

    jb, tb = _pair(mt, build)
    _sync(mt, jb, tb)
    d = 2 if bi else 1
    shape = (T, N, C) if layout == "TNC" else (N, T, C)
    inputs = [_r(shape, 1)]
    if states:
        n_states = 2 if kind == "LSTM" else 1
        inputs += [_r((layers * d, N, H), 2 + i, 0.5)
                   for i in range(n_states)]

    def call(block, xs):
        return block(xs[0], xs[1:]) if states else block(xs[0])

    _close(_run(mt, tb, call, inputs, 10), _run(mx, jb, call, inputs, 10))


def _cell(pkg, kind):
    rnn = pkg.gluon.rnn
    if kind == "rnn":
        return rnn.RNNCell(H, input_size=C, prefix="rnn_")
    if kind == "lstm":
        return rnn.LSTMCell(H, input_size=C, prefix="lstm_")
    if kind == "gru":
        return rnn.GRUCell(H, input_size=C, prefix="gru_")
    if kind == "stack":
        cell = rnn.SequentialRNNCell(prefix="seq_")
        with cell.name_scope():
            cell.add(rnn.LSTMCell(H, input_size=C, prefix="l0_"))
            cell.add(rnn.ResidualCell(rnn.GRUCell(H, input_size=H,
                                                  prefix="l1_")))
            cell.add(rnn.DropoutCell(0.0, prefix="d_"))
        return cell
    if kind == "bidirectional":
        return rnn.BidirectionalCell(
            rnn.LSTMCell(H, input_size=C, prefix="bl_"),
            rnn.GRUCell(H, input_size=C, prefix="br_"))
    raise ValueError(kind)


def _strip_all(block):
    """{full name: value}: the cells here name every parameter by an
    explicit prefix, the same in both packages."""
    return {k: p.data().asnumpy() for k, p in block.collect_params().items()}


@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["imperative", "hybridized"])
@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("kind", ["rnn", "lstm", "gru", "stack",
                                  "bidirectional"])
def test_cell_unroll_matches_mxtpu(mt, kind, layout, hybridize):
    jc, tc = _pair(mt, lambda pkg: _cell(pkg, kind))
    w = _strip_all(jc)
    assert sorted(w) == sorted(k for k, _ in tc.collect_params().items())
    for k, p in tc.collect_params().items():
        p.set_data(mt.nd.array(w[k], ctx=mt.cpu()))
    if hybridize and kind != "bidirectional":  # Bidirectional is not stepped
        for c in (tc, jc):
            c.hybridize()
    shape = (N, T, C) if layout == "NTC" else (T, N, C)

    def call(cell, xs):
        outs, states = cell.unroll(T, xs[0], layout=layout,
                                   merge_outputs=True)
        return [outs] + list(states)

    _close(_run(mt, tc, call, [_r(shape, 3)], 20),
           _run(mx, jc, call, [_r(shape, 3)], 20))


def test_zoneout_and_dropout_cells(mt):
    """Outside training, ZoneoutCell is its base cell and DropoutCell
    the identity, as in mxtpu; in training DropoutCell keeps ~1 - p."""
    def build(pkg):
        return pkg.gluon.rnn.ZoneoutCell(
            pkg.gluon.rnn.RNNCell(H, input_size=C, prefix="z_"), 0.5, 0.5)

    jc, tc = _pair(mt, build)
    for k, p in tc.collect_params().items():
        p.set_data(mt.nd.array(jc.collect_params()[k].data().asnumpy(),
                               ctx=mt.cpu()))
    x = _r((N, T, C), 4)
    got, _ = tc.unroll(T, mt.nd.array(x, ctx=mt.cpu()), merge_outputs=True)
    want, _ = jc.unroll(T, mx.nd.array(x), merge_outputs=True)
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    drop = mt.gluon.rnn.DropoutCell(0.3)
    big = np.abs(_r((200, 3, 50), 5)) + 1.0
    with mt.autograd.record():
        out, _ = drop.unroll(3, mt.nd.array(big, ctx=mt.cpu()),
                             merge_outputs=True)
    kept = out.asnumpy() != 0
    assert abs(kept.mean() - 0.7) < 0.02
    out, _ = drop.unroll(3, mt.nd.array(big, ctx=mt.cpu()),
                         merge_outputs=True)
    np.testing.assert_array_equal(out.asnumpy(), big)


def _lm(pkg, vocab=30, hidden=8):
    net = pkg.gluon.nn.Sequential(prefix="lm_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Embedding(vocab, hidden))
        net.add(pkg.gluon.rnn.LSTM(hidden, num_layers=2, layout="NTC",
                                   input_size=hidden))
        net.add(pkg.gluon.nn.Dense(vocab, flatten=False, in_units=hidden))
    return net


@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["imperative", "hybridized"])
def test_lstm_lm_trainer_steps_match_mxtpu(mt, hybridize):
    """Embedding -> 2-layer LSTM -> Dense: two SGD ``Trainer.step``s (lr
    0.5) from mxtpu's weights on the same batches; the losses within
    1e-5 relative and the weights within 1e-5."""
    jn, tn = _pair(mt, _lm)
    _sync(mt, jn, tn)
    if hybridize:
        for n in (jn, tn):
            n.hybridize()
    rng = np.random.RandomState(6)
    batches = rng.randint(0, 30, (2, 4, 7)).astype(np.float32)
    res = []
    for pkg, net in ((mx, jn), (mt, tn)):
        ctx = pkg.cpu()
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.5})
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        losses = []
        for b in batches:
            x = pkg.nd.array(b[:, :-1], ctx=ctx)
            y = pkg.nd.array(b[:, 1:], ctx=ctx)
            with pkg.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(4)
            losses.append(loss.asnumpy())
        res.append((losses, {k[len(net.prefix):]: p.data().asnumpy()
                             for k, p in net.collect_params().items()}))
    for g, w in zip(res[1][0], res[0][0]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    assert sorted(res[1][1]) == sorted(res[0][1])
    for k, w in res[0][1].items():
        np.testing.assert_allclose(res[1][1][k], w, rtol=0, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("direction", ["port_to_mxtpu", "mxtpu_to_port"])
def test_lstm_params_files_cross_packages(mt, tmp_path, direction):
    """``save_params`` of a Gluon ``rnn.LSTM`` LM loads into the other
    package's net with ``load_params``, bit for bit."""
    jn, tn = _pair(mt, _lm)
    src, dst = (tn, jn) if direction == "port_to_mxtpu" else (jn, tn)
    path = str(tmp_path / "lm.params")
    src.save_params(path)
    dst.load_params(path, ctx=mt.cpu() if dst is tn else mx.cpu())
    want = {k[len(src.prefix):]: p.data().asnumpy()
            for k, p in src.collect_params().items()}
    got = {k[len(dst.prefix):]: p.data().asnumpy()
           for k, p in dst.collect_params().items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
