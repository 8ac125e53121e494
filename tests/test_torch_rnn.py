"""The port's symbolic RNN cells, BucketSentenceIter and RNN checkpoints
against mxtpu's, on the CPU.

Each cell is built in both packages with the same prefixes, so its
unrolled symbol has the same arguments; from the same random weights and
inputs (numpy) the two executors' outputs (and final states) agree
within 1e-5 relative (1e-6 absolute) and, under the same random head
gradients, every argument's gradient within 1e-4 of the largest (the
sums run in other orders). Every cell unrolls in both layouts, with
``merge_outputs`` True and False; the fused cell matches its
``unfuse()``d stack (the twin of tests/test_rnn.py::
test_fused_matches_unfused). DropoutCell and ZoneoutCell draw their
masks, so they are held to their statistics, and to mxtpu at inference
(there within 1e-5 absolute: 50-wide sums).
BucketSentenceIter gives mxtpu's batches and bucket keys from the same
seeds and restores mxtpu's cursor; the rnn checkpoints cross between the
packages bit for bit.

torch is imported lazily and pinned to one thread: several test workers
share the host."""
import random
import warnings

import numpy as np
import pytest

import mxtpu as mx

FWD_RTOL = 1e-5
FWD_ATOL = 1e-6
GRAD_TOL = 1e-4
T, N, C, H = 3, 2, 4, 4


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


def _r(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _cell(pkg, kind):
    rnn = pkg.rnn
    if kind == "rnn_tanh":
        return rnn.RNNCell(H, prefix="rnn_")
    if kind == "rnn_relu":
        return rnn.RNNCell(H, activation="relu", prefix="relu_")
    if kind == "lstm":
        return rnn.LSTMCell(H, prefix="lstm_")
    if kind == "gru":
        return rnn.GRUCell(H, prefix="gru_")
    if kind == "fused_lstm":
        return rnn.FusedRNNCell(H, num_layers=2, prefix="f_",
                                get_next_state=True)
    if kind == "fused_gru_bi":
        return rnn.FusedRNNCell(H, num_layers=2, mode="gru",
                                bidirectional=True, prefix="fg_")
    if kind == "stack":
        stack = rnn.SequentialRNNCell()
        stack.add(rnn.LSTMCell(H, prefix="s0_"))
        stack.add(rnn.ResidualCell(rnn.GRUCell(H, prefix="s1_")))
        stack.add(rnn.DropoutCell(0.0, prefix="s2_"))
        return stack
    if kind == "bidirectional":
        return rnn.BidirectionalCell(rnn.LSTMCell(H, prefix="bl_"),
                                     rnn.GRUCell(H, prefix="br_"))
    raise ValueError(kind)


KINDS = ["rnn_tanh", "rnn_relu", "lstm", "gru", "fused_lstm", "fused_gru_bi",
         "stack", "bidirectional"]


def _unrolled(pkg, kind, layout, merge):
    cell = _cell(pkg, kind)
    outs, states = cell.unroll(T, pkg.sym.Variable("data"), layout=layout,
                               merge_outputs=merge)
    outs = outs if isinstance(outs, list) else [outs]
    return pkg.sym.Group(outs + list(states))


def _values(sym, data_shape, seed):
    arg_shapes, _, _ = sym.infer_shape(data=data_shape)
    return {n: _r(s, seed + i, 1.0 if n == "data" else 0.4)
            for i, (n, s) in enumerate(zip(sym.list_arguments(),
                                           arg_shapes))}


def _run(pkg, sym, vals, heads_seed, is_train=True):
    """Outputs and every argument's gradient under seeded heads."""
    ctx = pkg.cpu()
    args = {n: pkg.nd.array(v, ctx=ctx) for n, v in vals.items()}
    grads = {n: pkg.nd.zeros(v.shape, ctx=ctx) for n, v in vals.items()}
    ex = sym.bind(ctx, args, args_grad=grads)
    outs = ex.forward(is_train=is_train)
    got = [o.asnumpy() for o in outs]
    if not is_train:
        return got, None
    ex.backward([pkg.nd.array(_r(o.shape, heads_seed + i), ctx=ctx)
                 for i, o in enumerate(got)])
    return got, {n: g.asnumpy() for n, g in grads.items()}


def _close(got, want, grads_got=None, grads_want=None, atol=FWD_ATOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=FWD_RTOL, atol=atol)
    if grads_want is None:
        return
    assert sorted(grads_got) == sorted(grads_want)
    scale = max(1.0, max(float(np.abs(w).max())
                         for w in grads_want.values()))
    for k in grads_want:
        np.testing.assert_allclose(grads_got[k], grads_want[k], rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=k)


@pytest.mark.parametrize("merge", [True, False])
@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("kind", KINDS)
def test_cell_unroll_matches_mxtpu(mt, kind, layout, merge):
    jsym = _unrolled(mx, kind, layout, merge)
    tsym = _unrolled(mt, kind, layout, merge)
    assert tsym.list_arguments() == jsym.list_arguments()
    assert len(tsym.list_outputs()) == len(jsym.list_outputs())
    shape = (N, T, C) if layout == "NTC" else (T, N, C)
    vals = _values(jsym, shape, 11)
    want, want_g = _run(mx, jsym, vals, 40)
    got, got_g = _run(mt, tsym, vals, 40)
    _close(got, want, got_g, want_g)


@pytest.mark.parametrize("mode", ["rnn_relu", "rnn_tanh", "lstm", "gru"])
def test_fused_matches_unfused(mt, mode):
    """FusedRNNCell.unroll == its unfuse()d SequentialRNNCell unroll from
    the same weights (the per-gate ones packed into the cells'), and the
    fused symbol matches mxtpu's."""
    L = 2
    fused = mt.rnn.FusedRNNCell(H, num_layers=L, mode=mode, prefix="f_")
    fo, _ = fused.unroll(T, mt.sym.Variable("data"), layout="NTC",
                         merge_outputs=True)
    uo, _ = fused.unfuse().unroll(T, mt.sym.Variable("data"), layout="NTC",
                                  merge_outputs=True)
    size = mt.ops.rnn.rnn_param_size(L, C, H, mode)
    flat = _r((size,), 3, 0.3)
    data = _r((N, T, C), 4)
    got, _ = _run(mt, fo, {"data": data, "f_parameters": flat}, 0,
                  is_train=False)
    args = {"f_" + k: mt.nd.array(v, ctx=mt.cpu()) for k, v in
            mt.ops.rnn.rnn_unpack_weights(flat, L, C, H, mode).items()}
    args = fused.unfuse().pack_weights(args)
    vals = {k: v.asnumpy() for k, v in args.items()}
    vals["data"] = data
    unfused, _ = _run(mt, uo, vals, 0, is_train=False)
    np.testing.assert_allclose(got[0], unfused[0], rtol=FWD_RTOL, atol=1e-5)
    jfo, _ = mx.rnn.FusedRNNCell(H, num_layers=L, mode=mode, prefix="f_") \
        .unroll(T, mx.sym.Variable("data"), layout="NTC", merge_outputs=True)
    want, _ = _run(mx, jfo, {"data": data, "f_parameters": flat}, 0,
                   is_train=False)
    np.testing.assert_allclose(got[0], want[0], rtol=FWD_RTOL,
                               atol=FWD_ATOL)


def test_fused_initializer_and_unpack_match_mxtpu(mt):
    """FusedRNNCell's variable carries FusedRNN(Xavier) as mxtpu's does
    (the same ``__init__`` attr); its initialized blob has the forget-bias
    layout and per-matrix Xavier scales; unpack/pack name and order the
    blob as mxtpu's."""
    tcell = mt.rnn.FusedRNNCell(H, num_layers=2, prefix="f_")
    jcell = mx.rnn.FusedRNNCell(H, num_layers=2, prefix="f_")
    tsym, _ = tcell.unroll(T, mt.sym.Variable("data"))
    jsym, _ = jcell.unroll(T, mx.sym.Variable("data"))
    assert tsym.attr_dict()["f_parameters"]["__init__"] == \
        jsym.attr_dict()["f_parameters"]["__init__"]
    size = mt.ops.rnn.rnn_param_size(2, C, H, "lstm")
    arr = mt.nd.zeros((size,), ctx=mt.cpu())
    np.random.seed(0)
    mt.init.Xavier()(mt.init.InitDesc(
        "f_parameters", tsym.attr_dict()["f_parameters"]), arr)
    parts = mt.ops.rnn.rnn_unpack_weights(arr.asnumpy(), 2, C, H, "lstm")
    for k, v in parts.items():
        if k.endswith("i2h_f_bias"):
            np.testing.assert_array_equal(v, 1.0)
        elif k.endswith("bias"):
            np.testing.assert_array_equal(v, 0.0)
        else:  # Xavier(in, 2.34) on each (H, fan_in) matrix
            assert np.abs(v).max() <= np.sqrt(2.34 / v.shape[1]) + 1e-6
    flat = {"f_parameters": mt.nd.array(_r((size,), 1), ctx=mt.cpu())}
    got = tcell.unpack_weights(flat)
    want = jcell.unpack_weights({"f_parameters": mx.nd.array(
        _r((size,), 1))})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].asnumpy(), want[k].asnumpy())
    back = tcell.pack_weights(got)
    np.testing.assert_array_equal(back["f_parameters"].asnumpy(),
                                  flat["f_parameters"].asnumpy())


def test_dropout_and_zoneout_by_statistics(mt):
    """DropoutCell(0.5) keeps ~half of the elements, scaled by 2;
    ZoneoutCell(0.5, 0.5) carries ~half of the outputs and states over
    from the step before; at inference both are mxtpu's forward."""
    n, t, c = 400, 3, 50
    x = np.abs(_r((n, t, c), 5)) + 0.5
    cell = mt.rnn.DropoutCell(0.5)
    out, _ = cell.unroll(t, mt.sym.Variable("data"), merge_outputs=True)
    mt.random.seed(0)
    y, _ = _run(mt, out, {"data": x}, 0)
    kept = y[0] != 0
    assert abs(kept.mean() - 0.5) < 0.02
    np.testing.assert_allclose(y[0][kept], 2 * x[kept], rtol=1e-6)

    def zoneout(pkg):
        return pkg.rnn.ZoneoutCell(pkg.rnn.RNNCell(c, prefix="z_"), 0.5,
                                   0.5)

    zo, zs = zoneout(mt).unroll(t, mt.sym.Variable("data"),
                                merge_outputs=False)
    plain, _ = mt.rnn.RNNCell(c, prefix="z_").unroll(
        t, mt.sym.Variable("data"), merge_outputs=False)
    vals = _values(mt.sym.Group(plain), (n, t, c), 7)
    z, _ = _run(mt, mt.sym.Group(zo + zs), vals, 0)
    # the first step's output comes from a zero previous output
    assert abs((z[0] == 0).mean() - 0.5) < 0.02
    # later outputs: each element either the step before's or a new one
    assert abs((z[1] == z[0]).mean() - 0.5) < 0.02
    jz, jzs = zoneout(mx).unroll(t, mx.sym.Variable("data"),
                                 merge_outputs=False)
    want, _ = _run(mx, mx.sym.Group(jz + jzs), vals, 0, is_train=False)
    got, _ = _run(mt, mt.sym.Group(zo + zs), vals, 0, is_train=False)
    _close(got, want, atol=1e-5)  # 50-wide sums, an f32 rounding apart


@pytest.mark.parametrize("kind", ["ConvRNNCell", "ConvLSTMCell",
                                  "ConvGRUCell"])
def test_conv_cells_match_mxtpu(mt, kind):
    """The conv cells' unroll over NCHW steps, forward and gradients."""
    shape = (2, 5, 5)

    def build(pkg):
        cell = getattr(pkg.rnn, kind)(input_shape=shape, num_hidden=3)
        data = pkg.sym.Variable("data")
        steps = [pkg.sym.Reshape(pkg.sym.slice_axis(
            data, axis=1, begin=t, end=t + 1), shape=(-1,) + shape)
            for t in range(T)]
        outs, states = cell.unroll(T, inputs=steps)
        return pkg.sym.Group(list(outs) + list(states))

    jsym, tsym = build(mx), build(mt)
    assert tsym.list_arguments() == jsym.list_arguments()
    vals = _values(jsym, (N, T) + shape, 21)
    want, want_g = _run(mx, jsym, vals, 60)
    got, got_g = _run(mt, tsym, vals, 60)
    _close(got, want, got_g, want_g)


def _sentences(n=120, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        start = rng.randint(1, 30)
        out.append([(start + i) % 29 + 1 for i in range(rng.randint(2, 13))])
    return out


def _batches(it, n=None):
    out = []
    for i, b in enumerate(it):
        if n is not None and i == n:
            break
        out.append((b.bucket_key, b.data[0].asnumpy(), b.label[0].asnumpy(),
                    tuple(b.provide_data[0].shape)))
    return out


def _same(a, b):
    assert len(a) == len(b)
    for (k1, d1, l1, s1), (k2, d2, l2, s2) in zip(a, b):
        assert k1 == k2 and s1 == s2
        np.testing.assert_array_equal(d1, d2)
        np.testing.assert_array_equal(l1, l2)


@pytest.mark.parametrize("layout", ["NT", "TN"])
def test_bucket_sentence_iter_matches_mxtpu(mt, layout):
    """From the same Python and numpy seeds, the same batches and bucket
    keys, epoch after epoch; the provide_* descriptors agree."""
    def make(pkg):
        random.seed(3)
        np.random.seed(3)
        it = pkg.rnn.BucketSentenceIter(_sentences(), 8, buckets=[5, 9, 13],
                                        invalid_label=0, layout=layout)
        return it, _batches(it) + (it.reset() or []) + _batches(it)

    jit, want = make(mx)
    tit, got = make(mt)
    _same(got, want)
    assert tit.default_bucket_key == jit.default_bucket_key == 13
    assert [tuple(d.shape) for d in tit.provide_data] == \
        [tuple(d.shape) for d in jit.provide_data]
    assert {k for k, *_ in got} == {5, 9, 13}
    for k, d, lab, _ in got:
        axis = 1 if layout == "NT" else 0
        assert d.shape[axis] == k
        np.testing.assert_array_equal(
            np.take(d, range(1, k), axis=axis),
            np.take(lab, range(0, k - 1), axis=axis))


def test_bucket_iter_cursor_restores_across_packages(mt):
    """checkpoint_state mid-epoch: a fresh iterator of either package
    restored from it gives the rest of the epoch."""
    random.seed(5)
    np.random.seed(5)
    jit = mx.rnn.BucketSentenceIter(_sentences(seed=1), 8, buckets=[5, 9, 13],
                                    invalid_label=0)
    _batches(jit, 3)
    state = jit.checkpoint_state()
    rest = _batches(jit)
    for pkg in (mt, mx):
        fresh = pkg.rnn.BucketSentenceIter(_sentences(seed=1), 8,
                                           buckets=[5, 9, 13],
                                           invalid_label=0)
        assert fresh.restore_state(state)
        _same(_batches(fresh), rest)
    tit = mt.rnn.BucketSentenceIter(_sentences(seed=1), 8, buckets=[5, 9, 13],
                                    invalid_label=0)
    assert not tit.restore_state({"curr_idx": 0})
    _batches(tit, 2)
    back = mx.rnn.BucketSentenceIter(_sentences(seed=1), 8,
                                     buckets=[5, 9, 13], invalid_label=0)
    assert back.restore_state(tit.checkpoint_state())
    _same(_batches(back), _batches(tit))


def test_encode_sentences_matches_mxtpu(mt):
    words = [["the", "cat", "sat"], ["the", "dog"], ["a", "cat"]]
    got = mt.rnn.encode_sentences(words, invalid_label=0, start_label=1)
    want = mx.rnn.encode_sentences(words, invalid_label=0, start_label=1)
    assert got == want
    again = mt.rnn.encode_sentences([["dog", "a"]], vocab=got[1])
    assert again[0] == [[got[1]["dog"], got[1]["a"]]]


@pytest.mark.parametrize("direction", ["port_to_mxtpu", "mxtpu_to_port"])
def test_rnn_checkpoints_cross_packages(mt, tmp_path, direction):
    """save_rnn_checkpoint packs each cell's per-gate weights (the LSTM
    stack's into i2h/h2h blocks, the fused cell's into its flat vector);
    the other package's load_rnn_checkpoint unpacks the same names and
    bits, and loads the symbol."""
    def cells(pkg):
        stack = pkg.rnn.SequentialRNNCell()
        stack.add(pkg.rnn.LSTMCell(H, prefix="l0_"))
        fused = pkg.rnn.FusedRNNCell(H, num_layers=1, prefix="f_")
        return [stack, fused]

    def symbol(pkg, cs):
        out, _ = cs[0].unroll(T, pkg.sym.Variable("data"),
                              merge_outputs=True)
        out, _ = cs[1].unroll(T, out, merge_outputs=True)
        return out

    src, dst = (mt, mx) if direction == "port_to_mxtpu" else (mx, mt)
    scells = cells(src)
    ssym = symbol(src, scells)
    shapes = dict(zip(ssym.list_arguments(),
                      ssym.infer_shape(data=(N, T, C))[0]))
    packed = {k: _r(s, i) for i, (k, s) in enumerate(sorted(shapes.items()))
              if k != "data"}
    ctx = src.cpu()
    unpacked = scells[0].unpack_weights(
        {k: src.nd.array(v, ctx=ctx) for k, v in packed.items()})
    unpacked = scells[1].unpack_weights(unpacked)
    prefix = str(tmp_path / "lm")
    src.rnn.save_rnn_checkpoint(scells, prefix, 2, ssym, unpacked, {})
    sym, args, aux = dst.rnn.load_rnn_checkpoint(cells(dst), prefix, 2)
    assert sym.list_arguments() == ssym.list_arguments()
    assert sorted(args) == sorted(unpacked) and aux == {}
    for k, v in unpacked.items():
        np.testing.assert_array_equal(args[k].asnumpy(), v.asnumpy())
    # the file itself holds the packed weights, as written
    _, raw, _ = dst.model.load_checkpoint(prefix, 2)
    for k, v in packed.items():
        np.testing.assert_array_equal(raw[k].asnumpy(), v)


def test_do_rnn_checkpoint_and_rnn_unroll(mt, tmp_path):
    stack = mt.rnn.SequentialRNNCell()
    stack.add(mt.rnn.LSTMCell(H, prefix="l0_"))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        outs, _ = mt.rnn.rnn_unroll(stack, T, mt.sym.Variable("data"))
    assert any("deprecated" in str(w.message) for w in caught)
    out = mt.sym.Group(outs)
    shapes = dict(zip(out.list_arguments(),
                      out.infer_shape(data=(N, T, C))[0]))
    arg = stack.unpack_weights({k: mt.nd.array(_r(s, 1), ctx=mt.cpu())
                                for k, s in shapes.items() if k != "data"})
    cb = mt.rnn.do_rnn_checkpoint(stack, str(tmp_path / "m"), period=2)
    cb(0, out, arg, {})
    assert not (tmp_path / "m-0001.params").exists()
    cb(1, out, arg, {})
    _, back, _ = mx.rnn.load_rnn_checkpoint(
        [mx.rnn.LSTMCell(H, prefix="l0_")], str(tmp_path / "m"), 2)
    for k, v in arg.items():
        np.testing.assert_array_equal(back[k].asnumpy(), v.asnumpy())
