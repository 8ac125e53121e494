"""The port's Predictor against mxtpu's, from the same numpy-seeded
weights and inputs: twins of tests/test_predict_aux.py:29 and 46 (a
Predictor from ``load_checkpoint_predictor`` over a trained Module's
checkpoint equals the Module's ``predict``, ``reshape``, the input
errors) and of tests/test_c_api_ext.py:104 (``partial_forward`` stepped
to the end equals ``forward``; ``output_names`` keeps an internal
output). Also the ``.params`` bytes form of the constructor against the
dict form (bit for bit), ``create``, ``num_steps``, ``num_outputs``,
``symbol_hash`` (the same digest as mxtpu's for the same graph),
``forward_batch`` over buckets, ``reshaped`` over the same weight
tensors, and ``dev_type``. Outputs within 1e-5 of mxtpu's (float32,
other summation orders), bit for bit within the port."""
import logging

import numpy as np
import pytest

import mxtpu as mx
from mxtpu.predict import Predictor as JPredictor


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


def _net(pk, act="relu"):
    net = pk.sym.FullyConnected(pk.sym.Variable("data"), num_hidden=8,
                                name="fc1")
    net = pk.sym.Activation(net, act_type=act, name="relu1")
    net = pk.sym.FullyConnected(net, num_hidden=2, name="fc2")
    return pk.sym.SoftmaxOutput(net, name="softmax")


def _weights(seed=1, d=6):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": rng.randn(8, d).astype(np.float32),
            "fc1_bias": rng.randn(8).astype(np.float32),
            "fc2_weight": rng.randn(2, 8).astype(np.float32),
            "fc2_bias": rng.randn(2).astype(np.float32)}


def _trained(mt, tmp_path):
    """The port's twin of test_predict_aux.py's ``_train_tiny``: a Module
    fit two epochs and checkpointed by the port."""
    rng = np.random.RandomState(0)
    x = rng.rand(32, 6).astype("float32")
    y = (x.sum(1) > 3).astype("float32")
    it = mt.io.NDArrayIter(x, y, batch_size=8, label_name="softmax_label")
    quiet = logging.getLogger("test_torch_predictor_api")
    quiet.setLevel(logging.ERROR)
    mod = mt.mod.Module(_net(mt), context=mt.cpu(), logger=quiet)
    np.random.seed(0)
    mod.fit(it, num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1})
    prefix = str(tmp_path / "tiny")
    mod.save_checkpoint(prefix, 1)
    return prefix, x, mod


def test_predictor_matches_module(mt, tmp_path):
    """Twin of test_predict_aux.py:29, and mxtpu's Predictor over the
    port's checkpoint agrees."""
    prefix, x, mod = _trained(mt, tmp_path)
    pred = mt.predict.load_checkpoint_predictor(prefix, 1, {"data": (8, 6)},
                                                ctx=mt.cpu())
    pred.forward(data=x[:8])
    out = pred.get_output(0)
    assert out.shape == (8, 2)
    ref = mod.predict(mt.io.NDArrayIter(x[:8], None, batch_size=8))
    np.testing.assert_array_equal(out, ref.asnumpy())
    jpred = mx.predict.load_checkpoint_predictor(prefix, 1,
                                                 {"data": (8, 6)})
    jpred.forward(data=x[:8])
    np.testing.assert_allclose(out, jpred.get_output(0), rtol=0, atol=1e-5)
    pred.reshape({"data": (4, 6)})
    pred.forward(data=x[:4])
    np.testing.assert_array_equal(pred.get_output(0), out[:4])


def test_predictor_errors(mt, tmp_path):
    """Twin of test_predict_aux.py:46."""
    prefix, x, _ = _trained(mt, tmp_path)
    pred = mt.predict.load_checkpoint_predictor(prefix, 1, {"data": (8, 6)},
                                                ctx=mt.cpu())
    with pytest.raises(mt.MXNetError):
        pred.set_input("nope", x[:8])
    with pytest.raises(mt.MXNetError):
        pred.set_input("data", x[:4])
    with pytest.raises(mt.MXNetError, match="PartialOut"):
        mt.Predictor(_net(mt).tojson(), {}, ctx=mt.cpu(),
                     input_shapes={"data": (1, 6)}, output_names=["nope"])


@pytest.mark.parametrize("act", ["tanh", "relu"])
def test_partial_forward_matches_full(mt, act):
    """Twin of test_c_api_ext.py:104: stepping partial_forward to the end
    gives forward's outputs (bit for bit in the port, within 1e-5 of
    mxtpu's), a step back restarts, and output_names keeps the internal
    fc1."""
    w = _weights(d=4)
    x = np.random.RandomState(1).randn(3, 4).astype("float32")
    ours = mt.Predictor(_net(mt, act).tojson(), w, ctx=mt.cpu(),
                        input_shapes={"data": (3, 4)})
    ours.forward(data=x)
    full = ours.get_output(0)
    jfull = JPredictor(_net(mx, act).tojson(),
                       {k: mx.nd.array(v) for k, v in w.items()},
                       input_shapes={"data": (3, 4)})
    jfull.forward(data=x)
    np.testing.assert_allclose(full, jfull.get_output(0), rtol=0, atol=1e-5)
    step = mt.Predictor(_net(mt, act).tojson(), w, ctx=mt.cpu(),
                        input_shapes={"data": (3, 4)})
    step.set_input("data", x)
    assert step.num_steps == jfull.num_steps == 10
    left = step.partial_forward(1)
    assert left == step.num_steps - 1
    assert step.partial_forward(5) == step.num_steps - 5
    assert step.partial_forward(2) == step.num_steps - 2  # restarts
    n = 3
    while left:
        left = step.partial_forward(n)
        n += 1
    np.testing.assert_array_equal(step.get_output(0), full)
    assert step._penv == {} and step._pdone == 0  # the walk released
    feat = [P(net.tojson(), ws, input_shapes={"data": (3, 4)},
              output_names=["fc1"], **kw)
            for P, net, ws, kw in (
                (mt.Predictor, _net(mt, act), w, {"ctx": mt.cpu()}),
                (JPredictor, _net(mx, act),
                 {k: mx.nd.array(v) for k, v in w.items()}, {}))]
    for p in feat:
        p.forward(data=x)
    assert feat[0].get_output(0).shape == (3, 8)
    np.testing.assert_allclose(feat[0].get_output(0), feat[1].get_output(0),
                               rtol=0, atol=1e-5)
    by_index = mt.Predictor(_net(mt, act).tojson(), w, ctx=mt.cpu(),
                            input_shapes={"data": (3, 4)}, output_index=3)
    by_index.forward(data=x)
    np.testing.assert_array_equal(by_index.get_output(0),
                                  feat[0].get_output(0))


def test_params_as_bytes_create_and_the_surface(mt, tmp_path):
    """The constructor takes a ``.params`` file's bytes as it takes the
    dict (bit for bit); ``create`` reads the files; num_outputs,
    symbol_hash (mxtpu's digest of the same JSON) and dev_type."""
    w = _weights()
    sym = _net(mt)
    path = str(tmp_path / "w.params")
    mt.nd.save(path, {"arg:" + k: mt.nd.array(v, ctx=mt.cpu())
                      for k, v in w.items()})
    raw = open(path, "rb").read()
    x = np.random.RandomState(2).randn(5, 6).astype("float32")
    outs = []
    for params in (w, raw, bytearray(raw)):
        p = mt.Predictor(sym.tojson(), params, ctx=mt.cpu(),
                         input_shapes={"data": (5, 6)})
        p.forward(data=x)
        outs.append(p.get_output(0))
    sym.save(str(tmp_path / "w-symbol.json"))
    made = mt.predict.create(str(tmp_path / "w-symbol.json"), path,
                             {"data": (5, 6)}, ctx=mt.cpu())
    made.forward(data=x)
    outs.append(made.get_output(0))
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    assert made.num_outputs == 1
    jp = JPredictor(_net(mx).tojson(), raw,
                    input_shapes={"data": (5, 6)})
    jp.forward(data=x)
    np.testing.assert_allclose(outs[0], jp.get_output(0), rtol=0, atol=1e-5)
    assert made.symbol_hash == jp.symbol_hash and len(made.symbol_hash) == 16
    by_type = mt.Predictor(sym.tojson(), w, dev_type="cpu", dev_id=0,
                           input_shapes={"data": (5, 6)})
    assert by_type._ctx == mt.cpu()


def test_forward_batch_and_reshaped(mt):
    """forward_batch pads to the smallest bucket that holds the rows and
    slices them back (each row as the bucket-1 answer, within 1e-5 of
    mxtpu's forward_batch); past the largest bucket raises; reshaped is a
    new Predictor over the same weight tensors."""
    w = _weights()
    x = np.random.RandomState(3).randn(6, 6).astype("float32")
    ours = mt.Predictor(_net(mt).tojson(), w, ctx=mt.cpu(),
                        input_shapes={"data": (1, 6)}, bucket_sizes=(4, 1))
    theirs = JPredictor(_net(mx).tojson(),
                        {k: mx.nd.array(v) for k, v in w.items()},
                        input_shapes={"data": (1, 6)}, bucket_sizes=(1, 4))
    for n in (1, 3, 4):
        got = ours.forward_batch({"data": x[:n]})
        want = theirs.forward_batch({"data": x[:n]})
        assert got[0].shape == (n, 2)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    assert ours._input_shapes == {"data": (4, 6)}
    with pytest.raises(mt.MXNetError, match="exceeds"):
        ours.forward_batch({"data": x[:5]})
    wide = ours.reshaped({"data": (6, 6)})
    assert all(wide._arg_params[k]._data is ours._arg_params[k]._data
               for k in w)
    assert ours._input_shapes == {"data": (4, 6)}
    wide.forward(data=x)
    ours.forward_batch({"data": x[:1]})
    np.testing.assert_allclose(wide.get_output(0)[:1],
                               ours.get_output(0)[:1], rtol=0, atol=1e-6)


def test_forward_batch_keeps_every_row_of_an_example(mt):
    """A deliberate delta: an output with R rows an example (the LM's
    (B*T, vocab)) keeps n*R rows from forward_batch; mxtpu keeps n rows
    whatever R is (the serving rows delta of the port's first slice)."""
    cfg = dict(vocab_size=11, seq_len=5, num_layers=1, num_heads=2,
               d_model=8, d_ff=16)
    sym = mt.models.get_transformer_lm(**cfg)
    rng = np.random.RandomState(4)
    arg_shapes, _, _ = sym.infer_shape(data=(1, 5))
    params = {n: rng.randn(*s).astype(np.float32) * 0.1
              for n, s in zip(sym.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")}
    x = rng.randint(0, 11, (3, 5)).astype(np.float32)
    pred = mt.Predictor(sym.tojson(), params, ctx=mt.cpu(),
                        input_shapes={"data": (1, 5)}, bucket_sizes=(1, 4))
    three = pred.forward_batch({"data": x})[0]
    assert three.shape == (15, 11)
    for i in range(3):
        one = pred.forward_batch({"data": x[i:i + 1]})[0]
        np.testing.assert_allclose(three[5 * i:5 * i + 5], one, rtol=0,
                                   atol=1e-6)
    jsym = mx.models.get_transformer_lm(**cfg)
    jpred = JPredictor(jsym.tojson(),
                       {k: mx.nd.array(v) for k, v in params.items()},
                       input_shapes={"data": (1, 5)}, bucket_sizes=(1, 4))
    assert jpred.forward_batch({"data": x})[0].shape == (3, 11)
