"""Symbol JSON interchange between mxtpu and mxtpu_torch: mxtpu's
``tojson()`` loads straight into ``mxtpu_torch.symbol.load_json`` and
back, with the same arguments, outputs and inferred shapes; and the
port's transformer factory builds the same graph as mxtpu's."""
import json

import numpy as np
import pytest

import mxtpu as mx


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


LM_CONFIGS = [
    dict(vocab_size=32, seq_len=16, num_layers=2, num_heads=4, d_model=32),
    dict(vocab_size=50, seq_len=8, num_layers=1, num_heads=2, d_model=16,
         max_len=16),
    dict(vocab_size=24, seq_len=16, num_layers=2, num_heads=2, d_model=32,
         dtype="bfloat16"),
    dict(vocab_size=40, seq_len=12, num_layers=1, num_heads=3, d_model=24,
         d_ff=40, dropout=0.1),
]
IDS = ["base", "max_len", "bf16", "dropout_dff"]


def _graph(js):
    """Ops, attrs and wiring of a symbol JSON (auto-generated node names
    differ between processes' name counters, so they are left out)."""
    nodes = json.loads(js)["nodes"]
    return [(n["op"], n["name"] if n["op"] == "null" else None,
             n.get("attrs"), n["inputs"]) for n in nodes]


@pytest.mark.parametrize("cfg", LM_CONFIGS, ids=IDS)
def test_mxtpu_json_round_trips_through_the_port(mt, cfg):
    jsym = mx.models.get_transformer_lm(**cfg)
    tsym = mt.symbol.load_json(jsym.tojson())
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_outputs() == jsym.list_outputs()
    assert tsym.list_auxiliary_states() == jsym.list_auxiliary_states()
    back = mx.symbol.load_json(tsym.tojson())
    assert _graph(back.tojson()) == _graph(jsym.tojson())


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("cfg", LM_CONFIGS, ids=IDS)
def test_infer_shape_matches_mxtpu(mt, cfg, batch):
    jsym = mx.models.get_transformer_lm(**cfg)
    tsym = mt.symbol.load_json(jsym.tojson())
    shape = (batch, cfg["seq_len"])
    want = jsym.infer_shape(data=shape)
    got = tsym.infer_shape(data=shape)
    assert [list(map(tuple, x)) for x in got] == \
        [list(map(tuple, x)) for x in want]


@pytest.mark.parametrize("cfg", LM_CONFIGS, ids=IDS)
def test_port_factory_builds_the_mxtpu_graph(mt, cfg):
    jsym = mx.models.get_transformer_lm(**cfg)
    tsym = mt.models.get_transformer_lm(**cfg)
    assert tsym.list_arguments() == jsym.list_arguments()
    assert _graph(tsym.tojson()) == _graph(jsym.tojson())


def test_infer_shape_names_the_missing_input(mt):
    tsym = mt.models.get_transformer_lm(vocab_size=8, seq_len=4,
                                        num_layers=1, num_heads=1,
                                        d_model=8)
    with pytest.raises(mt.MXNetError, match="data"):
        tsym.infer_shape()


def test_unknown_op_in_json_raises(mt):
    js = mx.sym.Convolution(mx.sym.Variable("x"), kernel=(3, 3),
                            num_filter=2).tojson()
    with pytest.raises(mt.MXNetError, match="unknown op 'Convolution'"):
        mt.symbol.load_json(js)


def test_bound_executor_runs_the_loaded_graph(mt):
    """Symbol.bind on cpu() and forward against mxtpu's executor."""
    jsym = mx.models.get_transformer_lm(vocab_size=16, seq_len=8,
                                        num_layers=1, num_heads=2,
                                        d_model=16)
    args, _, _ = jsym.infer_shape(data=(2, 8))
    rng = np.random.RandomState(1)
    vals = {}
    for n, s in zip(jsym.list_arguments(), args):
        vals[n] = (rng.randint(0, 16, s) if n == "data"
                   else rng.randn(*s) * 0.3).astype(np.float32)
    jex = jsym.bind(mx.cpu(), {n: mx.nd.array(v) for n, v in vals.items()},
                    grad_req="null")
    want = jex.forward(is_train=False)[0].asnumpy()
    tsym = mt.symbol.load_json(jsym.tojson())
    tex = tsym.bind(mt.cpu(), {n: mt.nd.array(v, ctx=mt.cpu())
                               for n, v in vals.items()})
    got = tex.forward(is_train=False)[0].asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(mt.MXNetError, match="training"):
        tex.forward(is_train=True)
