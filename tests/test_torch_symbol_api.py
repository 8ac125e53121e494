"""The port's Symbol and Executor inspection surface against mxtpu's, from
the same numpy-seeded weights and inputs (twins of
tests/test_symbol_executor.py:37, 57 and 104, and of the rest of the
surface): ``infer_shape_partial``, ``get_internals`` (aux-update
outputs hidden), ``get_children``, ``list_inputs``, ``list_attr``,
``infer_type``, ``eval``, ``grad``, ``debug_str``; the Executor's
``arg_arrays``/``aux_arrays``, ``copy_params_from``, ``reshape`` (the
parameter tensors shared, new inputs only), the ``simple_bind`` method,
and ``set_monitor_callback`` (every op's visible outputs by name, as
mxtpu's per-op walk hands them over). Outputs within 1e-5 (float32,
other summation orders); names, shapes and dtypes exactly."""
import numpy as np
import pytest

import mxtpu as mx


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


def _mlp(pk):
    data = pk.sym.Variable("data")
    net = pk.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = pk.sym.Activation(net, act_type="relu", name="relu1")
    net = pk.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return pk.sym.SoftmaxOutput(net, name="softmax")


def _bn_net(pk):
    data = pk.sym.Variable("data")
    net = pk.sym.Convolution(data, num_filter=4, kernel=(3, 3), pad=(1, 1),
                             name="conv0")
    net = pk.sym.BatchNorm(net, name="bn0")
    net = pk.sym.Activation(net, act_type="relu", name="relu0")
    net = pk.sym.Flatten(net, name="flat")
    return pk.sym.FullyConnected(net, num_hidden=3, name="fc")


def _values(sym, shapes, seed=0):
    """{name: numpy} for every argument and aux state of ``sym``."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    vals = {n: rng.randn(*s).astype(np.float32) * 0.5
            for n, s in zip(sym.list_arguments(), arg_shapes)}
    vals.update({n: rng.rand(*s).astype(np.float32) + 0.5
                 for n, s in zip(sym.list_auxiliary_states(), aux_shapes)})
    return vals


def _bind(pk, sym, vals, ctx):
    args = {n: pk.nd.array(vals[n], ctx=ctx) for n in sym.list_arguments()}
    aux = {n: pk.nd.array(vals[n], ctx=ctx)
           for n in sym.list_auxiliary_states()}
    return sym.bind(ctx, args, aux_states=aux)


def test_infer_shape_partial(mt):
    """Twin of test_symbol_executor.py:37: nothing known gives None
    throughout, as in mxtpu; a known data shape fills what it can."""
    for fn in (lambda pk: pk.sym.FullyConnected(pk.sym.Variable("data"),
                                                num_hidden=4, name="fc"),
               _mlp):
        assert fn(mt).infer_shape_partial() == fn(mx).infer_shape_partial()
        got = fn(mt).infer_shape_partial(data=(8, 10))
        assert got == fn(mx).infer_shape_partial(data=(8, 10))
        assert got[1] == [(8, 4)]
    with pytest.raises(mt.MXNetError):
        _mlp(mt).infer_shape()


@pytest.mark.parametrize("net", [_mlp, _bn_net])
def test_get_internals(mt, net):
    """Twin of test_symbol_executor.py:57: the same internal outputs in
    the same order (BatchNorm's moving-statistic updates hidden), and an
    internal output composes into a graph of its own."""
    ours, theirs = net(mt).get_internals(), net(mx).get_internals()
    assert ours.list_outputs() == theirs.list_outputs()
    name = ours.list_outputs()[3]
    assert ours[name].list_arguments() == theirs[name].list_arguments()
    fc1 = _mlp(mt).get_internals()["fc1_output"]
    assert fc1.list_arguments() == ["data", "fc1_weight", "fc1_bias"]


@pytest.mark.parametrize("net", [_mlp, _bn_net])
def test_listing_children_attrs_and_debug_str(mt, net):
    ours, theirs = net(mt), net(mx)
    assert ours.list_inputs() == theirs.list_inputs()
    assert ours.get_children().list_outputs() == \
        theirs.get_children().list_outputs()
    assert ours.get_children().get_children().list_outputs() == \
        theirs.get_children().get_children().list_outputs()
    assert mt.sym.Variable("x").get_children() is None
    assert ours.list_attr() == theirs.list_attr()
    assert ours.debug_str() == theirs.debug_str()
    with pytest.raises(mt.MXNetError, match="deprecated"):
        ours.list_attr(recursive=True)
    with pytest.raises(mt.MXNetError, match="bind"):
        ours.grad(["data"])


@pytest.mark.parametrize("hints", [{}, {"data": "float32"},
                                   {"data": "float16"}])
def test_infer_type(mt, hints):
    """Numpy dtypes, forward from the hints (an untyped graph stays
    None), the same as mxtpu's types-only walk; a Cast's dtype wins."""
    for net in (_mlp, _bn_net):
        assert net(mt).infer_type(**hints) == net(mx).infer_type(**hints)
    cast = [pk.sym.Cast(pk.sym.Variable("a"), dtype="float16") + 1
            for pk in (mt, mx)]
    assert cast[0].infer_type(a="float32") == cast[1].infer_type(a="float32")
    assert cast[0].infer_type(a="float32")[1] == [np.dtype("float16")]


def test_eval_matches_mxtpu(mt):
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    got = [(pk.sym.Variable("a") * 2 + 1).eval(
        ctx=pk.cpu(), a=pk.nd.array(a, ctx=pk.cpu()))[0].asnumpy()
        for pk in (mt, mx)]
    np.testing.assert_array_equal(got[0], got[1])


def test_executor_arrays_and_copy_params_from(mt):
    sym = _bn_net(mt)
    vals = _values(sym, {"data": (2, 3, 5, 5)})
    ex = _bind(mt, sym, {n: np.zeros_like(v) for n, v in vals.items()},
               mt.cpu())
    assert [a.shape for a in ex.arg_arrays] == \
        [tuple(vals[n].shape) for n in sym.list_arguments()]
    assert [a is ex.aux_dict[n] for n, a in
            zip(sym.list_auxiliary_states(), ex.aux_arrays)] == [True] * 2
    weight = ex.arg_dict["fc_weight"]._data
    ex.copy_params_from({n: mt.nd.array(vals[n], ctx=mt.cpu())
                         for n in sym.list_arguments()},
                        {n: vals[n] for n in sym.list_auxiliary_states()})
    assert ex.arg_dict["fc_weight"]._data is weight  # copied in place
    for n in sym.list_arguments() + sym.list_auxiliary_states():
        d = ex.arg_dict if n in ex.arg_dict else ex.aux_dict
        np.testing.assert_array_equal(d[n].asnumpy(), vals[n])
    with pytest.raises(mt.MXNetError, match="not in arguments"):
        ex.copy_params_from({"extra": np.zeros(1)})
    ex.copy_params_from({"extra": np.zeros(1)}, allow_extra_params=True)
    jex = _bind(mx, _bn_net(mx), vals, mx.cpu())
    np.testing.assert_allclose(ex.forward()[0].asnumpy(),
                               jex.forward()[0].asnumpy(), rtol=0,
                               atol=1e-5)


def test_executor_reshape(mt):
    """Twin of test_symbol_executor.py:104: the reshaped executor runs at
    the new batch, its parameter (and gradient) arrays are the same
    objects, its inputs new; it equals mxtpu's reshaped executor."""
    outs = []
    for pk in (mt, mx):
        net = _mlp(pk)
        ex = net.simple_bind(ctx=pk.cpu(), data=(4, 6))
        vals = _values(net, {"data": (8, 6)}, seed=3)
        for n in ("fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias"):
            ex.arg_dict[n][:] = pk.nd.array(vals[n], ctx=pk.cpu())
        ex2 = ex.reshape(data=(8, 6), softmax_label=(8,))
        assert ex2.arg_dict["fc1_weight"] is ex.arg_dict["fc1_weight"]
        assert ex2.arg_dict["data"] is not ex.arg_dict["data"]
        ex2.arg_dict["data"][:] = pk.nd.array(vals["data"], ctx=pk.cpu())
        outs.append(ex2.forward()[0].asnumpy())
        assert outs[-1].shape == (8, 4)
        if pk is mt:
            assert ex2.grad_dict["fc1_weight"] is ex.grad_dict["fc1_weight"]
            assert ex2.grad_dict["data"] is not ex.grad_dict["data"]
            assert ex.arg_dict["data"].shape == (4, 6)
    np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=1e-5)


def test_simple_bind_method_is_the_function(mt):
    net = _mlp(mt)
    ex = mt.executor.Executor.simple_bind(net, mt.cpu(), data=(2, 5))
    assert sorted(ex.arg_dict) == sorted(net.list_arguments())
    assert ex.arg_dict["fc1_weight"].shape == (16, 5)
    assert ex.grad_dict["fc1_weight"].shape == (16, 5)


@pytest.mark.parametrize("is_train", [False, True])
def test_monitor_callback_sees_every_op_output(mt, is_train):
    """The callback gets the same names as mxtpu's per-op walk, BatchNorm's
    output included though the inference plan fuses it with its ReLU,
    and the same values; an inactive callback leaves the fused plan."""
    vals = _values(_bn_net(mt), {"data": (2, 3, 5, 5)}, seed=1)
    seen = []
    for pk in (mt, mx):
        ex = _bind(pk, _bn_net(pk), vals, pk.cpu())
        got = {}

        def cb(name, arr, got=got):
            got[name] = arr.asnumpy().copy()
        ex.set_monitor_callback(cb)
        ex.forward(is_train=is_train)
        seen.append(got)
    assert list(seen[0]) == list(seen[1])
    assert "bn0_output" in seen[0] and "relu0_output" in seen[0]
    for name in seen[0]:
        np.testing.assert_allclose(seen[0][name], seen[1][name], rtol=0,
                                   atol=1e-5, err_msg=name)
    ex = _bind(mt, _bn_net(mt), vals, mt.cpu())
    calls = []

    def idle(name, arr):
        calls.append(name)
    idle.is_active = lambda: False
    ex.set_monitor_callback(idle)
    ex.forward()
    assert calls == [] and ex.fused_sites == 1
