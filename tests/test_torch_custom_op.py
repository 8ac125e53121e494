"""The ``Custom`` op and ``mx.operator`` in the port, against mxtpu's: one
body of each user op registered in both packages, run through
``nd.Custom`` (with and without ``autograd``), a bound ``sym.Custom``, a
loss op with ``need_top_grad=False`` trained by ``Module.fit``, the
``is_train`` the body sees under ``fit`` and ``predict``, auxiliary
states, ``_NoGradient``, shape inference from the prop (never the body),
a graph carried across the packages through its JSON, and the per-call
seed: the same in a call's forward and backward, another in the next
call (the port draws it from the device's generator, mxtpu from its
PRNG key, so the two packages' seeds differ by design).

torch is imported lazily and pinned to one thread."""
import numpy as np
import pytest

import mxtpu

RTOL = 1e-6


@pytest.fixture(scope="module")
def tt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return torch, mxtpu_torch


def _register(pkg, op_type, body, prop_methods, need_top_grad=True,
              ctor=None):
    """Register ``op_type`` in ``pkg.operator``: a CustomOp with
    ``body``'s methods and a prop with ``prop_methods``."""
    op_cls = type("Op", (pkg.operator.CustomOp,), dict(body))

    def __init__(self, **kwargs):
        pkg.operator.CustomOpProp.__init__(self, need_top_grad)
        self.kwargs = kwargs
        if ctor:
            ctor(self, **kwargs)

    def create_operator(self, ctx, shapes, dtypes):
        op = op_cls()
        op.prop = self
        return op

    methods = dict(prop_methods, __init__=__init__,
                   create_operator=create_operator)
    pkg.operator.register(op_type)(
        type("Prop", (pkg.operator.CustomOpProp,), methods))


def _sigmoid_fwd(self, is_train, req, in_data, out_data, aux):
    x = in_data[0].asnumpy()
    self.assign(out_data[0], req[0], 1 / (1 + np.exp(-x)))


def _sigmoid_bwd(self, req, out_grad, in_data, out_data, in_grad, aux):
    y = out_data[0].asnumpy()
    self.assign(in_grad[0], req[0], out_grad[0].asnumpy() * y * (1 - y))


SIGMOID = "port_test_sigmoid"


@pytest.fixture(scope="module", autouse=True)
def registered(tt):
    """The test ops, in both packages."""
    torch, mt = tt
    for pkg in (mt, mxtpu):
        _register(pkg, SIGMOID, {"forward": _sigmoid_fwd,
                                 "backward": _sigmoid_bwd}, {})
        _register(pkg, "port_test_softmax_loss", {
            "forward": _softmax_fwd, "backward": _softmax_bwd},
            {"list_arguments": lambda self: ["data", "label"],
             "infer_shape": _softmax_shape}, need_top_grad=False)
        _register(pkg, "port_test_train_flag", {
            "forward": _flag_fwd, "backward": _sigmoid_bwd}, {})
        _register(pkg, "port_test_aux", {
            "forward": _aux_fwd, "backward": _aux_bwd},
            {"list_auxiliary_states": lambda self: ["scale"],
             "infer_shape": lambda self, s: (s, [s[0]], [[1]])})
        _register(pkg, "port_test_dropout", {
            "forward": _drop_fwd, "backward": _drop_bwd}, {})
        _register(pkg, "port_test_scaled", {
            "forward": _scaled_fwd, "backward": _scaled_bwd}, {},
            ctor=lambda self, factor="1": setattr(self, "factor",
                                                  float(factor)))
    return True


def test_nd_custom_forward_and_autograd(tt):
    torch, mt = tt
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)

    def body(pkg):
        a = pkg.nd.array(x)
        plain = pkg.nd.Custom(a, op_type=SIGMOID)
        a.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.Custom(a, op_type=SIGMOID)
            loss = pkg.nd.sum(y * y)
        loss.backward()
        return [plain.asnumpy(), y.asnumpy(), a.grad.asnumpy()]

    with mt.cpu():
        got = body(mt)
    want = body(mxtpu)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-7)
    s = 1 / (1 + np.exp(-x))
    np.testing.assert_allclose(got[2], 2 * s * s * (1 - s), rtol=1e-5)


def test_bound_symbol_forward_and_backward(tt):
    torch, mt = tt
    x = np.random.RandomState(1).randn(2, 3).astype(np.float32)
    head = np.random.RandomState(2).randn(2, 3).astype(np.float32)

    def body(pkg):
        y = pkg.sym.Custom(pkg.sym.Variable("data"), op_type=SIGMOID,
                           name="sig")
        ex = y.simple_bind(pkg.cpu(), data=(2, 3))
        out = ex.forward(is_train=True, data=pkg.nd.array(x, ctx=pkg.cpu()))
        ex.backward([pkg.nd.array(head, ctx=pkg.cpu())])
        return [out[0].asnumpy(), ex.grad_dict["data"].asnumpy(),
                y.list_arguments(), y.list_outputs()]

    got, want = body(mt), body(mxtpu)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL)
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=1e-7)
    assert got[2:] == want[2:]


# ---- a loss op with need_top_grad=False, trained by Module.fit
def _softmax_fwd(self, is_train, req, in_data, out_data, aux):
    x = in_data[0].asnumpy()
    e = np.exp(x - x.max(axis=1, keepdims=True))
    self.assign(out_data[0], req[0], e / e.sum(axis=1, keepdims=True))


def _softmax_bwd(self, req, out_grad, in_data, out_data, in_grad, aux):
    lab = in_data[1].asnumpy().astype(np.int64)
    y = out_data[0].asnumpy().copy()
    y[np.arange(lab.shape[0]), lab] -= 1.0
    self.assign(in_grad[0], req[0], y)
    self.assign(in_grad[1], req[1], np.zeros_like(lab, np.float32))


def _softmax_shape(self, in_shape):
    return [in_shape[0], [in_shape[0][0]]], [in_shape[0]], []


def _mlp_loss(pkg):
    data = pkg.sym.Variable("data")
    fc = pkg.sym.FullyConnected(data, num_hidden=3, name="fc")
    return pkg.sym.Custom(fc, pkg.sym.Variable("softmax_label"),
                          op_type="port_test_softmax_loss", name="sm")


def test_loss_op_without_top_grad_trains_through_fit(tt):
    """``need_top_grad=False``: the op is the graph's head and makes its
    own gradient. Two epochs of ``fit`` from the same weights, SGD, in
    both packages; the label's shape comes from the prop
    (``infer_args``) in ``simple_bind``."""
    torch, mt = tt
    rng = np.random.RandomState(3)
    x = rng.randn(16, 5).astype(np.float32)
    y = rng.randint(0, 3, 16).astype(np.float32)
    w0 = rng.randn(3, 5).astype(np.float32) * 0.1

    def run(pkg):
        mod = pkg.mod.Module(_mlp_loss(pkg), context=pkg.cpu())
        it = pkg.io.NDArrayIter(x, y, batch_size=8)
        mod.fit(it, num_epoch=2, optimizer="sgd",
                optimizer_params={"learning_rate": 0.5},
                arg_params={"fc_weight": pkg.nd.array(w0),
                            "fc_bias": pkg.nd.zeros((3,))},
                initializer=pkg.initializer.Zero(), eval_metric="acc")
        shapes = _mlp_loss(pkg).infer_shape(data=(8, 5))[0]
        return mod.get_params()[0], shapes

    with mt.cpu():
        got, got_shapes = run(mt)
    want, want_shapes = run(mxtpu)
    assert got_shapes == want_shapes
    for k in ("fc_weight", "fc_bias"):
        np.testing.assert_allclose(got[k].asnumpy(), want[k].asnumpy(),
                                   rtol=1e-5, atol=1e-6)
    assert not np.allclose(got["fc_weight"].asnumpy(), w0)


# ---- the is_train the body sees
SEEN = []


def _flag_fwd(self, is_train, req, in_data, out_data, aux):
    SEEN.append(bool(is_train))
    _sigmoid_fwd(self, is_train, req, in_data, out_data, aux)


def test_is_train_under_fit_predict_and_autograd(tt):
    torch, mt = tt
    x = np.random.RandomState(4).randn(8, 4).astype(np.float32)
    lab = np.zeros(8, np.float32)

    def run(pkg):
        del SEEN[:]
        data = pkg.sym.Variable("data")
        act = pkg.sym.Custom(pkg.sym.FullyConnected(data, num_hidden=2),
                             op_type="port_test_train_flag")
        net = pkg.sym.SoftmaxOutput(act, name="softmax")
        mod = pkg.mod.Module(net, context=pkg.cpu())
        mod.fit(pkg.io.NDArrayIter(x, lab, batch_size=4), num_epoch=1,
                initializer=pkg.initializer.Uniform(0.1))
        in_fit = list(SEEN)
        del SEEN[:]
        mod.predict(pkg.io.NDArrayIter(x, lab, batch_size=4))
        in_predict = list(SEEN)
        del SEEN[:]
        a = pkg.nd.array(x)
        with pkg.autograd.record(train_mode=True):
            pkg.nd.Custom(a, op_type="port_test_train_flag")
        with pkg.autograd.record(train_mode=False):
            pkg.nd.Custom(a, op_type="port_test_train_flag")
        pkg.nd.Custom(a, op_type="port_test_train_flag")
        return in_fit, in_predict, list(SEEN)

    with mt.cpu():
        got = run(mt)
    want = run(mxtpu)
    assert got == want
    assert set(got[0]) == {True} and set(got[1]) == {False}
    assert got[2] == [True, False, False]


# ---- auxiliary states
def _aux_fwd(self, is_train, req, in_data, out_data, aux):
    self.assign(out_data[0], req[0],
                in_data[0].asnumpy() * aux[0].asnumpy()[0])


def _aux_bwd(self, req, out_grad, in_data, out_data, in_grad, aux):
    self.assign(in_grad[0], req[0],
                out_grad[0].asnumpy() * aux[0].asnumpy()[0])


def test_auxiliary_states(tt):
    """A prop's auxiliary state is an input of the node, after the
    arguments, as in mxtpu (where it lists among the graph's
    arguments)."""
    torch, mt = tt
    x = np.random.RandomState(5).randn(2, 3).astype(np.float32)

    def body(pkg):
        y = pkg.sym.Custom(pkg.sym.Variable("data"), op_type="port_test_aux",
                           name="aux")
        args = {"data": pkg.nd.array(x, ctx=pkg.cpu()),
                "aux_scale": pkg.nd.array(np.array([2.5], np.float32),
                                          ctx=pkg.cpu())}
        ex = y.bind(pkg.cpu(), args)
        return (y.list_arguments(), y.list_auxiliary_states(),
                ex.forward()[0].asnumpy())

    got, want = body(mt), body(mxtpu)
    assert got[:2] == want[:2]
    np.testing.assert_allclose(got[2], want[2], rtol=RTOL)
    np.testing.assert_allclose(got[2], 2.5 * x, rtol=RTOL)


def test_no_gradient(tt):
    torch, mt = tt
    with mt.cpu():
        got = mt.nd._NoGradient()
    want = mxtpu.nd._NoGradient()
    assert got.shape == want.shape == (1,)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


# ---- the per-call seed
MASKS = []


def _mask(self, shape):
    return np.random.RandomState(self._mxtpu_rng_seed).rand(*shape) > 0.5


def _drop_fwd(self, is_train, req, in_data, out_data, aux):
    m = _mask(self, in_data[0].shape)
    MASKS.append(("fwd", self._mxtpu_rng_seed, m))
    self.assign(out_data[0], req[0], in_data[0].asnumpy() * m)


def _drop_bwd(self, req, out_grad, in_data, out_data, in_grad, aux):
    m = _mask(self, in_data[0].shape)
    MASKS.append(("bwd", self._mxtpu_rng_seed, m))
    self.assign(in_grad[0], req[0], out_grad[0].asnumpy() * m)


def test_the_seed_of_a_call_is_one_in_forward_and_backward(tt):
    torch, mt = tt
    x = np.ones((4, 6), np.float32)
    del MASKS[:]
    with mt.cpu():
        mt.random.seed(7)
        grads = []
        for _ in range(2):
            a = mt.nd.array(x)
            a.attach_grad()
            with mt.autograd.record():
                y = mt.nd.Custom(a, op_type="port_test_dropout")
            y.backward()
            grads.append((y.asnumpy(), a.grad.asnumpy()))
    assert [k for k, _, _ in MASKS] == ["fwd", "bwd", "fwd", "bwd"]
    (_, s0, m0), (_, s1, m1), (_, s2, m2), (_, s3, _) = MASKS
    assert s0 == s1 and s2 == s3 and s0 != s2
    np.testing.assert_array_equal(m0, m1)
    for (out, grad), m in zip(grads, (m0, m2)):
        np.testing.assert_array_equal(out, m.astype(np.float32))
        np.testing.assert_array_equal(grad, m.astype(np.float32))
    # the seed comes from the device's generator: reseeding replays it
    del MASKS[:]
    with mt.cpu():
        mt.random.seed(7)
        mt.nd.Custom(mt.nd.array(x), op_type="port_test_dropout")
    assert MASKS[0][1] == s0


# ---- kwargs, shape inference, and a graph across the packages
def _scaled_fwd(self, is_train, req, in_data, out_data, aux):
    self.assign(out_data[0], req[0],
                in_data[0].asnumpy() * self.prop.factor)


def _scaled_bwd(self, req, out_grad, in_data, out_data, in_grad, aux):
    self.assign(in_grad[0], req[0],
                out_grad[0].asnumpy() * self.prop.factor)


def test_shape_inference_never_runs_the_body(tt):
    torch, mt = tt
    del SEEN[:]
    y = mt.sym.Custom(mt.sym.Variable("data"), op_type="port_test_train_flag")
    arg, out, aux = y.infer_shape(data=(5, 7))
    assert out == [(5, 7)] and SEEN == []
    net = _mlp_loss(mt)
    arg, out, _ = net.infer_shape(data=(4, 5))
    assert dict(zip(net.list_arguments(), arg))["softmax_label"] == (4,)


def test_a_graph_with_custom_kwargs_crosses_the_packages(tt):
    """The op's kwargs reach its prop as strings, and survive ``tojson``
    into mxtpu's ``load_json`` and back into the port's."""
    torch, mt = tt
    x = np.random.RandomState(6).randn(2, 3).astype(np.float32)
    y = mt.sym.Custom(mt.sym.Variable("data"), op_type="port_test_scaled",
                      factor=2.5, name="scaled")
    js = y.tojson()
    outs = []
    for pkg, s in ((mt, y), (mxtpu, mxtpu.sym.load_json(js)),
                   (mt, mt.sym.load_json(js))):
        ex = s.bind(pkg.cpu(), {"data": pkg.nd.array(x, ctx=pkg.cpu())})
        outs.append(ex.forward()[0].asnumpy())
    for o in outs:
        np.testing.assert_allclose(o, 2.5 * x, rtol=RTOL)


def test_replica_walk_refuses_a_custom_op(tt):
    """Module over two contexts walks the graph over both replicas in
    lockstep; a Custom op's body sees one replica's rows and has no form
    over several, so the walk raises (naming the op) rather than compute
    a per-replica answer."""
    torch, mt = tt
    x = np.random.RandomState(8).randn(8, 4).astype(np.float32)
    data = mt.sym.Variable("data")
    act = mt.sym.Custom(mt.sym.FullyConnected(data, num_hidden=2),
                        op_type=SIGMOID, name="sig")
    mod = mt.mod.Module(mt.sym.SoftmaxOutput(act, name="softmax"),
                        context=[mt.cpu(0), mt.cpu(1)])
    with pytest.raises(mt.MXNetError, match="Custom 'sig'"):
        mod.fit(mt.io.NDArrayIter(x, np.zeros(8, np.float32), batch_size=4),
                num_epoch=1, initializer=mt.initializer.Uniform(0.1))
