"""The port's RNN op and the ops the recurrent cells use, against mxtpu's.

The same numpy inputs go through mxtpu's op (JAX on the CPU; the RNN op
is its ``lax.scan``) and the port's (PyTorch on the CPU: the per-step
loop). Forward within 1e-5 relative (1e-6 absolute); gradients,
``torch.autograd.grad`` against ``jax.vjp`` under one random head
gradient for every output, within 1e-4 of the largest gradient (the
two sum in other orders). The RNN op runs in every mode, one and two
layers, one and two directions, with and without ``state_outputs``,
with the LSTM state clip, and with batch-1 initial states. The route
the card takes (torch's functional RNN over views of the flat vector,
which is cuDNN's RNN on a CUDA tensor) is held to the loop here on the
CPU, where torch runs its own kernels behind the same call: the weight
order and the gate arithmetic are those of the card's route. Then the
weight-layout helpers against mxtpu's, and SliceChannel/split,
reverse, _zeros and the sequence ops.

torch is imported lazily and pinned to one thread: several test workers
share the host."""
import numpy as np
import pytest

import mxtpu  # noqa: F401  (registers the JAX ops)
from mxtpu.ops import registry as jreg
from mxtpu.ops import rnn as jrnn

FWD_RTOL = 1e-5
FWD_ATOL = 1e-6
GRAD_TOL = 1e-4
T, N, I, H = 4, 3, 5, 4


@pytest.fixture(scope="module")
def tt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return torch, mxtpu_torch


def _r(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _rnn_inputs(mode, bi, layers, seed, state_batch=N):
    d = 2 if bi else 1
    size = jrnn.rnn_param_size(layers, I, H, mode, bi)
    arrays = [_r((T, N, I), seed), _r((size,), seed + 1, 0.4),
              _r((layers * d, state_batch, H), seed + 2, 0.5)]
    if mode == "lstm":
        arrays.append(_r((layers * d, state_batch, H), seed + 3, 0.5))
    return arrays


def _jax_rnn(attrs, arrays, heads):
    """mxtpu's op and its vjp under ``heads``."""
    import jax
    import jax.numpy as jnp
    op = jreg.get_op("RNN")
    a = op.parse_attrs(dict(attrs))
    key = jax.random.PRNGKey(0)

    def f(*xs):
        return tuple(op.fn(a, key, *xs))

    # op by op: compiling each case's scan and its transpose costs more
    # than running them at these sizes
    with jax.disable_jit():
        outs, vjp = jax.vjp(f, *[jnp.asarray(x) for x in arrays])
        grads = vjp(tuple(jnp.asarray(h) for h in heads))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _port_rnn(tt, attrs, arrays, heads):
    torch, mt = tt
    op = mt.ops.registry.get_op("RNN")
    xs = [torch.from_numpy(x.copy()).requires_grad_() for x in arrays]
    outs = op.apply(op.parse_attrs(dict(attrs)), xs)
    grads = torch.autograd.grad(outs, xs, [torch.from_numpy(h)
                                           for h in heads])
    return ([o.detach().numpy() for o in outs],
            [g.numpy() for g in grads])


def _close_grads(got, want):
    scale = max(1.0, max(float(np.abs(w).max()) for w in want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * scale,
                                   err_msg="input %d" % i)


def _rnn_cases():
    out = []
    for mode in ("rnn_relu", "rnn_tanh", "lstm", "gru"):
        for bi in (False, True):
            for layers in (1, 2):
                for so in (False, True):
                    out.append(pytest.param(
                        mode, bi, layers, so, None, N,
                        id="%s-%s-L%d-%s" % (mode, "bi" if bi else "uni",
                                             layers,
                                             "states" if so else "out")))
    for bi in (False, True):
        out.append(pytest.param("lstm", bi, 2, True, (-0.3, 0.25), N,
                                id="lstm-clip-%s" % ("bi" if bi else "uni")))
    for mode in ("lstm", "gru"):
        out.append(pytest.param(mode, True, 2, True, None, 1,
                                id="%s-batch1-state" % mode))
    return out


@pytest.mark.parametrize("mode,bi,layers,so,clip,state_batch", _rnn_cases())
def test_rnn_op_matches_mxtpu(tt, mode, bi, layers, so, clip, state_batch):
    """Forward and every input's gradient (data, parameters, states)."""
    attrs = {"state_size": H, "num_layers": layers, "mode": mode,
             "bidirectional": bi, "state_outputs": so}
    if clip is not None:
        attrs.update(lstm_state_clip_min=clip[0],
                     lstm_state_clip_max=clip[1])
    arrays = _rnn_inputs(mode, bi, layers, 7 * layers + bi, state_batch)
    d = 2 if bi else 1
    shapes = [(T, N, H * d)] + [(layers * d, N, H)] * (
        0 if not so else 2 if mode == "lstm" else 1)
    heads = [_r(s, 50 + i) for i, s in enumerate(shapes)]
    want, want_g = _jax_rnn(attrs, arrays, heads)
    got, got_g = _port_rnn(tt, attrs, arrays, heads)
    assert len(got) == len(want) == (1 if not so else
                                     3 if mode == "lstm" else 2)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=FWD_RTOL, atol=FWD_ATOL)
    _close_grads(got_g, want_g)


@pytest.mark.parametrize("mode", ["rnn_relu", "rnn_tanh", "lstm", "gru"])
@pytest.mark.parametrize("bi", [False, True])
def test_card_route_matches_the_loop(tt, mode, bi):
    """``_vf_rnn`` (cuDNN's RNN on a CUDA tensor) over the flat vector's
    views, against the loop, two layers, forward and gradients, in
    float64 on the CPU: the weight order and gate arithmetic agree to
    rounding."""
    torch, mt = tt
    rnn = mt.ops.rnn
    op = mt.ops.registry.get_op("RNN")
    a = op.parse_attrs({"state_size": H, "num_layers": 2, "mode": mode,
                        "bidirectional": bi, "state_outputs": True})
    d = 2 if bi else 1
    arrays = [torch.from_numpy(x).double().requires_grad_()
              for x in _rnn_inputs(mode, bi, 2, 31)]
    res = []
    for route in ("loop", "vf"):
        layers = rnn._unpack(arrays[1], 2, I, H, mode, d)
        cell = arrays[3] if mode == "lstm" else None
        outs = rnn._loop_rnn(a, None, arrays[0], layers, arrays[2], cell,
                             None) if route == "loop" else \
            rnn._vf_rnn(a, arrays[0], layers, arrays[2], cell, True)
        outs = [o for o in outs if o is not None]
        heads = [torch.from_numpy(_r(o.shape, 60 + i)).double()
                 for i, o in enumerate(outs)]
        grads = torch.autograd.grad(outs, arrays, heads)
        res.append(([o.detach() for o in outs], grads))
    for x, y in zip(res[0][0] + list(res[0][1]), res[1][0] + list(res[1][1])):
        assert float((x - y).abs().max()) < 1e-12


def test_rnn_routes_and_dropout(tt):
    """A CPU tensor takes the loop (the route count moves); p between
    layers drops in training only, and an evaluation forward is p = 0's."""
    torch, mt = tt
    rnn = mt.ops.rnn
    arrays = [mt.nd.array(x, ctx=mt.cpu())
              for x in _rnn_inputs("lstm", False, 2, 3)]
    kw = dict(state_size=H, num_layers=2, mode="lstm")
    before = dict(rnn.ROUTES)
    plain = mt.nd.RNN(*arrays, p=0.0, **kw).asnumpy()
    evaluated = mt.nd.RNN(*arrays, p=0.5, **kw).asnumpy()
    assert rnn.ROUTES["loop"] == before["loop"] + 2
    assert rnn.ROUTES["cudnn"] == before["cudnn"]
    np.testing.assert_array_equal(evaluated, plain)
    with mt.autograd.train_mode():
        mt.random.seed(1)
        a = mt.nd.RNN(*arrays, p=0.5, **kw).asnumpy()
        mt.random.seed(1)
        b = mt.nd.RNN(*arrays, p=0.5, **kw).asnumpy()
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all() and np.abs(a - plain).max() > 1e-3


def test_param_size_and_weight_layout_match_mxtpu(tt):
    """rnn_param_size, rnn_infer_input_size, rnn_unpack_weights and
    rnn_pack_weights against mxtpu's, and the round trips."""
    _, mt = tt
    prnn = mt.ops.rnn
    assert prnn.GATE_COUNT == jrnn.GATE_COUNT
    assert prnn.GATE_NAMES == jrnn.GATE_NAMES
    for mode in ("rnn_relu", "rnn_tanh", "lstm", "gru"):
        for bi in (False, True):
            for layers in (1, 2, 3):
                size = prnn.rnn_param_size(layers, 5, 4, mode, bi)
                assert size == jrnn.rnn_param_size(layers, 5, 4, mode, bi)
                assert prnn.rnn_infer_input_size(size, layers, 4, mode,
                                                 bi) == 5
                flat = _r((size,), layers)
                got = prnn.rnn_unpack_weights(flat, layers, 5, 4, mode, bi)
                want = jrnn.rnn_unpack_weights(flat, layers, 5, 4, mode, bi)
                assert list(got) == list(want)
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k])
                back = prnn.rnn_pack_weights(got, layers, 5, 4, mode, bi)
                np.testing.assert_array_equal(back, flat)
                np.testing.assert_array_equal(
                    back, jrnn.rnn_pack_weights(want, layers, 5, 4, mode,
                                                bi))


def _seq_len():
    return np.array([3, 1, 4], np.float32)


# (op, inputs, attrs, indices of the inputs to differentiate)
OP_CASES = [
    ("SliceChannel", [_r((2, 6, 3), 1)], {"num_outputs": 3}, [0]),
    ("SliceChannel", [_r((4, 3, 2), 2)],
     {"num_outputs": 4, "axis": 0, "squeeze_axis": True}, [0]),
    ("split", [_r((2, 3, 4), 3)], {"num_outputs": 2, "axis": -1}, [0]),
    ("reverse", [_r((2, 3, 4), 4)], {"axis": (1,)}, [0]),
    ("reverse", [_r((2, 3, 4), 5)], {"axis": (0, 2)}, [0]),
    ("flip", [_r((3, 2), 6)], {"axis": 0}, [0]),
    ("_zeros", [], {"shape": (2, 3)}, []),
    ("_zeros", [], {"shape": (1, 4), "dtype": "float16"}, []),
    ("SequenceLast", [_r((4, 3, 2), 7)], {}, [0]),
    ("SequenceLast", [_r((4, 3, 2), 8), _seq_len()],
     {"use_sequence_length": True}, [0]),
    ("SequenceMask", [_r((4, 3, 2), 9)], {}, [0]),
    ("SequenceMask", [_r((4, 3, 2), 10), _seq_len()],
     {"use_sequence_length": True, "value": -1.5}, [0]),
    ("SequenceReverse", [_r((4, 3), 11)], {}, [0]),
    ("SequenceReverse", [_r((4, 3, 2), 12), _seq_len()],
     {"use_sequence_length": True}, [0]),
]
OP_IDS = ["%s-%d" % (c[0], i) for i, c in enumerate(OP_CASES)]


@pytest.mark.parametrize("name,arrays,attrs,diff", OP_CASES, ids=OP_IDS)
def test_cell_ops_match_mxtpu(tt, name, arrays, attrs, diff):
    """Forward of each output and, where differentiable, the gradient
    under one random head per output."""
    import jax
    import jax.numpy as jnp
    torch, mt = tt
    jop = jreg.get_op(name)
    ja = jop.parse_attrs(dict(attrs))

    def jf(*xs):
        full = [jnp.asarray(x) for x in arrays]
        for i, x in zip(diff, xs):
            full[i] = x
        out = jop.fn(ja, *full)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)

    want, vjp = jax.vjp(jf, *[jnp.asarray(arrays[i]) for i in diff])
    op = mt.ops.registry.get_op(name)
    xs = [torch.from_numpy(a.copy()) for a in arrays]
    for i in diff:
        xs[i].requires_grad_()
    got = op.apply(op.parse_attrs(dict(attrs)), xs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).endswith(str(w.dtype))
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=FWD_RTOL,
                                   atol=FWD_ATOL)
    if not diff:
        return
    heads = [_r(np.asarray(w).shape, 70 + i) for i, w in enumerate(want)]
    want_g = [np.asarray(g) for g in vjp(tuple(jnp.asarray(h)
                                               for h in heads))]
    got_g = torch.autograd.grad(got, [xs[i] for i in diff],
                                [torch.from_numpy(h) for h in heads])
    _close_grads([g.numpy() for g in got_g], want_g)


def test_nd_and_sym_forms(tt):
    """``nd.<op>``/``sym.<op>`` of the new ops, and ``sym.zeros`` making
    its output on the executor's device."""
    torch, mt = tt
    x = _r((2, 6), 20)
    with mt.cpu():
        a = mt.nd.array(x)
        parts = mt.nd.split(a, num_outputs=3)
        assert [p.shape for p in parts] == [(2, 2)] * 3
        np.testing.assert_array_equal(mt.nd.reverse(a, axis=1).asnumpy(),
                                      x[:, ::-1])
        z = mt.nd._zeros(shape=(2, 2))
        assert z.context == mt.cpu() and not z.asnumpy().any()
    data = mt.sym.Variable("data")
    net = mt.sym.SliceChannel(data, num_outputs=2)[1] + \
        mt.sym.zeros(shape=(1, 3))
    assert len(mt.sym.SliceChannel(data, num_outputs=2)) == 2
    exe = net.bind(mt.cpu(), {"data": mt.nd.array(x, ctx=mt.cpu())})
    np.testing.assert_array_equal(exe.forward()[0].asnumpy(), x[:, 3:])
    assert net.infer_shape(data=(2, 6))[1] == [(2, 3)]
