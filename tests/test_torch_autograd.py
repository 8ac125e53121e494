"""mxtpu_torch.autograd against mxtpu.autograd: the twelve cases of
tests/test_autograd.py, each run by one body through both packages (the
port on cpu()) from the same numpy inputs. Gradients agree within
1e-6 (float32; the two sum in other orders) and each with its closed
form; Dropout is compared by its statistics (its mask comes from torch's
generator, not threefry). Then the port's own contract: torch's
``.grad`` is never written, backward without record() raises, ``out=``
and in-place updates of a recorded array raise while recording, and
retain_graph keeps the tape for a second backward.

torch is imported lazily and pinned to one thread: several test workers
share the host."""
import numpy as np
import pytest

import mxtpu

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


def _run(pkg, case):
    """``case(pkg)`` with the package's arrays on the CPU."""
    if pkg is mxtpu:
        return case(pkg)
    with pkg.cpu():
        return case(pkg)


def simple_grad(mx):
    x = mx.nd.array(np.array([[1.0, 2], [3, 4]]))
    x.attach_grad()
    with mx.autograd.record():
        y = (x * x).sum()
    y.backward()
    return {"x": x.grad.asnumpy(), "want": 2 * x.asnumpy()}


def chain_grad(mx):
    x = mx.nd.array(np.array([1.0, 2, 3]))
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.exp(x)
        z = (y * y).sum()
    z.backward()
    return {"x": x.grad.asnumpy(), "want": 2 * np.exp(2 * x.asnumpy())}


def head_grads(mx):
    x = mx.nd.array(np.array([1.0, 2, 3]))
    x.attach_grad()
    with mx.autograd.record():
        y = x * 2
    y.backward(mx.nd.array(np.array([1.0, 10, 100])))
    return {"x": x.grad.asnumpy(), "want": np.array([2.0, 20, 200])}


def training_modes(mx):
    ag = mx.autograd
    seen = [ag.is_training()]
    with ag.record():
        seen += [ag.is_recording(), ag.is_training()]
    with ag.record(train_mode=False):
        seen += [ag.is_recording(), ag.is_training()]
    with ag.train_mode():
        seen.append(ag.is_training())
        with ag.predict_mode():
            seen.append(ag.is_training())
    return {"flags": np.array(seen, np.float32),
            "want": np.array([0, 1, 1, 1, 0, 1, 0], np.float32)}


def pause(mx):
    x = mx.nd.ones((2,))
    x.attach_grad()
    with mx.autograd.record():
        y = x * 2
        with mx.autograd.pause():
            y * 3  # not recorded
        w = (y * y).sum()
    w.backward()
    return {"x": x.grad.asnumpy(), "want": np.full(2, 8.0)}


def grad_add_req(mx):
    x = mx.nd.array(np.array([1.0, 2]))
    grad = mx.nd.zeros((2,))
    mx.autograd.mark_variables([x], [grad], "add")
    for _ in range(2):
        with mx.autograd.record():
            y = (x * x).sum()
        y.backward()
    return {"x": grad.asnumpy(), "want": 2 * 2 * x.asnumpy()}


def detach(mx):
    x = mx.nd.array(np.array([2.0]))
    x.attach_grad()
    with mx.autograd.record():
        y = x * 3
        z = y.detach() * x
    z.backward()
    return {"x": x.grad.asnumpy(), "want": np.array([6.0])}


def multi_variable(mx):
    a = mx.nd.array(np.array([1.0, 2]))
    b = mx.nd.array(np.array([3.0, 4]))
    a.attach_grad()
    b.attach_grad()
    with mx.autograd.record():
        c = (a * b).sum()
    c.backward()
    return {"a": a.grad.asnumpy(), "b": b.grad.asnumpy(),
            "want": np.concatenate([b.asnumpy(), a.asnumpy()])}


def dropout_modes(mx):
    x = mx.nd.ones((100, 100))
    with mx.autograd.record(train_mode=True):
        y = mx.nd.Dropout(x, p=0.5)
    with mx.autograd.record(train_mode=False):
        y2 = mx.nd.Dropout(x, p=0.5)
    y = y.asnumpy()
    return {"stats": np.array([0.3 < (y == 0).mean() < 0.7,
                               set(np.unique(y)) == {0.0, 2.0},
                               bool(np.all(y2.asnumpy() == 1))], np.float32),
            "want": np.ones(3, np.float32)}


def function_custom_grad(mx):
    class Double(mx.autograd.Function):
        def forward(self, x):
            return x * 2

        def backward(self, dy):
            return dy * 7  # a deliberately wrong constant: the custom path

    x = mx.nd.array(np.array([1.0, 2]))
    x.attach_grad()
    with mx.autograd.record():
        z = Double()(x).sum()
    z.backward()
    return {"x": x.grad.asnumpy(), "want": np.array([7.0, 7.0])}


def getitem_records_on_tape(mx):
    nd, ag = mx.nd, mx.autograd
    x = nd.array(np.ones((4,), "float32"))
    x.attach_grad()
    with ag.record():
        y = (x[1:3] * 3.0).sum()
    y.backward()
    w = nd.array(np.arange(12).reshape(3, 4).astype("float32"))
    w.attach_grad()
    with ag.record():
        z = (w[1] * 2.0).sum()
    z.backward()
    t = nd.array(np.arange(6).reshape(3, 2).astype("float32"))
    t.attach_grad()
    with ag.record():
        u = t[nd.array(np.array([0.0, 2.0], "float32"))].sum()
    u.backward()
    s = nd.array(np.arange(5).astype("float32"))
    s.attach_grad()
    with ag.record():
        v = (s[::2] * 2.0).sum() + (s[::-1] * 3.0).sum()
    v.backward()
    try:
        with ag.record():
            x[np.array([True, False, True, False])]
        refused = 0.0
    except mx.base.MXNetError:
        refused = 1.0
    got = np.concatenate([x.grad.asnumpy(), w.grad.asnumpy().ravel(),
                          t.grad.asnumpy().ravel(), s.grad.asnumpy(),
                          [refused]])
    want = np.concatenate([[0, 3, 3, 0], [0] * 4 + [2] * 4 + [0] * 4,
                           [1, 1, 0, 0, 1, 1], [5, 3, 5, 3, 5], [1]])
    return {"got": got, "want": want.astype(np.float64)}


def view_methods_record_on_tape(mx):
    nd, ag = mx.nd, mx.autograd
    x = nd.array(np.ones((2, 2), "float32"))
    x.attach_grad()
    with ag.record():
        y = x.reshape((4,)).sum() + x.flatten().sum()
    y.backward()
    g1 = x.grad.asnumpy().copy()
    with ag.record():
        z = (x.T * 3).sum() + x.broadcast_to((2, 2)).sum() \
            + x.expand_dims(0).sum()
    z.backward()
    b = nd.array(np.ones((1, 2), "float32"))
    b.attach_grad()
    with ag.record():
        w = b.broadcast_to((3, 2)).sum() + b.astype("float32").sum() \
            + b.copy().sum()
    w.backward()
    got = np.concatenate([g1.ravel(), x.grad.asnumpy().ravel(),
                          b.grad.asnumpy().ravel()])
    return {"got": got, "want": np.array([2.0] * 4 + [5.0] * 4 + [5.0] * 2)}


CASES = [simple_grad, chain_grad, head_grads, training_modes, pause,
         grad_add_req, detach, multi_variable, dropout_modes,
         function_custom_grad, getitem_records_on_tape,
         view_methods_record_on_tape]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_case_matches_mxtpu(mt, case):
    want = _run(mxtpu, case)
    got = _run(mt, case)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    flat = np.concatenate([np.ravel(v) for k, v in sorted(got.items())
                           if k != "want"])
    np.testing.assert_allclose(flat, np.ravel(got["want"]), rtol=1e-5)


def test_torch_grad_is_never_written(mt):
    """Gradients go to the buffers by grad_req, never into torch's
    ``.grad``: nothing accumulates there into the next step."""
    with mt.cpu():
        x = mt.nd.array(np.array([1.0, 2.0]))
        x.attach_grad()
        for _ in range(3):
            with mt.autograd.record():
                y = (x * x).sum()
            y.backward()
        assert x._data.grad is None
        np.testing.assert_array_equal(x.grad.asnumpy(), [2.0, 4.0])


def test_backward_needs_record_and_consumes_the_tape(mt):
    with mt.cpu():
        x = mt.nd.array(np.array([1.0, 2.0]))
        x.attach_grad()
        with pytest.raises(mt.MXNetError, match="record"):
            (x * x).sum().backward()
        with mt.autograd.record():
            y = (x * x).sum()
        y.backward(retain_graph=True)
        y.backward()  # the tape was kept
        np.testing.assert_array_equal(x.grad.asnumpy(), [2.0, 4.0])
        with pytest.raises(mt.MXNetError, match="record"):
            y.backward()  # ... and then consumed


def test_out_and_inplace_refused_while_recording(mt):
    with mt.cpu():
        x = mt.nd.array(np.array([1.0, 2.0]))
        x.attach_grad()
        dst = mt.nd.zeros((2,))
        mt.nd.relu(x, out=dst)  # outside record(): written in place
        np.testing.assert_array_equal(dst.asnumpy(), [1.0, 2.0])
        with mt.autograd.record():
            y = x * 2
            with pytest.raises(mt.MXNetError, match="out="):
                mt.nd.relu(x, out=dst)
            with pytest.raises(mt.MXNetError, match="Inplace"):
                y += 1
            with pytest.raises(mt.MXNetError, match="Inplace"):
                x[:] = 0
            z = mt.nd.ones((2,))
            z += 1  # not on the tape: allowed
        np.testing.assert_array_equal(z.asnumpy(), [2.0, 2.0])


def test_null_grad_req_is_a_constant(mt):
    with mt.cpu():
        x = mt.nd.array(np.array([3.0]))
        w = mt.nd.array(np.array([2.0]))
        x.attach_grad()
        w.attach_grad(grad_req="null")
        with mt.autograd.record():
            y = x * w
        y.backward()
        assert not w._data.requires_grad
        np.testing.assert_array_equal(x.grad.asnumpy(), [2.0])
        np.testing.assert_array_equal(w.grad.asnumpy(), [0.0])


def _second_step_head(mx, kind, x, w, idx):
    if kind == "argmax":  # no head requires grad at all
        return mx.nd.argmax(x * w, axis=1).sum()
    if kind == "comparison":  # x reaches the head through a 0/1 op only
        return ((x > 2) * w).sum()
    # pick: idx reaches the head only as the index
    return mx.nd.pick(x * w, idx, axis=1).sum()


@pytest.mark.parametrize("kind", ["argmax", "comparison", "pick"])
def test_non_differentiable_path_writes_zeros_as_mxtpu(mt, kind):
    """Two steps under grad_req "write": the first gives every variable a
    gradient; in the second, a variable that reaches the head only through
    a non-differentiable op gets zeros (mxtpu puts every variable feeding
    the head through jax.vjp), while ``u``, recorded in the same scope but
    off the head's slice, keeps its first gradient, as in mxtpu."""
    def case(mx):
        x = mx.nd.array(np.array([[1.0, 3, 2], [4, 0, 5]]))
        w = mx.nd.array(np.array([0.5, -1.0, 2.0]))
        idx = mx.nd.array(np.array([0.0, 2.0]))
        u = mx.nd.array(np.array([1.0, 2.0]))
        for a in (x, w, idx, u):
            a.attach_grad()
        with mx.autograd.record():
            y = (x * w).sum() + (u * u).sum() + (idx * idx).sum()
        y.backward()
        with mx.autograd.record():
            y = _second_step_head(mx, kind, x, w, idx)
            (u * 3).sum()
        y.backward()
        return {k: a.grad.asnumpy() for k, a in
                dict(x=x, w=w, idx=idx, u=u).items()}

    want = _run(mxtpu, case)
    got = _run(mt, case)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    np.testing.assert_array_equal(got["x"] if kind != "pick" else
                                  got["idx"], 0.0)
    np.testing.assert_array_equal(got["u"], [2.0, 4.0])
