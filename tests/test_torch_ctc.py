"""CTC in the port against mxtpu's: ``_contrib_CTCLoss`` and its aliases
(``ops/contrib.py``; on the CPU the plain version of the kernel pair of
``csrc/ctc_loss.cu``), Gluon's ``CTCLoss`` and the LSTM-OCR example's
Module (``models/ctc_ocr.py``).

- The op on ``final_op_cases.CTC_CASES`` (the infeasible alignments, where
  mxtpu's loss is 1.0e30 and its gradient the adjoint of its -1e30
  arithmetic; data lengths below T; label lengths; the blank first and
  last; interleaved padding and labels >= C; NaN logits; an OCR batch):
  the loss within 1e-5 relative (1e30 exactly), the gradient under a
  seeded head within 1e-5 of the largest, ``torch.autograd.grad``
  against ``jax.vjp`` of mxtpu's op.
- ``kernel_algorithm``: the kernel pair's arithmetic written out in numpy
  in the kernels' order of work (the forward's steps; the backward's
  scan from the last step down over the stored alphas with its tie
  shares, writing each step's per-state cotangent to a buffer; then the
  frames pass: the blank's sum and the total by the warp's fixed tree,
  each label class along its states in state order) against autograd
  of the plain version, within 1e-5 of the largest gradient.
- Gluon's ``CTCLoss`` in NTC/TNC and NT/TN, imperative and hybridized,
  with ``pred_lengths``/``label_lengths`` passed and ignored as mxtpu
  ignores them.
- A narrow OCR (num_hidden 16, 8 strips of the example's data): 3 Adam
  steps of the port's Module against mxtpu's from the same weights.

torch is imported lazily and pinned to one thread: several test workers
share the host."""
import logging

import numpy as np
import pytest

import mxtpu as mx
from final_op_cases import CTC_CASES, ctc_inputs
from mxtpu.ops import registry as jreg

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5
NEG = np.float32(-1e30)


@pytest.fixture(scope="module")
def tt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return torch, mxtpu_torch


def _mxtpu_ctc(x, lab, extra, attrs, head):
    import jax
    import jax.numpy as jnp
    op = jreg.get_op("_contrib_CTCLoss")
    a = op.parse_attrs(dict(attrs))
    rest = [jnp.asarray(v) for v in [lab] + extra]

    @jax.jit  # one compile of forward and vjp together
    def run(d, h):
        loss, vjp = jax.vjp(lambda v: op.fn(a, v, *rest), d)
        return loss, vjp(h)[0]

    loss, g = run(jnp.asarray(x), jnp.asarray(head))
    return np.asarray(loss), np.asarray(g)


def _port_ctc(torch, mt, x, lab, extra, attrs, head, name="_contrib_CTCLoss"):
    op = mt.ops.registry.get_op(name)
    xt = torch.from_numpy(x.copy()).requires_grad_()
    (loss,) = op.apply(op.parse_attrs(dict(attrs)),
                       [xt] + [torch.from_numpy(v) for v in [lab] + extra])
    (g,) = torch.autograd.grad(loss, [xt], torch.from_numpy(head))
    return loss.detach().numpy(), g.numpy()


def _same_loss(got, want):
    np.testing.assert_array_equal(got == np.float32(1e30),
                                  want == np.float32(1e30))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)


def _same_grad(got, want):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    scale = max(1e-30, float(np.nanmax(np.abs(want))))
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                               rtol=0, atol=GRAD_TOL * scale)


_ALIASED = [(c, "_contrib_CTCLoss") for c in CTC_CASES] + [
    (c, alias) for c in CTC_CASES[:1]
    for alias in ("CTCLoss", "ctc_loss", "_contrib_ctc_loss")]


@pytest.mark.parametrize("case,alias", _ALIASED,
                         ids=["%s-%s" % (c[0], a) for c, a in _ALIASED])
def test_ctc_op_matches_mxtpu(tt, case, alias):
    torch, mt = tt
    _, T, N, C, labels, attrs, dl, ll, nan = case
    x, lab, extra, head = ctc_inputs(T, N, C, labels, dl, ll, nan)
    want_l, want_g = _mxtpu_ctc(x, lab, extra, attrs, head)
    got_l, got_g = _port_ctc(torch, mt, x, lab, extra, attrs, head, alias)
    _same_loss(got_l, want_l)
    _same_grad(got_g, want_g)


def test_the_infeasible_alignment_pinned(tt):
    """T=2 with labels [1, 1] and T=1 with [1, 2] have no alignment: the
    loss is 1.0e30, finite, and the gradient is not the posterior's (at
    T=2 the gradient minus the softmax at t=1 is -0.5 on the blank and
    on class 1, 0 elsewhere)."""
    torch, mt = tt
    for T, labels in ((2, [[1, 1]]), (1, [[1, 2]])):
        x, lab, _, _ = ctc_inputs(T, 1, 4, labels, None, None, None, seed=3)
        loss, g = _port_ctc(torch, mt, x, lab, [], {},
                            np.ones(1, np.float32))
        assert loss.tolist() == [np.float32(1e30)]
        if T == 2:
            sm = np.exp(x[1, 0]) / np.exp(x[1, 0]).sum()
            np.testing.assert_allclose(g[1, 0] - sm, [-0.5, -0.5, 0, 0],
                                       atol=1e-6)


def _nan_max(a, b):
    return np.where((a > b) | (a != a), a, b)


def _tie(x, z, y):
    return np.where(x == z, np.where(y == z, 0.5, 1.0), 0.0).astype(
        np.float32)


def _warp_sum(v):
    """The frames pass's sum over the states: lane l adds states l, l + 32,
    ... in order, then the 32 partial sums meet in a butterfly (every
    lane ends with the same value), all in float32."""
    lanes = np.zeros(32, np.float32)
    for s0 in range(0, len(v), 32):
        part = v[s0:s0 + 32]
        lanes[:len(part)] = lanes[:len(part)] + part
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[np.arange(32) ^ off]
    return lanes[0]


def _frame(ct, ext, lab_cls, nl, blank, logp_t):
    """One frame of the frames pass: the blank's sum and the total by
    ``_warp_sum``, each label class (the first ``nl`` labels not the
    blank's) summed over its states in state order, then dlogits =
    dlogp - softmax * total."""
    C = logp_t.shape[0]
    total = _warp_sum(ct)
    dl = np.zeros(C, np.float32)
    dl[blank] = _warp_sum(np.where(ext == blank, ct, np.float32(0)))
    for c in range(C):
        states = [2 * i + 1 for i in range(nl)
                  if lab_cls[i] == c and c != blank]
        if states:
            v = ct[states[0]]
            for q in states[1:]:
                v = np.float32(v + ct[q])
            dl[c] = v
    return dl - np.exp(logp_t) * total


def kernel_algorithm(logp, lab, n_lab, dlen, blank, grad):
    """``csrc/ctc_loss.cu`` in numpy float32, a sequence at a time with its
    states vectorised: the forward's alphas and loss; the backward's scan
    from T - 1 down over the stored alphas (each state's partials G1, G2,
    G3 gathered from s, s + 1 and s + 2, a frozen step passing the
    adjoint through), writing each step's per-state cotangent ct, and
    step 0's d logp at states 0 and 1, to a (T, S) buffer; then the
    frames pass over that buffer (``_frame``)."""
    T, N, C = logp.shape
    S = 2 * lab.shape[1] + 1
    s = np.arange(S)
    loss = np.zeros(N, np.float32)
    dx = np.zeros((T, N, C), np.float32)
    f0 = np.float32(0)
    for n in range(N):
        nl = int(n_lab[n])
        lab_cls = np.clip(lab[n], 0, C - 1)
        ext = np.full(S, blank)
        ext[1::2] = lab_cls
        valid = s < 2 * nl + 1
        em2 = np.concatenate([[blank, blank], ext[:-2]])
        skip = (ext != blank) & (ext != em2) & (s >= 2)
        A = np.full((T, S), NEG, np.float32)
        A[0, 0] = logp[0, n, blank]
        if nl > 0:
            A[0, 1] = logp[0, n, ext[1]]

        def terms(P):
            x2 = np.concatenate([[NEG], P[:-1]])
            x3 = np.where(skip, np.concatenate([[NEG, NEG], P[:-2]]), NEG)
            return P, x2, x3

        for t in range(1, T):
            if t >= dlen[n]:
                A[t] = A[t - 1]
                continue
            x1, x2, x3 = terms(A[t - 1])
            m = _nan_max(_nan_max(x1, x2), x3)
            tot = m + np.log((np.exp(x1 - m) + np.exp(x2 - m))
                             + np.exp(x3 - m))
            tot = np.where(np.isfinite(m), tot, NEG)
            A[t] = np.where(valid, tot + logp[t, n, ext], NEG)
        e1v = A[T - 1, 2 * nl]
        e2v = A[T - 1, 2 * nl - 1] if nl > 0 else NEG
        m = _nan_max(e1v, e2v)
        loss[n] = -(m + np.log(np.exp(e1v - m) + np.exp(e2v - m)))
        g = np.zeros(S, np.float32)
        e1, e2 = np.exp(e1v - m), np.exp(e2v - m)
        gll = np.float32(-grad[n])
        q = gll / (e1 + e2)
        gm = gll - (q * e1 + q * e2)
        g[2 * nl] = q * e1 + gm * _tie(e1v, m, e2v)
        if nl > 0:
            g[2 * nl - 1] = q * e2 + gm * _tie(e2v, m, e1v)
        ct = np.zeros((T, S), np.float32)
        for t in range(T - 1, 0, -1):
            frozen = t >= dlen[n]
            x1, x2, x3 = terms(A[t - 1])
            mm = _nan_max(x1, x2)
            m = _nan_max(mm, x3)
            a1, a2, a3 = np.exp(x1 - m), np.exp(x2 - m), np.exp(x3 - m)
            c = np.where(valid & (not frozen), g, f0)
            craw = np.where(np.isfinite(m), c, f0)
            q = craw / ((a1 + a2) + a3)
            gmv = craw - ((q * a1 + q * a2) + q * a3)
            gmm = gmv * _tie(mm, m, x3)
            G1 = q * a1 + gmm * _tie(x1, mm, x2)
            G2 = np.where(s >= 1, q * a2 + gmm * _tie(x2, mm, x1), f0)
            G3 = np.where(skip, q * a3 + gmv * _tie(x3, m, mm), f0)
            v = G1 + np.append(G2[1:], f0) + np.append(G3[2:], [f0, f0])
            g = (v + g if frozen else v).astype(np.float32)
            ct[t] = c
        ct[0, 0] = g[0]
        if nl > 0:
            ct[0, 1] = g[1]
        for t in range(T):
            dx[t, n] = _frame(ct[t], ext, lab_cls, nl, blank, logp[t, n])
    return loss, dx


@pytest.mark.parametrize("case", CTC_CASES, ids=[c[0] for c in CTC_CASES])
def test_kernel_algorithm_matches_the_plain_version(tt, case):
    torch, mt = tt
    from mxtpu_torch.ops import contrib
    _, T, N, C, labels, attrs, dl, ll, nan = case
    x, lab, _, head = ctc_inputs(T, N, C, labels, dl, ll, nan)
    blank_first = attrs.get("blank_label", "first") != "last"
    blank = 0 if blank_first else C - 1
    labs, n_lab = contrib.ctc_labels(
        torch.from_numpy(lab), C, blank_first,
        None if ll is None else torch.tensor(ll))
    dlen = mt.ops.registry.int_convert(torch.tensor(
        dl if dl is not None else [T] * N, dtype=torch.float32))
    xt = torch.from_numpy(x.copy()).requires_grad_()
    loss = contrib.ctc_loss_reference(xt, labs, n_lab, dlen, blank)
    (g,) = torch.autograd.grad(loss, [xt], torch.from_numpy(head))
    logp = torch.log_softmax(torch.from_numpy(x), -1).numpy()
    with np.errstate(all="ignore"):
        el, eg = kernel_algorithm(logp, labs.numpy(), n_lab.numpy(),
                                  dlen.numpy(), blank, head)
    _same_loss(el, loss.detach().numpy())
    _same_grad(eg, g.numpy())


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("layout,label_layout",
                         [("NTC", "NT"), ("TNC", "TN"), ("NTC", "TN")])
def test_gluon_ctc_loss_matches_mxtpu(tt, layout, label_layout, hybridize):
    """Loss and d loss / d pred; the lengths are passed and, as in mxtpu,
    ignored (the full sequences are scored)."""
    torch, mt = tt
    T, N, C = 7, 3, 5
    x, lab, _, _ = ctc_inputs(T, N, C, [[1, 2, 0], [3, 3, 4], [4, 1, 2]],
                              None, None, None, seed=6)
    pred = x if layout == "TNC" else x.transpose(1, 0, 2).copy()
    label = lab if label_layout == "NT" else lab.T.copy()
    lengths = (np.array([3, 5, 7], np.float32),
               np.array([1, 1, 1], np.float32))

    def run(pkg):
        loss_fn = pkg.gluon.loss.CTCLoss(layout, label_layout)
        if hybridize:
            loss_fn.hybridize()
        p = pkg.nd.array(pred)
        p.attach_grad()
        with pkg.autograd.record():
            out = loss_fn(p, pkg.nd.array(label),
                          pkg.nd.array(lengths[0]), pkg.nd.array(lengths[1]))
        out.backward()
        unweighted = loss_fn(pkg.nd.array(pred), pkg.nd.array(label))
        return out.asnumpy(), p.grad.asnumpy(), unweighted.asnumpy()

    with mt.cpu():
        got = run(mt)
    want = run(mx)
    _same_loss(got[0], want[0])
    _same_grad(got[1], want[1])
    np.testing.assert_array_equal(got[0], got[2])  # the lengths were ignored


def _quiet():
    log = logging.getLogger("quiet")
    log.setLevel(logging.ERROR)
    return log


def test_narrow_ocr_adam_steps_match_mxtpu(tt):
    """The example's graph at num_hidden 16 on 8 of its strips, B=4: 3
    Adam steps (lr 0.01) of the port's Module and mxtpu's from mxtpu's
    Xavier draw; the losses within 1e-5 relative, the weights within
    2e-5."""
    torch, mt = tt
    from mxtpu_torch.models import ctc_ocr
    X, Y, _, _ = ctc_ocr.example_split(num_examples=10, seed=11)
    X, Y = X[:8], Y[:8]
    T, F = X.shape[1:]
    hidden, b = 16, 4
    shapes = [("data", (b, T, F)), ("label", (b, ctc_ocr.MAX_LABEL))]
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "lstm_ocr", os.path.join(os.path.dirname(__file__), os.pardir,
                                 "examples", "ctc", "lstm_ocr.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    jsym = example.build_symbol(hidden, T, for_training=True)
    jmod = mx.mod.Module(jsym, context=mx.cpu(), label_names=("label",),
                         logger=_quiet())
    jmod.bind(data_shapes=shapes[:1], label_shapes=shapes[1:])
    mx.random.seed(3)
    jmod.init_params(mx.initializer.Xavier())
    w0 = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    opt = dict(optimizer="adam", optimizer_params={"learning_rate": 0.01})
    jmod.init_optimizer(**opt)
    tmod = mt.mod.Module(ctc_ocr.build_symbol(hidden, T, for_training=True),
                         context=mt.cpu(), label_names=("label",),
                         logger=_quiet())
    tmod.bind(data_shapes=shapes[:1], label_shapes=shapes[1:])
    tmod.init_params(arg_params=mt.convert.params_from_mxtpu(w0, "cpu"))
    tmod.init_optimizer(**opt)
    for step in range(3):
        sl = slice((step % 2) * b, (step % 2) * b + b)
        jmod.forward_backward(mx.io.DataBatch([mx.nd.array(X[sl])],
                                              [mx.nd.array(Y[sl])]))
        jmod.update()
        tmod.forward_backward(mt.io.DataBatch(
            [mt.nd.array(X[sl], ctx=mt.cpu())],
            [mt.nd.array(Y[sl], ctx=mt.cpu())]))
        tmod.update()
        _same_loss(tmod.get_outputs()[0].asnumpy(),
                   jmod.get_outputs()[0].asnumpy())
    jw = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    tw = {k: v.asnumpy() for k, v in tmod.get_params()[0].items()}
    assert sorted(jw) == sorted(tw)
    for k in jw:
        np.testing.assert_allclose(tw[k], jw[k], rtol=0, atol=2e-5,
                                   err_msg=k)
        assert not np.array_equal(tw[k], w0[k])


@pytest.mark.parametrize("T,N,C,L", [(32, 32, 11, 5), (800, 32, 29, 200)])
def test_chip_smoke_bounds_count_each_tensor_once(tt, T, N, C, L):
    """``chip_smoke.ctc_bytes``: the function's least bytes (the forward
    reads the logits and the labels and writes the loss; the backward
    reads the logits, the labels and the head and writes the gradient,
    each once) and this route's (alpha written once by the forward and
    read once by the backward on top, and in the backward the per-state
    cotangents, alpha's shape, written by the scan and read by the
    frames pass)."""
    torch, mt = tt
    import chip_smoke
    f32, i32 = torch.float32, torch.int32
    S = 2 * L + 1

    def nb(shape, dtype):
        return torch.empty(shape, dtype=dtype).nbytes

    labels = nb((N, L), i32) + 2 * nb((N,), i32)
    fwd = nb((T, N, C), f32) + nb((N,), f32) + labels
    bwd = 2 * nb((T, N, C), f32) + nb((N,), f32) + labels
    alpha = nb((T, N, S), f32)
    ct = nb((T, N, S), f32)
    assert chip_smoke.ctc_bytes(T, N, C, L) == {
        "fwd": fwd, "bwd": bwd, "route_fwd": fwd + alpha,
        "route_bwd": bwd + alpha + 2 * ct}
