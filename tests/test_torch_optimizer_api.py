"""The optimizers this slice adds to the port (AdaDelta, Adamax, Nadam,
Ftrl, SGLD, DCASGD, Test, ccSGD, and SGD with ``multi_precision``)
against mxtpu's, on the CPU: two parameters (a weight and a bias, so
``wd_mult`` leaves the bias undecayed and ``lr_mult`` scales the
weight) through each package's ``Updater`` for 4 steps with momentum
where the rule has one, wd, clip_gradient, rescale_grad and a
``FactorScheduler``; weights and states within 1e-6 relative (float16
weights within one float16 step). SGLD draws its noise from each
package's own generator, so it is held by the noise's moments and a
two-sample KS test against mxtpu's draws. Then a small ``Module.fit`` of
the mlp through the Updater path against mxtpu's, and which optimizers
the fused step takes (``fused.supports``), as mxtpu answers.

torch is imported lazily and pinned to one thread: several test workers
share the host."""
import logging

import numpy as np
import pytest

import mxtpu as mx

RTOL = 1e-6
NAMES = {0: "fc_weight", 1: "fc_bias"}


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


CASES = [
    ("adadelta", {"rho": 0.9, "epsilon": 1e-5}),
    ("adamax", {"learning_rate": 0.01}),
    ("nadam", {"learning_rate": 0.01}),
    ("nadam", {"learning_rate": 0.01, "schedule_decay": 0.01}),
    ("ftrl", {"learning_rate": 0.1, "lamda1": 0.01, "beta": 1.0}),
    ("dcasgd", {"learning_rate": 0.1, "momentum": 0.9, "lamda": 0.04}),
    ("dcasgd", {"learning_rate": 0.1}),
    ("test", {}),
    ("ccsgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
             "multi_precision": True}),
    ("sgd", {"learning_rate": 0.1, "multi_precision": True}),
]


def _leaves(s):
    if s is None:
        return []
    if isinstance(s, tuple):
        return [x for y in s for x in _leaves(y)]
    return [s]


def _steps(pkg, name, params, w0, grads, dtype):
    """4 Updater steps of two parameters; (weights, states) as numpy."""
    sched = pkg.lr_scheduler.FactorScheduler(step=2, factor=0.5)
    common = dict(params, rescale_grad=0.5, param_idx2name=NAMES)
    if name != "test":
        common.update(wd=0.01, clip_gradient=0.8, lr_scheduler=sched)
    opt = pkg.optimizer.create(name, **common)
    opt.set_lr_mult({"fc_weight": 0.5})
    opt.set_wd_mult({})
    upd = pkg.optimizer.get_updater(opt)
    with pkg.cpu():
        ws = [pkg.nd.array(w, dtype=dtype) for w in w0]
        for step in grads:
            for i, g in enumerate(step):
                upd(i, pkg.nd.array(g, dtype=dtype), ws[i])
    states = [[s.asnumpy() for s in _leaves(upd.states[i])]
              for i in range(len(ws))]
    return [w.asnumpy() for w in ws], states, type(opt).__name__


@pytest.mark.parametrize("name,params", CASES,
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(CASES)])
def test_four_updater_steps_match_mxtpu(mt, name, params):
    rng = np.random.RandomState(len(name) * 7 + len(params))
    w0 = [rng.randn(6, 5).astype(np.float32), rng.randn(6).astype(np.float32)]
    grads = [[rng.randn(*w.shape).astype(np.float32) * 3 for w in w0]
             for _ in range(4)]
    dtype = "float16" if params.get("multi_precision") else "float32"
    gw, gs, gcls = _steps(mt, name, params, w0, grads, dtype)
    ww, ws, wcls = _steps(mx, name, params, w0, grads, dtype)
    assert gcls == wcls
    tol = dict(rtol=1e-3, atol=1e-3) if dtype == "float16" else \
        dict(rtol=RTOL, atol=1e-7)
    for g, w, w_start in zip(gw, ww, w0):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g, w, **tol)
        assert not np.array_equal(g, w_start.astype(dtype))  # it moved
    for g, w in zip(gs, ws):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-6)


def test_nadam_m_schedule_advances_on_every_parameters_update(mt):
    """mxtpu's (and the reference's) quirk, kept: one m_schedule on the
    optimizer, multiplied in by each parameter's update."""
    for pkg in (mt, mx):
        opt = pkg.optimizer.Nadam(learning_rate=0.01)
        upd = pkg.optimizer.get_updater(opt)
        with pkg.cpu():
            ws = [pkg.nd.ones((3,)), pkg.nd.ones((3,))]
            for i, w in enumerate(ws):
                upd(i, pkg.nd.ones((3,)), w)
        mom = 0.9 * (1.0 - 0.5 * 0.96 ** 0.004)
        assert opt.m_schedule == pytest.approx(mom * mom, rel=1e-12)


def test_sgld_noise_moments_match_mxtpus(mt):
    """SGLD: w - lr/2 (g + wd w) + N(0, lr). Each package draws from its
    own generator; the noise's mean and variance sit within 5 standard
    errors of 0 and lr, and a two-sample KS test does not tell the two
    packages' noise apart."""
    from scipy import stats
    n, lr = 20000, 0.04
    rng = np.random.RandomState(9)
    w0 = rng.randn(n).astype(np.float32)
    g = rng.randn(n).astype(np.float32)
    mt.random.seed(1)
    mx.random.seed(1)
    noise = {}
    for pkg in (mt, mx):
        opt = pkg.optimizer.create("sgld", learning_rate=lr, wd=0.01,
                                   rescale_grad=0.5)
        with pkg.cpu():
            w = pkg.nd.array(w0)
            pkg.optimizer.get_updater(opt)(0, pkg.nd.array(g), w)
        drift = w0 - lr / 2 * (0.5 * g + 0.01 * w0)
        noise[pkg.__name__] = w.asnumpy().astype(np.float64) - drift
    for x in noise.values():
        assert abs(x.mean()) < 5 * np.sqrt(lr / n)
        assert abs(x.var() - lr) < 5 * lr * np.sqrt(2.0 / n)
    assert stats.ks_2samp(noise["mxtpu_torch"], noise["mxtpu"]).pvalue > 1e-3


def test_multi_precision_sgd_keeps_float32_masters(mt):
    opt = mt.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                           multi_precision=True)
    with mt.cpu():
        w16 = mt.nd.array(np.ones(4), dtype="float16")
        w32 = mt.nd.array(np.ones(4))
        mom, master = opt.create_state(0, w16)
        assert mom.dtype == master.dtype == np.float32
        assert opt.create_state(1, w32).dtype == np.float32
        assert not isinstance(opt.create_state(1, w32), tuple)


@pytest.mark.parametrize("name,params,fused", [
    ("sgd", {}, True), ("sgd", {"multi_precision": True}, False),
    ("nag", {}, True), ("adam", {}, True), ("rmsprop", {}, True),
    ("adagrad", {}, True), ("adadelta", {}, False), ("adamax", {}, False),
    ("nadam", {}, False), ("ftrl", {}, False), ("sgld", {}, False),
    ("dcasgd", {}, False), ("test", {}, False), ("ccsgd", {}, False)])
def test_fused_step_supports_what_mxtpus_does(mt, name, params, fused):
    from mxtpu.module import fused as jfused
    from mxtpu_torch.module import fused as tfused
    assert tfused.supports(mt.optimizer.create(name, **params)) == fused
    assert jfused.supports(mx.optimizer.create(name, **params)) == fused


def _quiet():
    log = logging.getLogger("quiet")
    log.setLevel(logging.ERROR)
    return log


@pytest.mark.parametrize("name,params,atol", [
    # Nadam moves each weight by ~lr whatever its gradient's size, so a
    # gradient within rounding of 0 can move it by up to ~lr in one
    # package and less in the other: held to a tenth of lr
    ("nadam", {"learning_rate": 0.005, "wd": 1e-4}, 5e-4),
    ("adadelta", {"wd": 1e-4}, 1e-4),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "multi_precision": True,
             "wd": 1e-4}, 1e-4)])
def test_mlp_fit_through_the_updater_matches_mxtpu(mt, name, params, atol):
    rng = np.random.RandomState(0)
    x = rng.rand(128, 784).astype(np.float32)
    y = rng.randint(0, 10, 128).astype(np.float32)
    jsym, tsym = mx.models.get_mlp(10), mt.models.get_mlp(10)
    jmod = mx.mod.Module(jsym, context=mx.cpu(), logger=_quiet())
    jmod.bind(data_shapes=[("data", (32, 784))],
              label_shapes=[("softmax_label", (32,))])
    mx.random.seed(3)
    jmod.init_params(mx.initializer.Xavier())
    w0 = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    kw = dict(num_epoch=2, optimizer=name, optimizer_params=params)
    jmetric = mx.metric.create(["acc", "ce"])
    jmod.fit(mx.io.NDArrayIter(x, y, batch_size=32),
             arg_params={k: mx.nd.array(v) for k, v in w0.items()},
             eval_metric=jmetric, force_init=True, **kw)
    tmod = mt.mod.Module(tsym, context=mt.cpu(), logger=_quiet())
    tmetric = mt.metric.create(["acc", "ce"])
    tmod.fit(mt.io.NDArrayIter(x, y, batch_size=32),
             arg_params=mt.convert.params_from_mxtpu(w0, mt.cpu()),
             eval_metric=tmetric, **kw)
    assert tmod._fused is None  # the Updater path, as mxtpu's
    got, want = dict(zip(*tmetric.get())), dict(zip(*jmetric.get()))
    assert abs(got["accuracy"] - want["accuracy"]) <= 2 / 128.0
    assert abs(got["cross-entropy"] - want["cross-entropy"]) < 1e-3
    jw = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    tw = {k: v.asnumpy() for k, v in tmod.get_params()[0].items()}
    for k in jw:
        np.testing.assert_allclose(tw[k], jw[k], rtol=0, atol=atol,
                                   err_msg=k)
        assert not np.array_equal(tw[k], w0[k])
