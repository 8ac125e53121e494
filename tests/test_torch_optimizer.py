"""The port's update rules against mxtpu's fused ones, on the CPU.

Each rule of ``mxtpu_torch.module.fused`` (SGD with and without momentum,
NAG, Adam with its bias correction folded into lr, RMSProp plain and
centered, AdaGrad; with weight decay, rescale_grad and clip_gradient)
runs three steps on the same weights and gradients as the rule of
``mxtpu.module.fused``: weights and state agree within 1e-6 relative
(both f32, elementwise, the same operation order). The port's unfused
path (Optimizer.update through the Updater) gives the fused rule's
numbers bit for bit, since both call the same update functions. Also
lr_mult/wd_mult from symbol attributes and the lr scheduler."""
import numpy as np
import pytest

CASES = [
    ("sgd", {"learning_rate": 0.1, "wd": 0.01}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01,
             "clip_gradient": 0.5}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("nag", {"learning_rate": 0.1}),
    ("adam", {"learning_rate": 0.01, "wd": 0.001, "clip_gradient": 1.0}),
    ("rmsprop", {"learning_rate": 0.01, "gamma1": 0.9, "wd": 0.01}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True,
                 "clip_weights": 0.8}),
    ("adagrad", {"learning_rate": 0.1, "wd": 0.01, "clip_gradient": 2.0}),
]


@pytest.fixture(scope="module")
def tt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return torch, mxtpu_torch


def _leaves(s):
    if s is None:
        return []
    if isinstance(s, tuple):
        return [x for y in s for x in _leaves(y)]
    return [s]


@pytest.mark.parametrize("name,params", CASES,
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(CASES)])
def test_rule_matches_mxtpu_fused_rule(tt, name, params):
    import jax.numpy as jnp
    import mxtpu
    from mxtpu.module import fused as jfused
    torch, mt = tt
    from mxtpu_torch.module import fused as tfused
    rng = np.random.RandomState(len(name) + len(params))
    w0 = rng.randn(6, 5).astype(np.float32)
    grads = [rng.randn(6, 5).astype(np.float32) * 3 for _ in range(3)]
    common = dict(params, rescale_grad=0.5, param_idx2name={0: "w"})
    jo = mxtpu.optimizer.create(name, **common)
    to = mt.optimizer.create(name, **common)
    jinit, japply, jscale = jfused._RULES[type(jo).__name__](jo)
    tinit, tapply, tscale = tfused._RULES[type(to).__name__](to)
    jw, js = jnp.asarray(w0), jinit(jnp.asarray(w0))
    tw = torch.from_numpy(w0.copy())
    ts = tinit(tw)
    for g in grads:
        for o, scale in ((jo, jscale), (to, tscale)):
            o._update_count(0)
        lr = jo._get_lr(0) * (jscale(jo._index_update_count[0])
                              if jscale else 1.0)
        assert lr == to._get_lr(0) * (tscale(to._index_update_count[0])
                                      if tscale else 1.0)
        jw, js = japply(jw, jnp.asarray(g), js, jnp.float32(lr),
                        jnp.float32(jo._get_wd(0)))
        tapply(tw, torch.from_numpy(g), ts, lr, to._get_wd(0))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)
    for a, b in zip(_leaves(ts), _leaves(js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("name,params", CASES,
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(CASES)])
def test_unfused_updater_equals_fused_rule(tt, name, params):
    torch, mt = tt
    from mxtpu_torch.module import fused as tfused
    rng = np.random.RandomState(7)
    w0 = rng.randn(4, 3).astype(np.float32)
    grads = [rng.randn(4, 3).astype(np.float32) for _ in range(3)]
    o1 = mt.optimizer.create(name, **params)
    o2 = mt.optimizer.create(name, **params)
    init, apply, lr_scale = tfused._RULES[type(o1).__name__](o1)
    fw = torch.from_numpy(w0.copy())
    fs = init(fw)
    upd = mt.optimizer.get_updater(o2)
    uw = mt.nd.NDArray(torch.from_numpy(w0.copy()))
    for g in grads:
        o1._update_count(0)
        lr = o1._get_lr(0) * (lr_scale(o1._index_update_count[0])
                              if lr_scale else 1.0)
        apply(fw, torch.from_numpy(g), fs, lr, o1._get_wd(0))
        upd(0, mt.nd.NDArray(torch.from_numpy(g)), uw)
    assert torch.equal(fw, uw._data)


def test_lr_wd_mult_and_scheduler(tt):
    torch, mt = tt
    sym = mt.sym.FullyConnected(
        mt.sym.Variable("data"),
        weight=mt.sym.Variable("fc_weight", attr={"__lr_mult__": "0.5",
                                                  "__wd_mult__": "0"}),
        num_hidden=3, name="fc")
    sched = mt.lr_scheduler.FactorScheduler(step=2, factor=0.1)
    o = mt.optimizer.create("sgd", sym=sym, learning_rate=1.0, wd=0.1,
                            lr_scheduler=sched,
                            param_idx2name={0: "fc_weight", 1: "fc_bias"})
    assert o._get_lr(0) == 0.5 and o._get_wd(0) == 0.0
    assert o._get_lr(1) == 1.0 and o._get_wd(1) == 0.1
    for _ in range(3):
        o._update_count(1)
    assert abs(o._get_lr(1) - 0.1) < 1e-12
    with pytest.raises(mt.MXNetError, match="unknown optimizer"):
        mt.optimizer.create("lamb")
    with pytest.raises(mt.MXNetError, match="unknown arguments"):
        mt.optimizer.create("sgd", master_weights=True)
