"""Module.fit on 2-D and 3-D meshes (tp, fsdp) against mxtpu, on the CPU.

``cpu(0..7)`` are the port's mesh devices, mxtpu's are its 8 virtual XLA
host devices (conftest). The port executes the ``ShardingPlan`` that
mxtpu hands to GSPMD: each replica holds its block of every parameter
the plan splits, a block split over ``fsdp`` is gathered right before
its op, one split over ``tp`` goes through the op's ``tp_fn`` (partial
products summed over the tp group). The cases hold the port to mxtpu's
own mesh gate (tests/test_sharding.py:196-206: accuracy equal,
cross-entropy within 1e-5 relative, weights within rtol 1e-4 / atol
1e-5):

- the mlp's ``fit`` on ``data:2,tp:2``, ``data:2,fsdp:2`` and
  ``data:2,fsdp:2,tp:2``, with each replica's parameter and optimizer-
  state bytes (the replicated ones, plus each split one over its split
  factor);
- resnet-8 (BatchNorm over the whole batch, Convolution's tp form) on
  ``data:2,tp:2``;
- a 2-layer, d=64 LM (Embedding's and FullyConnected's tp forms) for 3
  Adam steps on ``data:2,tp:2``;
- the collectives a step, by kind and axis;
- a checkpoint written under ``data:2,tp:2`` and ``data:2,fsdp:2,tp:2``
  loaded in mxtpu and in a one-context port Module, and its optimizer
  states round trip;
- ``DataParallelTrainer(shard_params=True)`` (mxtpu's
  tests/test_parallel.py:53-64) against mxtpu's trainer from the same
  weights, for 3 steps.
"""
import logging

import numpy as np
import pytest

import mxtpu as mx
from mxtpu import sharding as jsh

MESHES = ["data:2,tp:2", "data:2,fsdp:2", "data:2,fsdp:2,tp:2"]


@pytest.fixture(scope="module")
def tt():
    import torch
    torch.set_num_threads(2)
    import mxtpu_torch
    return torch, mxtpu_torch


@pytest.fixture(autouse=True)
def _clean_mesh(monkeypatch):
    monkeypatch.delenv("MXTPU_MESH", raising=False)
    yield
    jsh.deactivate()
    from mxtpu_torch import sharding
    sharding.deactivate()


def _quiet():
    log = logging.getLogger("quiet")
    log.setLevel(logging.ERROR)
    return log


def _mesh(mt, spec):
    return mt.sharding.MeshContext.create(
        spec, devices=[mt.cpu(i) for i in range(8)])


def _gate(got, want):
    """mxtpu's gate (tests/test_sharding.py:196-206)."""
    (gm, gw), (wm, ww) = got, want
    assert gm["accuracy"] == wm["accuracy"], (gm, wm)
    np.testing.assert_allclose(gm["cross-entropy"], wm["cross-entropy"],
                               rtol=1e-5)
    for k in ww:
        np.testing.assert_allclose(gw[k], ww[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def _data(n=128, seed=7):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 784).astype("float32"),
            rng.randint(0, 10, n).astype("float32"))


@pytest.fixture(scope="module")
def mlp_w0():
    rng = np.random.RandomState(11)
    mod = mx.mod.Module(mx.models.mlp.get_symbol(10), context=mx.cpu(),
                        logger=_quiet())
    mod.bind(data_shapes=[("data", (64, 784))],
             label_shapes=[("softmax_label", (64,))])
    out = {}
    for name, arr in sorted(mod._exec_group.execs[0].arg_dict.items()):
        if name in ("data", "softmax_label"):
            continue
        shape = arr.shape
        scale = np.sqrt(3.0 / shape[-1]) if len(shape) > 1 else 0.0
        out[name] = rng.uniform(-scale, scale, shape).astype(np.float32)
    return out


def _fit(pkg, w0, mesh, x, y, batch=64, num_epoch=1, sym=None, a0=None,
         params=None):
    it = pkg.io.NDArrayIter(x, y, batch_size=batch,
                            label_name="softmax_label")
    sym = sym or pkg.models.mlp.get_symbol(10)
    ctx = pkg.cpu()
    mod = pkg.mod.Module(sym, context=ctx, logger=_quiet())
    metric = pkg.metric.create(["acc", "ce"])
    if pkg is mx:
        args = {k: mx.nd.array(v) for k, v in w0.items()}
        auxs = None if a0 is None else \
            {k: mx.nd.array(v) for k, v in a0.items()}
    else:
        args = pkg.convert.params_from_mxtpu(w0, "cpu")
        auxs = None if a0 is None else \
            pkg.convert.params_from_mxtpu(a0, "cpu")
    mod.fit(it, num_epoch=num_epoch, eval_metric=metric, optimizer="sgd",
            optimizer_params=params or {"learning_rate": 0.05,
                                        "momentum": 0.9},
            arg_params=args, aux_params=auxs, mesh=mesh)
    w = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    return dict(metric.get_name_value()), w, mod


@pytest.fixture(scope="module")
def mlp_runs(tt, mlp_w0):
    """mxtpu's fit and the port's on each mesh, 2 epochs of 2 batches."""
    _, mt = tt
    x, y = _data()
    runs = {}
    for spec in MESHES:
        want = _fit(mx, mlp_w0, spec, x, y, num_epoch=2)
        got = _fit(mt, mlp_w0, _mesh(mt, spec), x, y, num_epoch=2)
        runs[spec] = (want, got)
    return runs


@pytest.mark.parametrize("spec", MESHES)
def test_fit_mlp_on_a_sharded_mesh_matches_mxtpu(tt, mlp_runs, spec):
    """The plan executed over 4 or 8 replicas, each holding its blocks,
    at mxtpu's gate; mxtpu's plan is the port's."""
    (jm, jw, jmod), (tm, tw, tmod) = mlp_runs[spec]
    _gate((tm, tw), (jm, jw))
    plan = tmod._fused._plan
    assert jmod._fused._plan is not None
    for name in jw:
        assert tuple(plan.param_spec(name)) == \
            tuple(jmod._fused._plan.param_spec(name)), name
    lay = plan.replica_layout()
    assert lay.specs and len(tmod._exec_group.execs) == lay.n
    ex = tmod._exec_group.execs[-1]
    for name, shape in plan.param_shapes.items():
        assert tuple(ex.arg_dict[name].shape) == \
            lay.local_shape(name, shape), name


@pytest.mark.parametrize("spec", MESHES)
def test_each_replica_holds_its_blocks_and_their_state(tt, mlp_runs, spec):
    """Each replica's parameter bytes are the replicated parameters' plus
    each split one's over its split factor; its momentum bytes the same
    again, over the data axis too where the update goes by rows."""
    torch, _ = tt
    _, (_, _, tmod) = mlp_runs[spec]
    fused = tmod._fused
    plan = fused._plan
    lay = plan.replica_layout()
    rows = set(fused.sharded_names)
    n_data = lay.sizes["data"]
    want_p, want_s = 0, 0
    for name, shape in plan.param_shapes.items():
        full = int(np.prod(shape)) * 4
        factor = int(np.prod([lay.sizes[a] for a in lay.split_axes(name)]))
        want_p += full // factor
        want_s += full // factor // (n_data if name in rows else 1)
    for r, ex in enumerate(tmod._exec_group.execs):
        got = sum(ex.arg_dict[n]._data.numel() * 4 for n in plan.param_shapes)
        assert got == want_p, (r, got, want_p)
    assert fused.opt_state_bytes() == [want_s] * lay.n
    total = sum(int(np.prod(s)) * 4 for s in plan.param_shapes.values())
    assert want_p < total and want_s < want_p


def test_collectives_a_step(tt, mlp_w0):
    """One step of the mlp on data:2,fsdp:2,tp:2: per FullyConnected one
    fsdp all-gather of its weight and one tp all-reduce of its partial
    products; in the backward one fsdp reduce-scatter of each weight's
    gradient and one tp all-gather of dx (none for the input layer);
    then the update's collectives, each within its groups."""
    _, mt = tt
    from mxtpu_torch.module import fused as F
    from mxtpu_torch.ops import collective as C
    x, y = _data(64)
    C.calls.clear()
    seen = []
    real = F.reduce_scatter_replicas
    F.reduce_scatter_replicas = lambda i, o: (seen.append(len(i)),
                                              real(i, o))
    try:
        _, _, mod = _fit(mt, mlp_w0, _mesh(mt, "data:2,fsdp:2,tp:2"), x, y)
    finally:
        F.reduce_scatter_replicas = real
    assert dict(C.calls) == {("all_gather", "fsdp"): 3,
                             ("all_reduce", "tp"): 3,
                             ("reduce_scatter", "fsdp"): 3,
                             ("all_gather", "tp"): 2}, dict(C.calls)
    # the update: 2 row-updated weights, one bucket reduce-scattered in
    # each of the 4 data groups of 2 replicas
    assert sorted(mod._fused.sharded_names) == ["fc1_weight", "fc2_weight"]
    assert seen == [2] * 4, seen
    groups = mod._fused._all_reduce_groups
    # the biases summed over data x fsdp, fc3_weight (not updated by
    # rows: 640 elements) over data: its backward summed it over fsdp
    assert sorted([len(g) for g in gs] for gs in groups) == \
        [[2] * 4, [4] * 2]


def _resnet8_start():
    init = mx.mod.Module(mx.models.resnet.get_symbol(10, 8, (3, 28, 28)),
                         context=mx.cpu(), logger=_quiet())
    init.bind(data_shapes=[("data", (16, 3, 28, 28))],
              label_shapes=[("softmax_label", (16,))])
    mx.random.seed(4)
    init.init_params(mx.initializer.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2))
    w0, a0 = [{k: v.asnumpy() for k, v in d.items()}
              for d in init.get_params()]
    a0 = {k: (v + 0.1 if k.endswith("_moving_mean") else v * 1.5)
          for k, v in a0.items()}
    return w0, a0


def test_fit_resnet8_on_a_tp_mesh_matches_mxtpu(tt):
    """resnet-8 on data:2,tp:2: every Convolution whose input channels
    divide by 2 takes its tp form, BatchNorm normalizes over each tp
    index's replicas (the whole batch), 2 SGD steps at mxtpu's gate; the
    moving statistics too; the evaluation forward's outputs are the lead
    replicas'."""
    _, mt = tt
    w0, a0 = _resnet8_start()
    x = np.random.RandomState(0).rand(32, 3, 28, 28).astype(np.float32)
    y = np.random.RandomState(1).randint(0, 10, 32).astype(np.float32)
    sgd = {"learning_rate": 0.1, "momentum": 0.9, "rescale_grad": 1.0 / 16}
    args = dict(batch=16, num_epoch=1, a0=a0, params=sgd)
    jm, jw, jmod = _fit(mx, w0, "data:2,tp:2", x, y,
                        sym=mx.models.resnet.get_symbol(10, 8, (3, 28, 28)),
                        **args)
    tm, tw, tmod = _fit(mt, w0, _mesh(mt, "data:2,tp:2"), x, y,
                        sym=mt.models.resnet.get_symbol(10, 8, (3, 28, 28)),
                        **args)
    lay = tmod._fused._plan.replica_layout()
    convs = [k for k in lay.specs if "conv" in k]
    assert len(convs) >= 5 and all(lay.specs[k][1] == ("tp",)
                                   for k in convs)
    _gate((tm, tw), (jm, jw))
    ja = {k: v.asnumpy() for k, v in jmod.get_params()[1].items()}
    ta = {k: v.asnumpy() for k, v in tmod.get_params()[1].items()}
    for k in ja:
        np.testing.assert_allclose(ta[k], ja[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    it = mt.io.NDArrayIter(x[:16], y[:16], batch_size=16)
    jit = mx.io.NDArrayIter(x[:16], y[:16], batch_size=16)
    np.testing.assert_allclose(tmod.predict(it).asnumpy(),
                               jmod.predict(jit).asnumpy(), rtol=1e-4,
                               atol=1e-5)


def _lm_batches(n_steps, b=4, t=16, vocab=20):
    rng = np.random.RandomState(5)
    ids = rng.randint(0, vocab, (n_steps, b, t + 1)).astype(np.float32)
    return [(s[:, :-1], s[:, 1:].reshape(-1)) for s in ids]


def _lm_run(pkg, w0, opt, mesh):
    """The 2-layer, d=64 LM's 3 steps from ``w0`` under ``mesh`` (None:
    one device): (outputs, weights, module)."""
    shapes = [("data", (4, 16)), ("softmax_label", (64,))]
    on = pkg.cpu()
    mod = pkg.mod.Module(pkg.models.get_transformer_lm(**LM),
                         context=on, logger=_quiet())
    mod.bind(data_shapes=shapes[:1], label_shapes=shapes[1:])
    if pkg is mx:
        mod.init_params(arg_params={k: mx.nd.array(v)
                                    for k, v in w0.items()})
        use = jsh.use(jsh.MeshContext.create(mesh) if mesh else None)
    else:
        mod.init_params(arg_params=pkg.convert.params_from_mxtpu(w0, "cpu"))
        use = pkg.sharding.use(_mesh(pkg, mesh) if mesh else None)
    with use:
        mod.init_optimizer(**opt)
        for xb, yb in _lm_batches(3):
            mod.forward_backward(pkg.io.DataBatch(
                [pkg.nd.array(xb, ctx=on)], [pkg.nd.array(yb, ctx=on)]))
            mod.update()
    return (mod.get_outputs()[0].asnumpy(),
            {k: v.asnumpy() for k, v in mod.get_params()[0].items()}, mod)


LM = dict(vocab_size=20, seq_len=16, num_layers=2, num_heads=2, d_model=64)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_lm_steps_on_a_tp_mesh_match_mxtpu(tt, optimizer):
    """A 2-layer, d=64 LM for 3 steps on data:2,tp:2: tok_emb's columns
    and every projection's input features over tp. With SGD (momentum
    0.9) at mxtpu's gate. With Adam, whose normalisation turns an
    element's rounding noise into a step of +-lr where its gradient is
    near zero (exactly zero for the key biases: ROADMAP C), mxtpu's own
    tp run and its one-device run already differ beyond that gate: the
    port's tp run is held to mxtpu's tp run within four times mxtpu's
    own spread (outputs, and the share of weight elements outside the
    gate), and no element further than two walks of 3 steps of lr."""
    _, mt = tt
    shapes = [("data", (4, 16)), ("softmax_label", (64,))]
    init = mx.mod.Module(mx.models.get_transformer_lm(**LM),
                         context=mx.cpu(), logger=_quiet())
    init.bind(data_shapes=shapes[:1], label_shapes=shapes[1:])
    mx.random.seed(4)
    init.init_params(mx.initializer.Xavier())
    w0 = {k: v.asnumpy() for k, v in init.get_params()[0].items()}
    lr = 1e-2
    params = {"learning_rate": lr}
    if optimizer == "sgd":
        params["momentum"] = 0.9
    opt = dict(optimizer=optimizer, optimizer_params=params)
    jo, jw, _ = _lm_run(mx, w0, opt, "data:2,tp:2")
    to, tw, tmod = _lm_run(mt, w0, opt, "data:2,tp:2")
    lay = tmod._fused._plan.replica_layout()
    assert lay.specs["tok_emb_weight"] == ((), ("tp",))
    assert lay.specs["lm_head_weight"] == ((), ("tp",))
    if optimizer == "sgd":
        np.testing.assert_allclose(to, jo, rtol=0, atol=1e-5)
        for k in jw:
            np.testing.assert_allclose(tw[k], jw[k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        return
    so, sw, _ = _lm_run(mx, w0, opt, None)

    def outside(a, b):
        n = sum(int((~np.isclose(a[k], b[k], rtol=1e-4, atol=1e-5)).sum())
                for k in b)
        return n / sum(v.size for v in b.values())
    spread, share = float(np.abs(so - jo).max()), outside(sw, jw)
    assert np.abs(to - jo).max() <= max(1e-5, 4 * spread), spread
    assert outside(tw, jw) <= max(4 * share, 1e-3), share
    for k in jw:
        assert np.abs(tw[k] - jw[k]).max() <= 2 * 3 * lr + 1e-6, k


@pytest.mark.parametrize("spec", ["data:2,tp:2", "data:2,fsdp:2,tp:2"])
def test_a_checkpoint_under_a_sharded_plan_loads_everywhere(
        tt, mlp_runs, tmp_path, spec):
    """save_checkpoint under a 2-D and a 3-D plan writes the assembled
    weights: mxtpu loads them, a one-context port Module loads the same
    arrays as get_params; the optimizer states gather to full size, load
    back into the plan bit for bit and into a one-context Module."""
    torch, mt = tt
    _, (_, tw, tmod) = mlp_runs[spec]
    prefix = str(tmp_path / "mesh")
    tmod.save_checkpoint(prefix, 3, save_optimizer_states=True)
    _, jargs, _ = mx.model.load_checkpoint(prefix, 3)
    for k in tw:
        np.testing.assert_array_equal(jargs[k].asnumpy(), tw[k], err_msg=k)
    one = mt.mod.Module.load(prefix, 3, load_optimizer_states=True,
                             context=mt.cpu(), logger=_quiet())
    one.bind(data_shapes=[("data", (64, 784))],
             label_shapes=[("softmax_label", (64,))])
    one.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.05, "momentum": 0.9})
    got = {k: v.asnumpy() for k, v in one.get_params()[0].items()}
    for k in tw:
        np.testing.assert_array_equal(got[k], tw[k], err_msg=k)
    fused = tmod._fused
    full = fused.export_opt_state()
    want = {k: v.copy() for k, v in full.items()}
    before = [{k: s.clone() for k, s in st.items()} for st in
              fused.opt_state]
    for st in fused.opt_state:
        for s in st.values():
            s.zero_()
    tmod.load_optimizer_states(prefix + "-0003.states")
    for b, st in zip(before, fused.opt_state):
        for k in b:
            assert torch.equal(b[k], st[k]), k
    mine = one._fused.export_opt_state()
    for idx in want:
        np.testing.assert_array_equal(mine[idx], want[idx])
        shape = tmod._fused._plan.param_shapes[
            fused.optimizer.idx2name[idx]]
        assert want[idx].shape == shape


def _dp_mlp(pkg):
    s = pkg.sym
    h = s.FullyConnected(s.Variable("data"), num_hidden=512, name="fc1")
    h = s.Activation(h, act_type="relu")
    h = s.FullyConnected(h, num_hidden=256, name="fc2")
    h = s.Activation(h, act_type="relu")
    h = s.FullyConnected(h, num_hidden=4, name="fc3")
    return s.SoftmaxOutput(h, name="softmax")


def test_dp_trainer_tensor_sharding_matches_mxtpu(tt):
    """mxtpu's test_dp_trainer_tensor_sharding (tests/test_parallel.py:
    53-64) at widths where the plan splits: on a (4, 2) ('data', 'model')
    mesh, fc1 (512x128) and fc2 (256x512) over 'model' by rows, each
    card holding half of them, 3 SGD steps from mxtpu's trainer's
    weights, within mxtpu's dp tolerance (rtol 2e-4, atol 2e-5);
    shard_update is off, as mxtpu's :87 forces it."""
    import jax.numpy as jnp
    torch, mt = tt
    from mxtpu.parallel import DataParallelTrainer, make_mesh
    shapes = {"data": (16, 128), "softmax_label": (16,)}
    jtr = DataParallelTrainer(_dp_mlp(mx), mesh=make_mesh(shape=(4, 2)),
                              optimizer="sgd", shard_params=True,
                              optimizer_params={"learning_rate": 0.1,
                                                "momentum": 0.9},
                              shard_update=True)
    jtr.init(shapes)
    assert not jtr.shard_update
    w0 = {k: np.asarray(v) for k, v in jtr._params.items()}
    ttr = mt.parallel.DataParallelTrainer(
        _dp_mlp(mt), mesh=mt.parallel.make_mesh(
            (4, 2), devices=[mt.cpu(i) for i in range(8)]),
        optimizer="sgd", shard_params=True, shard_update=True,
        optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    ttr.init(shapes)
    ttr._module.set_params(mt.convert.params_from_mxtpu(w0, "cpu"), {})
    rng = np.random.RandomState(3)
    for _ in range(3):
        X = rng.randn(16, 128).astype("f4")
        y = rng.randint(0, 4, 16).astype("f4")
        jout = jtr.step({"data": jnp.asarray(X),
                         "softmax_label": jnp.asarray(y)})
        tout = ttr.step({"data": X, "softmax_label": y})
    assert tuple(tout[0].shape) == (16, 4)
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                               rtol=2e-4, atol=2e-5)
    got = ttr.params
    for k, v in jtr.params.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    lay = ttr.fused._plan.replica_layout()
    assert sorted(lay.specs) == ["fc1_weight", "fc2_weight"]
    ex = ttr._module._exec_group.execs[0]
    assert tuple(ex.arg_dict["fc1_weight"].shape) == (256, 128)
    assert tuple(ex.arg_dict["fc2_weight"].shape) == (128, 512)
    assert ttr.fused.sharded_names == []
