"""mxtpu_torch.sharding and Module.fit(mesh=...) against mxtpu, on the CPU.

``cpu(0..7)`` are distinct contexts on the one host device in the port,
as they are 8 virtual XLA host devices in mxtpu (conftest). The port's
mesh defaults to the CUDA devices, so each test names its host contexts.

- The spec golden table: ``parameter_spec_from_name`` and
  ``ShardingPlan``'s ``param_spec`` / ``opt_spec`` / ``decisions`` equal
  mxtpu's, as tuples, over the parameter names and shapes of resnet-8,
  the LM and the mlp, on 1-D and 2-D meshes.
- Every ``MeshContext.create`` form and its errors; the active mesh per
  thread; ``resolve`` / ``MXTPU_MESH`` / ``mesh=False``.
- ``fit(mesh=4)`` of the mlp and of resnet-8 against mxtpu's
  ``fit(mesh=4)`` from the same weights, at mxtpu's own gate
  (tests/test_sharding.py:196-206: accuracy equal, cross-entropy within
  1e-5 relative, weights within rtol 1e-4 / atol 1e-5); the mlp bit for
  bit against the port's replicated path; each replica's optimizer-state
  bytes at most total/4 plus the replicated states (as
  tests/test_sharding.py:232-246 reckons it); one reduce-scatter and one
  all-gather a step; a mesh the batch does not divide declined; a tp
  axis raising; the optimizer-state file round trip under a plan.
- The KVStore veneer against the host loop, and declining a multi-axis
  mesh.
"""
import logging
import threading

import numpy as np
import pytest

import mxtpu as mx
from mxtpu import sharding as jsh

CPUS = 8


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


def _cpus(mt, n=CPUS):
    return [mt.cpu(i) for i in range(n)]


def _mesh(mt, spec):
    return mt.sharding.MeshContext.create(spec, devices=_cpus(mt))


# ---------------------------------------------------------------- specs
RESNET8 = (10, 8, (3, 28, 28))
LM = dict(vocab_size=64, seq_len=16, num_layers=2, num_heads=2, d_model=32,
          d_ff=64)


def _param_shapes(pkg, model):
    if model == "resnet8":
        sym = pkg.models.resnet.get_symbol(*RESNET8)
        shapes = {"data": (8,) + RESNET8[2]}
    elif model == "lm":
        sym = pkg.models.transformer.get_symbol(**LM)
        shapes = {"data": (2, LM["seq_len"])}
    else:
        sym = pkg.models.mlp.get_symbol(10)
        shapes = {"data": (8, 784)}
    args, _, _ = sym.infer_shape(**shapes)
    return {n: tuple(s) for n, s in zip(sym.list_arguments(), args)
            if n not in ("data", "softmax_label")}


#: mxtpu's golden table (tests/test_sharding.py:43-80), as tuples
_GOLDEN = {
    "fc1_weight": ("fsdp", "tp"), "fc1_bias": (),
    "fc2_weight": ("fsdp", "tp"), "fc2_bias": (),
    "fc3_weight": ("fsdp", "tp"), "fc3_bias": (),
    "conv1_weight": ("fsdp", "tp"), "conv1_bias": (),
    "conv2_weight": ("fsdp", "tp"), "conv2_bias": (),
    "embed_weight": (("fsdp", "tp"), None),
    "lstm_l0_i2h_weight": ("fsdp", "tp"), "lstm_l0_i2h_bias": (),
    "lstm_l0_h2h_weight": ("fsdp", "tp"), "lstm_l0_h2h_bias": (),
    "pred_weight": ("fsdp", "tp"), "pred_bias": (),
    "bn0_gamma": (), "bn0_beta": (), "bn0_moving_mean": (),
    "bn0_moving_var": (), "mystery_state": (), "rho": (),
    "self_attn.o_proj.weight": ("fsdp", None),
    "transformer_h0_attn_qkv_weight": ("fsdp", "tp"),
}


def test_parameter_spec_golden_table_matches_mxtpu(tt):
    """mxtpu's golden table and every name of the three models: the same
    spec as mxtpu's, as a tuple."""
    _, mt = tt
    names = set(_GOLDEN)
    for model in ("resnet8", "lm", "mlp"):
        names |= set(_param_shapes(mx, model))
    for name in sorted(names):
        got = mt.sharding.parameter_spec_from_name(name)
        want = jsh.parameter_spec_from_name(name)
        assert tuple(got) == tuple(want), name
        if name in _GOLDEN:
            assert tuple(got) == _GOLDEN[name], name


@pytest.mark.parametrize("mesh", ["8", "4", "4x2", "data:2,tp:4",
                                  "fsdp:2,data:2"])
@pytest.mark.parametrize("model", ["resnet8", "lm", "mlp"])
def test_plan_matches_mxtpu(tt, model, mesh):
    """param_spec, opt_spec, decisions (raw, final, reasons), the sharded
    names and validate() equal mxtpu's plan for the same shapes."""
    _, mt = tt
    shapes = _param_shapes(mx, model)
    assert shapes == _param_shapes(mt, model)
    trainable = sorted(shapes)[1:]  # one frozen parameter
    jplan = jsh.ShardingPlan(jsh.MeshContext.create(mesh), shapes,
                             trainable=trainable)
    tplan = mt.sharding.ShardingPlan(_mesh(mt, mesh), shapes,
                                     trainable=trainable)
    for name in shapes:
        assert tuple(tplan.param_spec(name)) == \
            tuple(jplan.param_spec(name)), name
        assert tuple(tplan.opt_spec(name)) == tuple(jplan.opt_spec(name)), \
            name
        jraw, jfinal, jwhy = jplan.decisions[name]
        traw, tfinal, twhy = tplan.decisions[name]
        assert (tuple(traw), tuple(tfinal), twhy) == \
            (tuple(jraw), tuple(jfinal), jwhy), name
    assert sorted(tplan.sharded_opt_names()) == \
        sorted(jplan.sharded_opt_names())
    assert [(i["kind"], i["name"], i["message"]) for i in tplan.validate()] \
        == [(i["kind"], i["name"], i["message"]) for i in jplan.validate()]
    assert tplan.describe()["sharded_opt"] == \
        jplan.describe()["sharded_opt"]


def test_plan_weight_update_specs(tt):
    """mxtpu's test_plan_weight_update_specs on the port's plan: fc1/fc2
    state shards over data, fc3 (10 rows) and the biases replicate;
    batch and naive specs; shard_update=False keeps the param specs."""
    _, mt = tt
    P = mt.sharding.PartitionSpec
    mc = _mesh(mt, 8)
    shapes = {"fc1_weight": (128, 784), "fc1_bias": (128,),
              "fc2_weight": (64, 128), "fc2_bias": (64,),
              "fc3_weight": (10, 64), "fc3_bias": (10,)}
    plan = mt.sharding.ShardingPlan(
        mc, shapes, data_names=["data"], label_names=["softmax_label"],
        batch_shapes={"data": (64, 784), "softmax_label": (64,)})
    for name in shapes:
        assert plan.param_spec(name) == P()
    assert plan.opt_spec("fc1_weight") == P("data") == ("data",)
    assert plan.opt_spec("fc2_weight") == P("data")
    assert plan.opt_spec("fc3_weight") == P()
    assert plan.opt_spec("fc1_bias") == P()
    assert sorted(plan.sharded_opt_names()) == ["fc1_weight", "fc2_weight"]
    assert plan.batch_spec("data") == P("data")
    assert mt.sharding.naive_spec((30, 16), mc) == P()
    assert mt.sharding.naive_spec((64, 16), mc) == P("data")
    off = mt.sharding.ShardingPlan(mc, shapes, shard_update=False)
    assert off.opt_spec("fc1_weight") == P()
    assert off.sharded_opt_names() == []
    small = mt.sharding.ShardingPlan(mc, shapes, min_shard_elems=10 ** 6)
    assert small.sharded_opt_names() == []
    assert mt.sharding.spec_from_json(mt.sharding.spec_to_json(
        P(("data", "tp"), None))) == P(("data", "tp"), None)


def test_heuristic_rank_prune_is_not_an_error(tt):
    _, mt = tt
    plan = mt.sharding.ShardingPlan(_mesh(mt, 8), {"scale_weight": (7,)})
    assert plan.param_spec("scale_weight") == ()
    kinds = {i["kind"] for i in plan.validate()}
    assert "rank_mismatch" not in kinds and "rank_pruned" in kinds
    typo = mt.sharding.ShardingPlan(
        _mesh(mt, 8), {"w": (8, 4)},
        overrides={"w": mt.sharding.PartitionSpec("dtaa", None)})
    assert [i["kind"] for i in typo.validate()] == ["axis_typo"]


# ---------------------------------------------------------------- mesh
def test_mesh_context_forms(tt):
    """Every form mxtpu's create takes, over host contexts; the mesh's
    devices are contexts in mesh order."""
    torch, mt = tt
    sh = mt.sharding
    cpus = _cpus(mt)
    for spec in ("all", "auto", True, None):
        assert sh.MeshContext.create(spec, devices=cpus).axis_sizes == \
            {"data": 8}
    assert sh.MeshContext.create(8, devices=cpus).axis_sizes == {"data": 8}
    assert sh.MeshContext.create("4", devices=cpus).devices == cpus[:4]
    assert sh.MeshContext.create("4x2", devices=cpus).axis_sizes == \
        {"data": 4, "tp": 2}
    assert sh.MeshContext.create("2x2x2", devices=cpus).axis_sizes == \
        {"data": 2, "tp": 2, "fsdp": 2}
    assert sh.MeshContext.create("data:2,tp:4", devices=cpus).axis_sizes \
        == {"data": 2, "tp": 4}
    raw = mt.parallel.make_mesh((4,), ("data",), devices=cpus[:4])
    mc = sh.MeshContext.create(raw)
    assert mc.mesh is raw and mc.n_data == 4 and mc.devices == cpus[:4]
    assert sh.MeshContext.create(mc) is mc
    assert sh.MeshContext.create("tp:4", devices=cpus).n_data == 1
    for bad, msg in (("definitely-not-a-mesh", "cannot parse"),
                     (10 ** 6, "needs 1000000 devices"),
                     ("1x1x1x1", "named 'axis:n")):
        with pytest.raises(mt.MXNetError, match=msg):
            sh.MeshContext.create(bad, devices=cpus)
    with pytest.raises(mt.MXNetError, match="Mesh"):
        sh.MeshContext(object())
    if not torch.cuda.is_available():
        with pytest.raises(mt.MXNetError, match="no CUDA device"):
            sh.MeshContext.create(4)


def test_active_mesh_is_per_thread_and_scoped(tt):
    _, mt = tt
    sh = mt.sharding
    seen = {}
    mc = _mesh(mt, 8)
    with sh.use(mc):
        t = threading.Thread(target=lambda: seen.setdefault("peer",
                                                            sh.active()))
        t.start()
        t.join()
        assert sh.active() is mc and sh.current() is mc
        assert sh.active_mesh() is mc.mesh
        with sh.use(sh.DISABLED):
            assert sh.active() is None and sh.current() is None
        assert sh.active() is mc
    assert seen["peer"] is None
    assert sh.active() is None
    with sh.use(None) as nothing:
        assert nothing is None
    prev = sh.activate(mc)
    assert prev is None and sh.deactivate() is mc


def test_resolve_and_env(tt, monkeypatch):
    """resolve(None) defers to MXTPU_MESH (parsed once per value), every
    off word disables even with it set; the env mesh's default devices
    are the CUDA devices (here replaced by host contexts)."""
    _, mt = tt
    sh = mt.sharding
    monkeypatch.setattr(sh.plan, "_cuda_contexts", lambda: _cpus(mt))
    monkeypatch.setattr(sh.plan, "_ENV_CACHE", {})
    assert sh.resolve(None) is None
    monkeypatch.setenv("MXTPU_MESH", "4")
    assert sh.resolve(None).axis_sizes == {"data": 4}
    assert sh.from_env() is sh.from_env()
    assert sh.current() is sh.from_env()
    for tok in (False, 0, "0", "none", "off", "false"):
        assert sh.resolve(tok) is sh.DISABLED, tok
    assert sh.resolve(2).axis_sizes == {"data": 2}
    monkeypatch.setenv("MXTPU_MESH", "off")
    assert sh.resolve(None) is None


def test_parallel_current_mesh_one_truth(tt, monkeypatch):
    """mxtpu's test_parallel_current_mesh_one_truth: active scope >
    make_mesh > MXTPU_MESH."""
    _, mt = tt
    from mxtpu_torch.parallel import mesh as pmesh
    sh = mt.sharding
    monkeypatch.setattr(sh.plan, "_cuda_contexts", lambda: _cpus(mt))
    monkeypatch.setattr(sh.plan, "_ENV_CACHE", {})
    monkeypatch.setattr(pmesh, "_current", None)
    mc = _mesh(mt, "data:4,tp:2")
    with sh.use(mc):
        assert pmesh.current_mesh() is mc.mesh
    monkeypatch.setenv("MXTPU_MESH", "4")
    made = pmesh.make_mesh((4, 2), ("data", "seq"), devices=_cpus(mt))
    assert pmesh.current_mesh() is made
    monkeypatch.setattr(pmesh, "_current", None)
    assert pmesh.current_mesh() is sh.from_env().mesh


# ---------------------------------------------------------------- fit
def _mnist_like(n=256, seed=7):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 784).astype("float32"),
            rng.randint(0, 10, n).astype("float32"))


@pytest.fixture(scope="module")
def mlp_w0():
    """Xavier-scaled mlp weights from a numpy seed."""
    rng = np.random.RandomState(11)
    out = {}
    for name, shape in _param_shapes(mx, "mlp").items():
        scale = np.sqrt(3.0 / shape[-1]) if len(shape) > 1 else 0.0
        out[name] = rng.uniform(-scale, scale, shape).astype(np.float32)
    return out


def _fit(pkg, contexts, w0, mesh, x, y, batch, num_epoch=2, a0=None,
         params=None):
    it = pkg.io.NDArrayIter(x, y, batch_size=batch,
                            label_name="softmax_label")
    sym = pkg.models.mlp.get_symbol(10) if a0 is None else \
        pkg.models.resnet.get_symbol(*RESNET8)
    mod = pkg.mod.Module(sym, context=contexts, logger=_quiet())
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


def _gate(got, want):
    """mxtpu's gate (tests/test_sharding.py:196-206)."""
    (gm, gw), (wm, ww) = got, want
    assert gm["accuracy"] == wm["accuracy"], (gm, wm)
    np.testing.assert_allclose(gm["cross-entropy"], wm["cross-entropy"],
                               rtol=1e-5)
    for k in ww:
        np.testing.assert_allclose(gw[k], ww[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.fixture(scope="module")
def mlp_runs(tt, mlp_w0):
    """mxtpu's fit(mesh=4) and the port's fit(mesh=4) from one context,
    and the port's replicated fused path over cpu(0..3)."""
    _, mt = tt
    x, y = _mnist_like()
    jm, jw, jmod = _fit(mx, mx.cpu(), mlp_w0, 4, x, y, 64)
    assert jmod._fused._plan is not None
    tm, tw, tmod = _fit(mt, mt.cpu(), mlp_w0, _mesh(mt, 4), x, y, 64)
    rm, rw, rmod = _fit(mt, _cpus(mt, 4), mlp_w0, False, x, y, 64)
    return (jm, jw), (tm, tw, tmod), (rm, rw, rmod)


def test_fit_mesh_mlp_matches_mxtpu(mlp_runs):
    """THE gate: the port's fit(mesh=4) against mxtpu's, and the plan
    armed over the mesh's 4 devices from a Module bound to cpu(0)."""
    (jm, jw), (tm, tw, tmod), _ = mlp_runs
    _gate((tm, tw), (jm, jw))
    fused = tmod._fused
    assert fused is not None and fused._plan is not None
    assert [str(c) for c in tmod._exec_group.contexts] == \
        ["cpu(%d)" % i for i in range(4)]
    assert sorted(fused.sharded_names) == ["fc1_weight", "fc2_weight"]


def test_fit_mesh_mlp_is_the_replicated_step(tt, mlp_runs):
    """On the host both sum the replicas in order, so the sharded step
    gives the replicated fused path's numbers bit for bit; the replicas
    hold the same bits."""
    torch, _ = tt
    _, (tm, tw, tmod), (rm, rw, rmod) = mlp_runs
    assert rmod._fused._plan is None
    assert tm == rm
    for k in rw:
        np.testing.assert_array_equal(tw[k], rw[k], err_msg=k)
    execs = tmod._exec_group.execs
    for k in tw:
        for e in execs[1:]:
            assert torch.equal(e.arg_dict[k]._data,
                               execs[0].arg_dict[k]._data), k


def test_optimizer_state_shards_per_replica(tt, mlp_runs):
    """Each replica keeps 1/4 of the sharded states' rows: its bytes are
    at most total/4 plus the replicated states (tests/test_sharding.py:
    232-246), and the momentum blocks stacked are the replicated path's
    momentum."""
    torch, _ = tt
    _, (_, _, tmod), (_, _, rmod) = mlp_runs
    fused = tmod._fused
    per = fused.opt_state_bytes()
    sharded = set(fused.sharded_names)
    repl = sum(s.numel() * 4 for k, s in fused.opt_state[0].items()
               if k not in sharded)
    total = sum(s.numel() * 4 for k, s in rmod._fused.opt_state[0].items())
    assert len(per) == 4 and len(set(per)) == 1
    for nbytes in per:
        assert nbytes <= total // 4 + repl, (nbytes, total, repl)
    assert per[0] < total
    for k in sharded:
        rows = [st[k] for st in fused.opt_state]
        assert rows[0].shape[0] * 4 == rmod._fused.opt_state[0][k].shape[0]
        assert torch.equal(torch.cat(rows), rmod._fused.opt_state[0][k]), k


def test_sharded_step_makes_one_reduce_scatter_and_one_all_gather(
        tt, mlp_w0, monkeypatch):
    """A step of the sharded mlp: one reduce-scatter and one all-gather
    (over flat buffers), and one all-reduce for the replicated rest;
    none per parameter."""
    _, mt = tt
    from mxtpu_torch.module import fused as F
    calls = {"rs": 0, "ag": 0, "ar": 0}

    def count(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped
    monkeypatch.setattr(F, "reduce_scatter_replicas",
                        count("rs", F.reduce_scatter_replicas))
    monkeypatch.setattr(F, "all_gather_replicas",
                        count("ag", F.all_gather_replicas))
    monkeypatch.setattr(F, "sum_replicas", count("ar", F.sum_replicas))
    x, y = _mnist_like(n=128)
    _, _, mod = _fit(mt, mt.cpu(), mlp_w0, _mesh(mt, 4), x, y, 64,
                     num_epoch=1)
    assert len(mod._fused.trainable) == 6
    assert calls == {"rs": 2, "ag": 2, "ar": 2}, calls


def test_replicated_gradients_are_summed_in_place(tt, mlp_w0):
    """Under the plan each replica's flat gradient buffer is laid out
    [updated whole | updated by rows]: the all-reduce runs on the leading
    segment of the executors' own buffer, with no copy, and a group laid
    out otherwise is refused."""
    torch, mt = tt
    from mxtpu_torch.module.fused import FusedTrainStep
    x, y = _mnist_like(n=64)
    _, _, mod = _fit(mt, mt.cpu(), mlp_w0, _mesh(mt, 4), x, y, 64,
                     num_epoch=1)
    fused, group = mod._fused, mod._exec_group
    sharded = set(fused.sharded_names)
    assert sharded and len(fused._all_reduce) == 1
    for r, (seg, flats) in enumerate(zip(fused._all_reduce[0],
                                         group.flat_grads)):
        flat = flats[torch.float32]
        assert seg.data_ptr() == flat.data_ptr()
        end = flat.data_ptr() + seg.numel() * 4
        for k in fused.trainable:
            ptr = fused.grads[r][k].data_ptr()
            assert (ptr >= end) == (k in sharded), k
    plain = mod._rebind(group.contexts, ())
    with pytest.raises(mt.base.MXNetError, match="lead each flat buffer"):
        FusedTrainStep(plain.execs, mod._param_names, mod._optimizer,
                       plain.flat_grads, plan=fused._plan)


@pytest.fixture(scope="module")
def resnet8_start():
    """mxtpu's Xavier weights for resnet-8, as numpy, and its initial
    moving statistics moved off their defaults."""
    init = mx.mod.Module(mx.models.resnet.get_symbol(*RESNET8),
                         context=mx.cpu(), logger=_quiet())
    init.bind(data_shapes=[("data", (32,) + RESNET8[2])],
              label_shapes=[("softmax_label", (32,))])
    mx.random.seed(4)
    init.init_params(mx.initializer.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2))
    w0, a0 = [{k: v.asnumpy() for k, v in d.items()}
              for d in init.get_params()]
    a0 = {k: (v + 0.1 if k.endswith("_moving_mean") else v * 1.5)
          for k, v in a0.items()}
    return w0, a0


def test_fit_mesh_resnet8_matches_mxtpu(tt, resnet8_start):
    """resnet-8 (BatchNorm over the whole batch on both sides), 2 SGD
    steps of B=32 through fit(mesh=4), at mxtpu's gate; the moving
    statistics within the same tolerance."""
    _, mt = tt
    w0, a0 = resnet8_start
    x = np.random.RandomState(0).rand(64, 3, 28, 28).astype(np.float32)
    y = np.random.RandomState(1).randint(0, 10, 64).astype(np.float32)
    sgd = {"learning_rate": 0.1, "momentum": 0.9, "rescale_grad": 1.0 / 32}
    jm, jw, jmod = _fit(mx, mx.cpu(), w0, 4, x, y, 32, 1, a0, sgd)
    tm, tw, tmod = _fit(mt, mt.cpu(), w0, _mesh(mt, 4), x, y, 32, 1, a0,
                        sgd)
    assert jmod._fused._plan is not None and tmod._fused._plan is not None
    assert tmod._fused.sharded_names
    _gate((tm, tw), (jm, jw))
    ja = {k: v.asnumpy() for k, v in jmod.get_params()[1].items()}
    ta = {k: v.asnumpy() for k, v in tmod.get_params()[1].items()}
    for k in ja:
        np.testing.assert_allclose(ta[k], ja[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_mesh_the_batch_does_not_divide_is_declined(tt, mlp_w0, caplog):
    """Batch 62 over a 4-way data axis: mxtpu's warning, the fused step
    without a plan on the module's own context, and the same numbers as
    no mesh at all."""
    _, mt = tt
    x, y = _mnist_like(n=124)
    log = logging.getLogger("decline")
    log.setLevel(logging.WARNING)
    it = mt.io.NDArrayIter(x, y, batch_size=62)
    mod = mt.mod.Module(mt.models.mlp.get_symbol(10), context=mt.cpu(),
                        logger=log)
    with caplog.at_level(logging.WARNING, logger="decline"):
        mod.fit(it, num_epoch=1, arg_params=mt.convert.params_from_mxtpu(
            mlp_w0, "cpu"), mesh=_mesh(mt, 4))
    assert "does not divide over the 4-way data axis" in caplog.text
    assert mod._fused is not None and mod._fused._plan is None
    assert len(mod._exec_group.contexts) == 1
    _, want, _ = _fit(mt, mt.cpu(), mlp_w0, None, x, y, 62, num_epoch=1,
                      params={"learning_rate": 0.01})
    got = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_mesh_false_beats_the_environment(tt, mlp_w0, monkeypatch):
    """MXTPU_MESH arms the plan; fit(mesh=False) turns it off."""
    _, mt = tt
    sh = mt.sharding
    monkeypatch.setattr(sh.plan, "_cuda_contexts", lambda: _cpus(mt))
    monkeypatch.setattr(sh.plan, "_ENV_CACHE", {})
    monkeypatch.setenv("MXTPU_MESH", "4")
    x, y = _mnist_like(n=128)
    _, _, env = _fit(mt, mt.cpu(), mlp_w0, None, x, y, 64, num_epoch=1)
    assert env._fused._plan is not None
    assert len(env._exec_group.contexts) == 4
    _, _, off = _fit(mt, mt.cpu(), mlp_w0, False, x, y, 64, num_epoch=1)
    assert off._fused is not None and off._fused._plan is None
    assert len(off._exec_group.contexts) == 1


@pytest.mark.parametrize("spec", ["data:2,tp:2", "4x2", "fsdp:2,data:2"])
def test_a_multi_axis_mesh_raises_naming_the_axis(tt, mlp_w0, spec):
    """A mesh with a tp or fsdp axis no longer raises: fit on it matches
    mxtpu's fit on the same spec at mxtpu's gate, with the plan armed
    over the mesh's devices and the tp/fsdp-split weights held in blocks
    (tests/test_torch_mesh_tp.py holds the rest)."""
    _, mt = tt
    x, y = _mnist_like(n=128)
    jm, jw, _ = _fit(mx, mx.cpu(), mlp_w0, spec, x, y, 64, num_epoch=1)
    tm, tw, tmod = _fit(mt, mt.cpu(), mlp_w0, _mesh(mt, spec), x, y, 64,
                        num_epoch=1)
    _gate((tm, tw), (jm, jw))
    lay = tmod._fused._plan.replica_layout()
    axis = "tp" if "tp" in spec or "x" in spec else "fsdp"
    assert len(tmod._exec_group.execs) == lay.n == (8 if "x" in spec
                                                    else 4)
    assert {a for e in lay.specs.values() for axes in e for a in axes} \
        == {axis}


def test_optimizer_states_round_trip_under_a_plan(tt, mlp_runs, tmp_path):
    """save_optimizer_states gathers the row blocks into the full-size
    pickle (the replicated path's file, bit for bit); loading it splits
    them back; a replicated module loads the same file."""
    torch, mt = tt
    _, (_, _, tmod), (_, _, rmod) = mlp_runs
    path = str(tmp_path / "mesh.states")
    tmod.save_optimizer_states(path)
    rpath = str(tmp_path / "repl.states")
    rmod.save_optimizer_states(rpath)
    import pickle
    with open(path, "rb") as f:
        mine = pickle.load(f)
    with open(rpath, "rb") as f:
        theirs = pickle.load(f)
    assert sorted(mine) == sorted(theirs)
    for idx in theirs:
        np.testing.assert_array_equal(mine[idx], theirs[idx])
    fused = tmod._fused
    before = [{k: v.clone() for k, v in st.items()}
              for st in fused.opt_state]
    for st in fused.opt_state:
        for v in st.values():
            v.zero_()
    tmod.load_optimizer_states(path)
    for st, old in zip(fused.opt_state, before):
        for k in old:
            assert torch.equal(st[k], old[k]), k
    sharded = fused.sharded_names[0]
    assert fused.opt_state[0][sharded].shape[0] * 4 == \
        rmod._fused.opt_state[0][sharded].shape[0]
    rmod.load_optimizer_states(path)
    for k, v in rmod._fused.opt_state[0].items():
        assert torch.equal(v, torch.cat([st[k] for st in fused.opt_state])
                           if k in fused.sharded_names
                           else fused.opt_state[0][k]), k


def test_set_params_keeps_the_momentum_under_a_plan(tt, mlp_runs):
    """get_params/set_params parity: the values come back, the replicas
    all take them, the sharded momentum is untouched."""
    torch, mt = tt
    _, (_, _, tmod), _ = mlp_runs
    args, auxs = tmod.get_params()
    mom = [{k: v.clone() for k, v in st.items()}
           for st in tmod._fused.opt_state]
    new = {k: mt.nd.array(v.asnumpy() + 1.0, ctx=mt.cpu())
           for k, v in args.items()}
    tmod.set_params(new, auxs)
    for e in tmod._exec_group.execs:
        for k, v in new.items():
            assert torch.equal(e.arg_dict[k]._data, v._data), k
    for st, old in zip(tmod._fused.opt_state, mom):
        for k in old:
            assert torch.equal(st[k], old[k]), k
    tmod.set_params(args, auxs)


# ---------------------------------------------------------------- kvstore
def test_kvstore_mesh_veneer_matches_host_loop(tt):
    """'device' push of one value per mesh device: one all-reduce (the
    counter moves by one), the sum bit for bit the host loop's, each
    device pulling its own copy; an updater on the store still sees the
    sum."""
    torch, mt = tt
    cpus = _cpus(mt)
    rng = np.random.RandomState(3)
    host_vals = [rng.randn(16, 5).astype("f4") for _ in range(8)]

    def push_pull(kv):
        vals = [mt.nd.array(v, ctx=c) for v, c in zip(host_vals, cpus)]
        kv.init("w", mt.nd.zeros((16, 5), ctx=cpus[0]))
        kv.push("w", vals)
        outs = [mt.nd.zeros((16, 5), ctx=c) for c in cpus]
        kv.pull("w", out=outs)
        return outs, vals

    legacy, _ = push_pull(mt.kv.create("device"))
    with mt.sharding.use(_mesh(mt, "all")):
        kv = mt.kv.create("device")
        mesh_outs, vals = push_pull(kv)
    assert kv.mesh_allreduces == 1
    want = host_vals[0]
    for v in host_vals[1:]:
        want = want + v
    for i, (a, b) in enumerate(zip(legacy, mesh_outs)):
        np.testing.assert_array_equal(a.asnumpy(), want)
        np.testing.assert_array_equal(b.asnumpy(), a.asnumpy(),
                                      err_msg="device %d" % i)
    for v, h in zip(vals, host_vals):  # the callers' arrays untouched
        np.testing.assert_array_equal(v.asnumpy(), h)
    opt = mt.optimizer.SGD(learning_rate=0.5, rescale_grad=1.0)
    with mt.sharding.use(_mesh(mt, "all")):
        kv = mt.kv.create("device")
        kv.set_optimizer(opt)
        kv.init("3", mt.nd.ones((4, 4), ctx=cpus[0]))
        kv.push("3", [mt.nd.array(np.ones((4, 4), "f4"), ctx=c)
                      for c in cpus])
        out = mt.nd.zeros((4, 4), ctx=cpus[0])
        kv.pull("3", out=out)
    assert kv.mesh_allreduces == 1
    np.testing.assert_allclose(out.asnumpy(), 1.0 - 0.5 * 8.0, rtol=1e-6)


def test_kvstore_veneer_declines(tt):
    """A multi-axis mesh, a value list that is not the mesh's devices,
    and a mesh of one device take the host loop (no all-reduce); the
    values are right either way."""
    _, mt = tt
    cpus = _cpus(mt)
    host_vals = [np.full((8, 3), i + 1.0, "f4") for i in range(8)]
    for mesh, ctxs in (("data:4,tp:2", cpus), ("4", cpus),
                       ("8", cpus[:4]), ("1", cpus[:1])):
        with mt.sharding.use(_mesh(mt, mesh)):
            kv = mt.kv.create("device")
            kv.init("w", mt.nd.zeros((8, 3), ctx=cpus[0]))
            kv.push("w", [mt.nd.array(host_vals[i], ctx=c)
                          for i, c in enumerate(ctxs)])
            out = mt.nd.zeros((8, 3), ctx=cpus[0])
            kv.pull("w", out=out)
        assert kv.mesh_allreduces == 0, mesh
        np.testing.assert_array_equal(
            out.asnumpy(), np.sum(host_vals[:len(ctxs)], axis=0))
