"""The port's compile pipeline (``mxtpu_torch.compile``) held to mxtpu's:
``transform_graph`` rewrites every fixture graph under every config of
``graphgen.CONFIGS`` into mxtpu's JSON byte for byte with the same report;
an empty pipeline changes nothing; a fit builds the same program kinds;
the build seam's program table, prewarm scope, config knobs and the fused
step's one transform. mxtpu's AOT compile and its demotion on signature
misses have no counterpart in eager torch: two tests pin those deltas."""
import logging

import numpy as np
import pytest

from compile_cases import build, entries, seeded_params, values_for

CONFIGS = (("fuse_opt",), ("remat_reuse",), ("layout",), ("bf16",),
           ("quant",), ("layout", "bf16"), ("bf16", "fuse_opt",
                                            "remat_reuse"),
           ("layout", "bf16", "fuse_opt", "remat_reuse"))


@pytest.fixture(scope="module")
def pkgs():
    import torch
    torch.set_num_threads(2)
    import mxtpu
    import mxtpu_torch
    return mxtpu, mxtpu_torch


def _transform(pkg, name, cfg):
    sym, shapes = build(pkg, name)
    kind = "executor_infer" if "quant" in cfg else "fused_step"
    values = None
    if "quant" in cfg:
        values = values_for(pkg, seeded_params(sym, shapes)[0])
    return pkg.compile.pipeline.transform_graph(
        sym, kind=kind, shapes=shapes, passes=cfg, values=values)


@pytest.mark.parametrize("cfg", CONFIGS, ids="+".join)
@pytest.mark.parametrize("name", ["mlp", "lenet", "resnet8", "resnet50",
                                  "lm2"])
def test_transform_graph_equals_mxtpu(pkgs, name, cfg):
    """The rewritten graph's JSON, the applied/rejected passes, each
    pass's actions and certificate tag, and the executor contract of
    prepared (int8) arguments: all mxtpu's."""
    mx, mt = pkgs
    assert tuple(mx.analysis.graphgen.CONFIGS) == CONFIGS
    ref, rrep = _transform(mx, name, cfg)
    got, grep_ = _transform(mt, name, cfg)
    assert got.tojson() == ref.tojson()
    assert grep_.applied == rrep.applied and \
        grep_.rejected == rrep.rejected
    assert entries(grep_) == entries(rrep)
    assert [(f.pass_name, f.severity, f.node, f.message)
            for f in grep_.findings()] == \
        [(f.pass_name, f.severity, f.node, f.message)
         for f in rrep.findings()]
    assert grep_.cert == rrep.cert and grep_.precision == rrep.precision
    assert grep_.prepared_args == rrep.prepared_args


def test_empty_pipeline_changes_nothing(pkgs):
    """The default pipeline is empty: the graph comes back as the same
    object, and an executor's plans are built from its own symbol."""
    mx, mt = pkgs
    assert mt.compile.configured() == () == mx.compile.configured()
    sym, shapes = build(mt, "lenet")
    same, rep = mt.compile.transform_graph(sym, shapes=shapes)
    assert same is sym and rep.applied == [] and rep.entries == []
    ex = sym.simple_bind(mt.cpu(), grad_req="null", **shapes)
    assert ex._program_symbol((), infer=True) is sym
    ex.forward()
    assert ex.pipeline_report is None and ex._prepared_args == {}


def _fit_builds(pkg):
    seen = []
    fn = pkg.compile.add_build_listener(lambda kind, owner: seen.append(
        (kind, type(owner).__name__)))
    try:
        sym = pkg.models.mlp.get_symbol(10)
        rng = np.random.RandomState(0)
        x = rng.rand(48, 784).astype(np.float32)
        y = rng.randint(0, 10, 48).astype(np.float32)
        mod = pkg.mod.Module(sym, context=pkg.cpu(),
                             logger=logging.getLogger("quiet"))
        mod.fit(pkg.io.NDArrayIter(x, y, batch_size=16), num_epoch=2,
                optimizer="sgd",
                eval_data=pkg.io.NDArrayIter(x, y, batch_size=16))
    finally:
        pkg.compile.remove_build_listener(fn)
    return seen


def test_fit_builds_the_program_kinds_of_mxtpu(pkgs):
    """A fit builds one fused step, one metric accumulator (shared
    process-wide per recipe) and one eval program, as mxtpu's does; a
    second fit builds no accumulator."""
    mx, mt = pkgs
    mx.metric._ACCUM_FN_CACHE.clear()
    mt.metric._ACCUM_FN_CACHE.clear()
    first = _fit_builds(mt)
    assert [k for k, _ in first] == [k for k, _ in _fit_builds(mx)]
    assert first == [("fused_step", "Executor"),
                     ("metric_accum", "DeviceMetricAccum"),
                     ("fwd_eval", "Executor")]
    assert [k for k, _ in _fit_builds(mt)] == \
        [k for k, _ in _fit_builds(mx)] == ["fused_step", "fwd_eval"]


def test_program_table_records_each_first_call(pkgs):
    """Each built program's first call lands in the program table with
    its operations, bytes and kind, and in executor_compile_ms once; the
    table renders mxtpu's columns."""
    mx, mt = pkgs
    tel = mt.telemetry
    diag = mt.diagnostics
    before = {k: tel.histogram("executor_compile_ms",
                               labels={"kind": k}).count
              for k in ("fwd_eval", "fwd_bwd")}
    n0 = len(diag.programs())
    sym, shapes = build(mt, "lenet")
    ex = sym.simple_bind(mt.cpu(), **shapes)
    for _ in range(3):
        ex.forward(is_train=True)
        ex.backward()
        ex.forward()
    recs = diag.programs()[n0:]
    assert [r["kind"] for r in recs] == ["fwd_bwd", "fwd_eval"]
    for r in recs:
        assert r["flops"] > 0 and r["bytes_accessed"] > 0
        assert r["calls"] == 3 and r["owner"] == "Executor"
        assert r["precision"] == "f32" and r["transforms"] == []
    for k, n in before.items():
        assert tel.histogram("executor_compile_ms",
                             labels={"kind": k}).count == n + 1
    head = diag.program_table().splitlines()[0]
    assert head == mx.diagnostics.program_table().splitlines()[0]


def test_no_ahead_of_time_compile(pkgs):
    """Deliberate delta: mxtpu lowers and compiles a program at its first
    call (``fn.lower().compile()``) and keeps the executable; the port's
    program is the eager plan, so the first call runs it under the cost
    counter and no executable exists (no ``hlo_text``)."""
    _mx, mt = pkgs
    seen = []

    def plan(x):
        seen.append(x)
        return ([x * 2],), {}

    fn = mt.compile.record_program_build("fwd_eval", "plain", plan)
    import torch
    assert fn(torch.ones(3))[0][0][0].tolist() == [2.0, 2.0, 2.0]
    rec = mt.diagnostics.latest_record("fwd_eval")
    assert rec.owner == "plain" and rec.calls == 1
    assert not hasattr(rec, "hlo_text") and len(seen) == 1


def test_no_demotion_on_signature_change(pkgs):
    """Deliberate delta: mxtpu keeps the first call's executable for its
    signature and demotes to jit after repeated misses; an eager plan has
    no signature, so calls of any shape run the same plan, each counted
    on the one record."""
    _mx, mt = pkgs
    import torch
    fn = mt.compile.instrument_program("fwd_eval",
                                       lambda x: ([[x.sum()]], {}),
                                       owner="plain")
    for n in (3, 5, 7, 5, 3):
        assert float(fn(torch.ones(n))[0][0][0]) == n
    assert mt.diagnostics.latest_record("fwd_eval").calls == 5


def test_prewarm_scope_and_build_count_like_mxtpu(pkgs):
    mx, mt = pkgs
    for pkg in (mx, mt):
        pipe = pkg.compile.pipeline
        b0, p0 = pipe.program_build_count(), pipe.prewarm_build_count()
        pipe.notify_build("fwd_eval", "x")
        with pipe.prewarm_scope():
            assert pipe.in_prewarm()
            pipe.notify_build("fwd_eval", "x")
        assert not pipe.in_prewarm()
        assert pipe.program_build_count() == b0 + 2
        assert pipe.prewarm_build_count() == p0 + 1


@pytest.mark.parametrize("raw", ["", "off", "bf16", "remat_reuse, layout",
                                 " quant ,bf16,"])
def test_pipeline_env_and_canonical_order_like_mxtpu(pkgs, monkeypatch,
                                                     raw):
    mx, mt = pkgs
    monkeypatch.setenv("MXTPU_PIPELINE", raw)
    got = []
    for pkg in (mx, mt):
        pipe = pkg.compile.pipeline
        with pipe.pipeline_scope(None):
            names = pipe.configured()
            got.append((names, pipe.canonical_order(names)))
        assert pipe.configured() == ()
    assert got[0] == got[1]


def test_tuned_artifact_sets_the_pipeline_like_mxtpu(pkgs, monkeypatch):
    """``compile.pipeline`` from a TunedConfig applies through
    ``tune.use`` (refresh_from_knobs) unless configure() pinned one."""
    mx, mt = pkgs
    monkeypatch.delenv("MXTPU_PIPELINE", raising=False)
    for pkg in (mx, mt):
        cfg = pkg.tune.TunedConfig({"compile.pipeline": "bf16,layout"})
        prev = pkg.tune.active()
        try:
            pkg.tune.use(cfg)
            assert pkg.compile.configured() == ("bf16", "layout")
            with pkg.compile.pipeline_scope(["fuse_opt"]):
                assert pkg.compile.configured() == ("fuse_opt",)
            assert pkg.compile.configured() == ("bf16", "layout")
        finally:
            pkg.tune.use(prev)
        assert pkg.compile.configured() == ()


def test_fused_step_transforms_once_and_warns_on_drift(pkgs, caplog):
    """The fused step runs the pipeline once, at construction, as
    ``fused_step``: its executors train the rewritten graph (bf16 here),
    and a later change of the config warns once and changes nothing."""
    _mx, mt = pkgs
    sym, _ = build(mt, "mlp")
    rng = np.random.RandomState(0)
    x = rng.rand(16, 784).astype(np.float32)
    y = rng.randint(0, 10, 16).astype(np.float32)
    mod = mt.mod.Module(sym, context=mt.cpu(),
                        logger=logging.getLogger("drift"))
    it = mt.io.NDArrayIter(x, y, batch_size=8)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params()
    with mt.compile.pipeline_scope(["bf16"]):
        mod.init_optimizer()
    fused = mod._fused
    assert fused.pipeline_report.applied == ["bf16"]
    ex = mod._exec_group.execs[0]
    kind, graph, report, remat = ex._train_program
    assert kind == "fused_step" and graph is fused._graph_symbol
    assert any(n.op is not None and n.op.name == "Cast"
               for n in graph._topo())
    caplog.set_level(logging.WARNING, logger="drift")
    for batch in it:
        mod.forward_backward(batch)
        mod.update()
    drift = [r for r in caplog.records if "changed to" in r.getMessage()]
    assert len(drift) == 1
    assert ex._train_program[1] is graph


def test_serving_warm_costs_are_stamped_with_the_pipeline(pkgs):
    """The pool keeps each bucket's warm time under (bucket, pipeline
    config), as mxtpu's cost rows; warm builds count as prewarm."""
    _mx, mt = pkgs
    sym, shapes = build(mt, "mlp")
    args, aux = seeded_params(sym, {"data": (1, 784)})
    params = {"arg:" + k: v for k, v in args.items()}
    p0 = mt.compile.pipeline.prewarm_build_count()
    with mt.compile.pipeline_scope(["bf16"]):
        sess = mt.serving.ServingSession(
            sym.tojson(), params, {"data": (1, 784)}, buckets=(1, 2),
            contexts=[mt.cpu()])
        try:
            out = sess.predict({"data": np.ones((1, 784), np.float32)})
            assert np.isfinite(out[0]).all()
            costs = sess.pool.bucket_costs()
        finally:
            sess.close()
    assert sorted(costs) == [1, 2]
    assert sess.pool.bucket_costs(pipeline=()) == {}
    assert mt.compile.pipeline.prewarm_build_count() >= p0 + 2
    assert sess.metrics.counter("program_builds").value >= 2
