"""The port's knob registry and TunedConfig held to mxtpu's exactly: the
same registry version and catalog, artifacts that load across the two
packages both ways (a stale one refused by both), the same resolution
order for every fit knob, and ``fit(tuned=...)`` setting mxtpu's knobs
with weights bit-identical to the same knobs given explicitly. The
search half: ``search_from_rows`` on seeded rows gives mxtpu's cost
model, rankings and winner; ``OnlineController.step`` on synthetic
signals makes mxtpu's adjustments; fit binds its in-flight window to an
active controller; ``python -m mxtpu_torch.tune search --ctx cpu``
writes an artifact a fit loads."""
import json
import logging

import numpy as np
import pytest

FIT_KNOBS = {"fit.max_in_flight": ("MXTPU_FIT_INFLIGHT", 3, "5", 7),
             "fit.metric_sync": ("MXTPU_FIT_METRIC_SYNC", 4, "8", 16),
             "fit.device_metrics": ("MXTPU_FIT_DEVICE_METRICS", False, "1",
                                    False),
             "fit.device_prefetch": ("MXTPU_FIT_DEVICE_PREFETCH", True, "0",
                                     True)}


@pytest.fixture(scope="module")
def pkgs():
    import torch
    torch.set_num_threads(1)
    import mxtpu
    import mxtpu_torch
    return mxtpu, mxtpu_torch


@pytest.fixture(autouse=True)
def _no_ambient_artifact(pkgs, monkeypatch):
    monkeypatch.delenv("MXTPU_TUNED", raising=False)
    for env, *_ in FIT_KNOBS.values():
        monkeypatch.delenv(env, raising=False)
    for p in pkgs:
        p.tune.config._reset_for_tests()
    yield
    for p in pkgs:
        p.tune.config._reset_for_tests()


def test_registry_version_and_catalog_equal_mxtpus(pkgs):
    mx, mt = pkgs
    assert mt.tune.registry_version() == mx.tune.registry_version()
    assert mt.tune.catalog_rows() == mx.tune.catalog_rows()
    assert mt.tune.catalog_table() == mx.tune.catalog_table()
    assert [k.name for k in mt.tune.knobs()] == \
        [k.name for k in mx.tune.knobs()]


@pytest.mark.parametrize("direction", ["mxtpu_to_port", "port_to_mxtpu"])
def test_tuned_config_loads_across_packages(pkgs, tmp_path, direction):
    mx, mt = pkgs
    src, dst = (mx, mt) if direction == "mxtpu_to_port" else (mt, mx)
    cfg = src.tune.TunedConfig(
        values={"fit.max_in_flight": 3, "fit.metric_sync": 4,
                "serving.max_delay_ms": 2.5, "compile.pipeline": "bf16"},
        basis={"fixture": "mlp"}, evidence=[{"candidate": 1, "ms": 2.0}])
    cfg.record("search", winner=1)
    path = str(tmp_path / "tuned.json")
    cfg.save(path)
    got = dst.tune.TunedConfig.load(path)
    assert got.values == cfg.values and got.basis == cfg.basis
    assert got.evidence == cfg.evidence
    assert got.provenance == cfg.provenance
    assert not got.stale
    assert got.to_dict() == cfg.to_dict()


def test_stale_artifact_is_refused_by_both(pkgs, tmp_path):
    mx, mt = pkgs
    cfg = mt.tune.TunedConfig(values={"fit.max_in_flight": 3})
    raw = cfg.to_dict()
    raw["registry_version"] = "000000000000"
    path = tmp_path / "stale.json"
    path.write_text(json.dumps(raw))
    for pkg in (mx, mt):
        with pytest.raises(pkg.MXNetError, match="STALE"):
            pkg.tune.TunedConfig.load(str(path))
        assert pkg.tune.TunedConfig.load(str(path), strict=False) is None
        with pytest.raises(pkg.MXNetError, match="STALE"):
            pkg.tune.artifact(str(path))
    raw["registry_version"] = mt.tune.registry_version()
    raw["values"] = {"fit.no_such_knob": 1}
    path.write_text(json.dumps(raw))
    for pkg in (mx, mt):
        with pytest.raises(pkg.MXNetError, match="unknown knob"):
            pkg.tune.TunedConfig.load(str(path))


@pytest.mark.parametrize("knob", sorted(FIT_KNOBS))
def test_resolution_order_matches_mxtpu(pkgs, monkeypatch, knob):
    """default < artifact < env < explicit, for each fit knob."""
    mx, mt = pkgs
    env, art_value, env_value, explicit = FIT_KNOBS[knob]
    seen = {}
    for pkg in (mx, mt):
        monkeypatch.delenv(env, raising=False)
        art = pkg.tune.TunedConfig(values={knob: art_value})
        steps = [pkg.tune.resolve(knob, artifact=False),
                 pkg.tune.resolve(knob, artifact=art)]
        monkeypatch.setenv(env, env_value)
        steps.append(pkg.tune.resolve(knob, artifact=art))
        steps.append(pkg.tune.resolve(knob, explicit=explicit,
                                      artifact=art))
        monkeypatch.delenv(env)
        pkg.tune.use(art)   # the process-active artifact
        steps.append(pkg.tune.resolve(knob))
        pkg.tune.use(None)
        steps.append(pkg.tune.resolve(knob))
        seen[pkg.__name__] = steps
    assert seen["mxtpu_torch"] == seen["mxtpu"]
    steps = seen["mxtpu_torch"]
    knob_def = mt.tune.get_knob(knob)
    assert steps[0] == knob_def.coerce(knob_def.default) \
        if knob_def.default is not None else steps[0] is None
    assert steps[1] == knob_def.coerce(art_value)
    assert steps[2] == knob_def.coerce(env_value)
    assert steps[3] == knob_def.coerce(explicit)
    assert steps[4] == steps[1] and steps[5] == steps[0]


def _mlp(pkg):
    sym = pkg.models.mlp.get_symbol(10)
    rng = np.random.RandomState(3)
    x = rng.rand(64, 784).astype(np.float32)
    y = rng.randint(0, 10, 64).astype(np.float32)
    shapes = dict(zip(sym.list_arguments(),
                      sym.infer_shape(data=(16, 784))[0]))
    w0 = {k: rng.uniform(-0.05, 0.05, s).astype(np.float32)
          for k, s in shapes.items() if k not in ("data", "softmax_label")}
    return sym, x, y, w0


def _fit(pkg, **kw):
    sym, x, y, w0 = _mlp(pkg)
    mod = pkg.mod.Module(sym, context=pkg.cpu(),
                         logger=logging.getLogger("quiet"))
    mod.fit(pkg.io.NDArrayIter(x, y, batch_size=16), num_epoch=2,
            optimizer="sgd", optimizer_params={"learning_rate": 0.1},
            arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                        for k, v in w0.items()}, **kw)
    return mod._fit_knobs, {k: v.asnumpy()
                            for k, v in mod.get_params()[0].items()}


def test_fit_tuned_sets_mxtpus_knobs_and_the_explicit_weights(pkgs,
                                                              tmp_path):
    mx, mt = pkgs
    values = {"fit.max_in_flight": 3, "fit.metric_sync": 4,
              "fit.device_metrics": True}
    path = str(tmp_path / "fit.json")
    mx.tune.TunedConfig(values=values).save(path)   # searched by mxtpu
    ref_knobs, _ = _fit(mx, tuned=path)
    knobs, w = _fit(mt, tuned=path)
    assert knobs == ref_knobs
    assert knobs == {"fit.max_in_flight": 3, "fit.metric_sync": 4,
                     "fit.device_metrics": True,
                     "fit.device_prefetch": False}
    explicit_knobs, w_explicit = _fit(mt, max_in_flight=3, metric_sync=4,
                                      device_metrics=True)
    assert explicit_knobs == knobs
    for k in w:
        np.testing.assert_array_equal(w[k], w_explicit[k])
    # the artifact as an object, and as the process-active one
    knobs_obj, w_obj = _fit(mt, tuned=mt.tune.TunedConfig.load(path))
    mt.tune.use(path)
    try:
        knobs_active, _ = _fit(mt)
        knobs_ignored, _ = _fit(mt, tuned=False)
    finally:
        mt.tune.use(None)
    assert knobs_obj == knobs_active == knobs
    assert knobs_ignored["fit.max_in_flight"] == 2
    for k in w:
        np.testing.assert_array_equal(w[k], w_obj[k])


def test_tuned_cadence_reconciles_with_speedometer(pkgs):
    mx, mt = pkgs
    art_m = mx.tune.TunedConfig(values={"fit.metric_sync": 4})
    art_t = mt.tune.TunedConfig(values={"fit.metric_sync": 4})
    ref, _ = _fit(mx, tuned=art_m, batch_end_callback=mx.callback.Speedometer(
        16, frequent=6, log=False))
    got, _ = _fit(mt, tuned=art_t, batch_end_callback=mt.callback.Speedometer(
        16, frequent=6, log=False))
    assert got["fit.metric_sync"] == ref["fit.metric_sync"] == 2


def test_default_fit_without_artifact_keeps_the_earlier_defaults(pkgs):
    _mx, mt = pkgs
    knobs, w = _fit(mt)
    assert knobs == {"fit.max_in_flight": 2, "fit.metric_sync": 0,
                     "fit.device_metrics": True,
                     "fit.device_prefetch": False}
    knobs_old, w_old = _fit(mt, max_in_flight=2, device_metrics=True)
    assert knobs_old == knobs
    for k in w:
        np.testing.assert_array_equal(w[k], w_old[k])


def test_search_half_names_the_slice_it_waits_for(pkgs):
    """The search half is ported (A.10); mxtpu's sweep re-runs bench.py
    under XLA_FLAGS and waits for the port's own benchmark, naming it."""
    _mx, mt = pkgs
    for name in ("search", "CostModel", "OnlineController", "online"):
        assert getattr(mt.tune, name) is not None
    for name in ("sweep", "run_flag_sweep"):
        with pytest.raises(AttributeError, match="benchmark"):
            getattr(mt.tune, name)


def test_ported_knobs_are_the_ones_the_port_reads(pkgs):
    """``PORTED`` names exactly the knobs some module of the port
    resolves; every other declared knob names the slice that reads it."""
    import os
    import re
    _mx, mt = pkgs
    root = os.path.dirname(mt.__file__)
    read = set()
    for d, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith(".py") and not (
                    os.path.basename(d) == "tune" and f == "registry.py"):
                with open(os.path.join(d, f)) as fh:
                    read |= set(re.findall(
                        r'resolve(?:_int)?\(\s*"([a-z_.]+)"', fh.read()))
    reg = mt.tune.registry
    assert read == set(reg.PORTED)
    for k in mt.tune.knobs():
        later = reg.unread_by(k.name)
        assert (later is None) == (k.name in reg.PORTED)
        assert later != "no slice yet", k.name


def test_unread_knobs_in_an_artifact_or_env_are_named(pkgs, monkeypatch,
                                                       caplog):
    """An artifact (mxtpu's, say) that sets a knob the port does not read
    is accepted with a warning naming the knob and its slice; the fit
    knobs pass without one. So does an env override of such a knob."""
    _mx, mt = pkgs
    caplog.set_level(logging.WARNING, logger="mxtpu_torch.tune")
    cfg = mt.tune.TunedConfig(values={"fit.max_in_flight": 3,
                                      "serving.max_queue": 64,
                                      "elastic.keep": 3})
    assert mt.tune.artifact(cfg) is cfg
    msgs = [r.getMessage() for r in caplog.records]
    assert len(msgs) == 1 and "elastic.keep" in msgs[0] \
        and "A.12" in msgs[0] and "fit." not in msgs[0] \
        and "serving." not in msgs[0]
    caplog.clear()
    mt.tune.use(cfg)
    assert ["elastic.keep" in r.getMessage() for r in caplog.records] \
        == [True]
    mt.tune.use(None)
    caplog.clear()
    monkeypatch.setenv("MXTPU_ELASTIC_KEEP", "3")
    monkeypatch.setenv("MXTPU_SERVING_MAX_QUEUE", "64")
    monkeypatch.setenv("MXTPU_FIT_INFLIGHT", "3")
    mt.tune.registry._warn_unread_env()
    msgs = [r.getMessage() for r in caplog.records]
    assert len(msgs) == 1 and "MXTPU_ELASTIC_KEEP" in msgs[0] \
        and "A.12" in msgs[0]


# ------------------------------------------------------ the search half
def _rows(seed):
    """Seeded measured rows: per-bucket warm ms, a fit basis, program
    rows (the cost model's inputs)."""
    rng = np.random.RandomState(seed)
    buckets = {b: {"exec_ms": float(0.5 + 0.02 * b * rng.rand() + rng.rand())}
               for b in (1, 8, 32, 128)[:2 + seed % 3]}
    basis = {"step_exec_ms": float(5 + 20 * rng.rand()),
             "dispatch_ms": float(0.5 + 3 * rng.rand()),
             "metric_sync_ms": float(0.1 + rng.rand()),
             "assemble_ms": float(2 * rng.rand())}
    if seed % 2:
        basis.pop("metric_sync_ms")
    programs = [{"kind": k, "flops": float(rng.rand() * 1e9),
                 "bytes_accessed": float(rng.rand() * 1e8)}
                for k in ("fwd_eval", "fused_step")]
    return buckets, basis, programs


@pytest.mark.parametrize("seed", range(6))
def test_search_from_rows_ranks_as_mxtpu(pkgs, seed):
    """The same rows give mxtpu's cost model, rankings and winner."""
    mx, mt = pkgs
    buckets, basis, programs = _rows(seed)
    out = []
    for p in (mx, mt):
        winner, ranked, model = p.tune.search_from_rows(
            bucket_costs=buckets, fit_basis=dict(basis),
            program_rows=programs, buckets=(1, 8, 32, 128), top_k=4)
        out.append((winner, ranked, model.to_dict(),
                    model.predict_sync_points(2, 4, 50)))
    assert out[1] == out[0]
    line = [p.tune.cost.ServiceLine.fit(buckets, programs[0]).to_dict()
            for p in (mx, mt)]
    assert line[1] == line[0]


def _signals(seed, n=30):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        s = {"fit_pacing_waits": int(rng.randint(0, 3)),
             "fit_sync_wait_mean_ms": float(rng.rand() * 4),
             "fit_dispatch_mean_ms": float(rng.rand() * 4),
             "idle_gaps": int(rng.randint(0, 2)),
             "queue_depth": int(rng.randint(0, 3)),
             "sheds": int(rng.randint(0, 2)),
             "batch_service_p99_ms": float(rng.rand() * 10)}
        if rng.rand() < 0.2:
            s["mem_headroom_frac"] = float(rng.rand() * 0.3)
        out.append(s)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_online_controller_makes_mxtpus_adjustments(pkgs, seed):
    """Synthetic signals through both controllers, bound to the same
    knobs: the same moves, every value inside its certified range."""
    mx, mt = pkgs
    moves = []
    for p in (mx, mt):
        ctl = p.tune.OnlineController()
        holders = {}
        for name, v in (("fit.max_in_flight", 2),
                        ("serving.max_in_flight", 2),
                        ("serving.refill_watermark", 8),
                        ("serving.queue_wait_budget_ms", 200.0)):
            holders[name] = {"v": v}
            ctl.bind_holder(name, holders[name])
        seq = []
        for sig in _signals(seed):
            for a in ctl.step(signals=sig):
                seq.append((a["knob"], a["from"], a["to"], a["reason"]))
            for name, h in holders.items():
                lo, hi = p.tune.get_knob(name).safe_range
                assert lo <= h["v"] <= hi
        moves.append(seq)
    assert moves[0] and moves[1] == moves[0]


def test_fit_binds_its_window_to_the_active_controller(pkgs):
    """An active controller binds fit.max_in_flight's live holder during
    the fit and releases it after; a move lands in
    tune_adjustments{knob} and the artifact's provenance."""
    _mx, mt = pkgs
    cfg = mt.tune.TunedConfig(values={"fit.max_in_flight": 4})
    ctl = mt.tune.OnlineController(artifact=cfg).activate()
    reg = mt.telemetry.registry()
    n0 = reg.counter("tune_adjustments",
                     labels={"knob": "fit.max_in_flight"}).value
    seen = []

    def cb(param):
        seen.extend(ctl.step(signals={"mem_headroom_frac": 0.0}))
    try:
        _fit(mt, tuned=cfg, batch_end_callback=cb)
    finally:
        ctl.deactivate()
    assert [(a["from"], a["to"]) for a in seen][:2] == [(4, 3), (3, 2)]
    assert "fit.max_in_flight" not in ctl._bound
    assert reg.counter("tune_adjustments", labels={
        "knob": "fit.max_in_flight"}).value - n0 == len(seen)
    assert len([e for e in cfg.provenance
                if e["event"] == "online-adjust"]) == len(seen)


def test_search_cli_writes_an_artifact_fit_loads(pkgs, tmp_path):
    """``python -m mxtpu_torch.tune search --ctx cpu`` probes the fixtures
    on the host and writes a TunedConfig (mxtpu's schema and registry
    version) that fit(tuned=...) loads and applies; the probes read
    fit.batch_size."""
    import os
    import subprocess
    import sys
    mx, mt = pkgs
    out = str(tmp_path / "t.json")
    env = dict(os.environ, MXTPU_FIT_BATCH_SIZE="16",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(mt.__file__))))
    proc = subprocess.run([sys.executable, "-m", "mxtpu_torch.tune",
                           "search", "--ctx", "cpu", "--top-k", "1",
                           "--out", out], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    cfg = mt.tune.TunedConfig.load(out, strict=True)
    assert mx.tune.TunedConfig.load(out, strict=True).values == cfg.values
    probes = [e for e in cfg.evidence if e.get("stage") == "probe"]
    assert len(probes) == 2 and cfg.provenance[-1]["event"] == \
        "offline-search"
    seed_fit = cfg.evidence[0]
    assert seed_fit["group"] == "fit" and seed_fit["steps"] == 16
    knobs, _w = _fit(mt, tuned=out)
    assert knobs["fit.max_in_flight"] == cfg.values["fit.max_in_flight"]
    assert knobs["fit.device_prefetch"] == \
        cfg.values["fit.device_prefetch"]
