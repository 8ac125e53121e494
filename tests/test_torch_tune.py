"""The port's knob registry and TunedConfig held to mxtpu's exactly: the
same registry version and catalog, artifacts that load across the two
packages both ways (a stale one refused by both), the same resolution
order for every fit knob, and ``fit(tuned=...)`` setting mxtpu's knobs
with weights bit-identical to the same knobs given explicitly."""
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
    _mx, mt = pkgs
    for name in ("search", "CostModel", "OnlineController", "online"):
        with pytest.raises(AttributeError, match="A.10"):
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
        if os.path.basename(d) == "tune":
            continue
        for f in files:
            if f.endswith(".py"):
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
                                      "serving.max_queue": 64})
    assert mt.tune.artifact(cfg) is cfg
    msgs = [r.getMessage() for r in caplog.records]
    assert len(msgs) == 1 and "serving.max_queue" in msgs[0] \
        and "A.11" in msgs[0] and "fit." not in msgs[0]
    caplog.clear()
    mt.tune.use(cfg)
    assert ["serving.max_queue" in r.getMessage() for r in caplog.records] \
        == [True]
    mt.tune.use(None)
    caplog.clear()
    monkeypatch.setenv("MXTPU_SERVING_MAX_QUEUE", "64")
    monkeypatch.setenv("MXTPU_FIT_INFLIGHT", "3")
    mt.tune.registry._warn_unread_env()
    msgs = [r.getMessage() for r in caplog.records]
    assert len(msgs) == 1 and "MXTPU_SERVING_MAX_QUEUE" in msgs[0] \
        and "A.11" in msgs[0]
