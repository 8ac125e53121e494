"""The port's training health (``mxtpu_torch.obs.health``,
``obs.detectors``, ``FusedTrainStep.arm_health``, the metric
accumulator's riders, ``fit(health=...)``) held to mxtpu's on the CPU,
twins of tests/test_health.py run by one body through both packages:

* the detector suite: mxtpu's unit cases, and seeded stat and loss
  streams through both suites giving the same findings (kind, severity,
  message, details) at the same cadences — pure Python, held exactly;
* ``HealthAccum``'s fold, exactly;
* ``fit(health=True)`` of the mlp and the lenet from the same weights
  and batches: each class's panel stats within 1e-5 relative of mxtpu's
  (f32 in other summation orders: the f32 fits agree to ~1e-6), the
  gauges, the corpus rows; the accumulator's ``syncs`` equal with health
  on and off; under the bf16 pipeline every class's grad max-abs is a
  bfloat16 value (the gradients of the f32 masters leave the walk
  through bf16 casts), which an f32 walk does not give, and the stats
  stay within 5 % of mxtpu's bf16 fit (the two packages round the
  gradients in different places);
* the LR bomb: an lr of inf from step 3 fires one divergence at the
  cadence of that step, with one postmortem, in both packages;
* ``MXTPU_HEALTH_ACTION=rollback`` accepted, and its gate (the twin of
  mxtpu's ``test_health_divergence_rollback_gate``): an inf batch fires
  one divergence, the supervisor aborts the fit before it snapshots
  the diverged step, and the retry ends bit for bit on a clean run.
"""
import os

import numpy as np
import pytest

import mxtpu as mx
from mxtpu.obs import detectors as MD
from mxtpu.obs import health as MH


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(2)
    import mxtpu_torch
    return mxtpu_torch


def _stats(**per_class):
    base = {"grad_norm": 1.0, "weight_norm": 1.0, "update_ratio": 0.01,
            "grad_max": 1.0, "nonfinite": 0}
    return {cls: dict(base, **override)
            for cls, override in per_class.items()}


# ------------------------------------------------------ the detectors
def _unit_cases(D):
    """mxtpu's detector unit cases (tests/test_health.py:80-207), one
    body for either package's module."""
    ERROR, WARNING = "error", "warning"
    det = D.LossSpikeDetector(window=4, spike_k=8.0)
    for v in (1.0, 50.0, 1.02, 0.98, 1.01):
        assert det.observe(v, {}) is None
    det = D.LossSpikeDetector(window=4, spike_k=8.0)
    for v in (1.0, 1.02, 0.98, 1.01):
        assert det.observe(v, {}) is None
    f = det.observe(3.0, {})
    assert f.severity == WARNING and f.details["kind"] == "loss_spike"
    assert det.observe(1.0, {}) is None and det.observe(3.0, {})
    det = D.LossSpikeDetector(window=4, spike_k=8.0)
    assert all(det.observe(1.0, {}) is None for _ in range(6))
    det = D.DivergenceDetector(window=4)
    f = det.observe(None, _stats(fc1_weight={"nonfinite": 3}))
    assert f.severity == ERROR and f.details["classes"] == ["fc1_weight"]
    assert det.observe(None, _stats(fc1_weight={"nonfinite": 3})) is None
    assert det.observe(1.0, _stats(fc1_weight={})) is None
    assert det.observe(None, _stats(fc1_weight={"nonfinite": 1}))
    det = D.DivergenceDetector(window=3, diverge_k=1e3)
    assert "nonfinite" in det.observe(float("nan"),
                                      _stats(fc1_weight={})).message
    det = D.DivergenceDetector(window=3, diverge_k=1e3)
    for v in (1.0, 1.1, 0.9, 900.0):
        assert det.observe(v, _stats(fc1_weight={})) is None
    assert det.observe(5000.0, _stats(fc1_weight={})).details["kind"] == \
        "divergence"
    det = D.DeadLayerDetector(n_cadences=3, eps=1e-12)
    dead = _stats(a={"grad_norm": 0.0}, b={"grad_norm": 1.0})
    assert det.observe(1.0, dead) is None and det.observe(1.0, dead) is None
    assert det.observe(1.0, dead).details == {"kind": "dead_layer",
                                              "class": "a", "cadences": 3}
    det = D.ExplodingUpdateDetector(threshold=0.5, n_cadences=3)
    hot = _stats(fc1_bias={"update_ratio": 0.9})
    cool = _stats(fc1_bias={"update_ratio": 0.1})
    for s in (hot, hot, cool, hot, hot):
        assert det.observe(1.0, s) is None
    assert det.observe(1.0, hot).details["cadences"] == 3
    det = D.ExplodingUpdateDetector(threshold=0.5, n_cadences=3)
    r = 4.0
    for _ in range(12):
        assert det.observe(1.0, _stats(b={"update_ratio": r})) is None
        r *= 0.8
    suite = D.DetectorSuite(window=2, spike_k=4.0)
    assert suite.observe(1.0, _stats(w={})) == []
    assert suite.observe(1.0, _stats(w={})) == []
    findings = suite.observe(10.0, _stats(w={"nonfinite": 1}))
    assert findings[0].severity == ERROR
    return True


@pytest.mark.parametrize("which", ["mxtpu", "port"])
def test_detector_unit_cases_hold_in_both_packages(mt, which):
    D = MD if which == "mxtpu" else mt.obs.detectors
    assert _unit_cases(D)


def _stream(seed, cadences=60, classes=("fc1_weight", "fc1_bias",
                                        "fc2_weight")):
    """A seeded (loss, stats) stream with spikes, a dead layer, growing
    update ratios, a nonfinite burst and a nonfinite loss."""
    rng = np.random.RandomState(seed)
    out = []
    ratio = 0.3
    for c in range(cadences):
        loss = float(2.0 * np.exp(-c / 30.0) + 0.05 * rng.randn())
        if rng.rand() < 0.08:
            loss *= float(rng.choice([5.0, 50.0, 5000.0]))
        if c == 41:
            loss = float("nan")
        stats = {}
        for i, cls in enumerate(classes):
            g = float(abs(rng.randn())) + 0.1
            if cls == "fc1_bias" and 10 <= c < 20:
                g = 0.0
            if cls == "fc2_weight" and 25 <= c < 32:
                ratio *= 1.3
            stats[cls] = {"grad_norm": g, "weight_norm": 1.0 + i,
                          "update_ratio": ratio if cls == "fc2_weight"
                          else float(abs(rng.randn()) * 0.01),
                          "grad_max": g * 2, "nonfinite":
                          int(rng.rand() < 0.05) * int(rng.randint(1, 9))}
        out.append((None if c % 17 == 16 else loss, stats))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_the_same_streams_give_the_same_findings(mt, seed):
    """Seeded streams through both suites: the same findings, in the
    same order, at the same cadences (exactly: pure Python)."""
    got = []
    for D in (MD, mt.obs.detectors):
        suite = D.DetectorSuite(window=6, spike_k=6.0, dead_cadences=3)
        got.append([(c, f.details.get("kind"), f.severity, f.message,
                     f.details, f.node)
                    for c, (loss, stats) in enumerate(_stream(seed))
                    for f in suite.observe(loss, stats)])
    assert got[0] and got[1] == got[0]
    assert {k for _c, k, *_ in got[0]} >= {"divergence", "dead_layer"}


def test_health_policy_and_rollback_refused(mt, monkeypatch):
    """The policy parses as mxtpu's; ``rollback`` is accepted now that
    the elastic generations it restores exist: a health fit under it
    trains, and its session holds the policy."""
    for env, want in (("rollback", "rollback"), ("reformat-disk", "warn")):
        monkeypatch.setenv("MXTPU_HEALTH_ACTION", env)
        assert mt.obs.detectors.HealthPolicy.from_env().action == want == \
            MD.HealthPolicy.from_env().action
    monkeypatch.setenv("MXTPU_HEALTH_ACTION", "rollback")
    x, y = _data(64)
    mod = mt.mod.Module(mt.models.get_mlp(10), context=mt.cpu())
    mod.fit(mt.io.NDArrayIter(x, y, 32), num_epoch=1, health=True)
    assert mod._health_session.policy.action == "rollback"
    assert mod._health_session.cadences >= 1


def test_class_label_env_and_knobs(mt, monkeypatch):
    H = mt.obs.health
    for names in (["fc1_weight"], ["fc1_weight", "fc1_bias"], ["a", "b"]):
        assert H.class_label(names) == MH.class_label(names)
    monkeypatch.setenv("MXTPU_HEALTH", "1")
    assert H.armed_by_env() and MH.armed_by_env()
    monkeypatch.setenv("MXTPU_HEALTH_CADENCE", "4")
    assert mt.tune.resolve_int("health.cadence", floor=1) == 4


def test_health_accum_fold_exact(mt):
    import torch
    acc = mt.obs.health.HealthAccum(2)
    assert acc.pull() is None
    acc.update({"sums": torch.tensor([[1., 2., 3., 0.], [4., 5., 6., 1.]]),
                "max": torch.tensor([2., 7.])})
    acc.update({"sums": torch.tensor([[10., 0., 1., 0.], [1., 1., 1., 0.]]),
                "max": torch.tensor([9., 3.])})
    host = mt.obs.health.tree_to_host(acc.pull())
    np.testing.assert_array_equal(host["sums"], [[11., 2., 4., 0.],
                                                 [5., 6., 7., 1.]])
    np.testing.assert_array_equal(host["max"], [9., 7.])
    assert acc.finish() == 2 and acc.pull() is None


# ------------------------------------------------------ fit-level twins
def _data(n=256, seed=7, shape=(784,)):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, *shape).astype("float32"),
            rng.randint(0, 10, n).astype("float32"))


def _symbol(pk, net):
    if net == "mlp":
        return pk.models.get_mlp(10) if pk is not mx else \
            __import__("mxtpu.models.mlp", fromlist=["m"]).get_symbol(10)
    return pk.models.get_lenet(10) if pk is not mx else \
        __import__("mxtpu.models.lenet", fromlist=["m"]).get_symbol(10)


def _weights(sym, shapes, seed=3):
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    args = {n: (rng.randn(*s) * 0.05).astype("float32")
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}
    return args


def _fit(pk, net="mlp", pipe=(), health=True, lr=0.05, batch=64,
         callback=None, metric_sync=2, bomb=None):
    shape = (784,) if net == "mlp" else (1, 28, 28)
    x, y = _data(shape=shape)
    sym = _symbol(pk, net)
    w = _weights(sym, {"data": (batch,) + shape, "softmax_label": (batch,)})
    mod = pk.mod.Module(sym, context=pk.cpu())
    syncs = []

    def record(param):
        if pk is not mx:
            syncs.append(param.eval_metric._device_accum.syncs)
        if bomb is not None and param.nbatch == bomb - 1:
            param.locals["self"]._optimizer.lr = float("inf")
    kw = dict(num_epoch=1, eval_metric=["acc", "ce"], optimizer="sgd",
              optimizer_params={"learning_rate": lr, "momentum": 0.9},
              arg_params={k: pk.nd.array(v, ctx=pk.cpu())
                          for k, v in w.items()},
              metric_sync=metric_sync, health=health,
              batch_end_callback=record)
    it = pk.io.NDArrayIter(x, y, batch_size=batch,
                           label_name="softmax_label")
    if pk is mx:
        from mxtpu.compile import pipeline as P
        if pipe:
            os.environ["MXTPU_PIPELINE"] = ",".join(pipe)
        P.configure(None)
        try:
            mod.fit(it, **kw)
        finally:
            os.environ.pop("MXTPU_PIPELINE", None)
            P.configure(None)
        return mod, MH.panel(), syncs
    with pk.compile.pipeline_scope(pipe):
        mod.fit(it, **kw)
    return mod, pk.obs.health.panel(), syncs


@pytest.mark.parametrize("net", ["mlp", "lenet"])
def test_fit_health_panel_matches_mxtpus(mt, net):
    """The same fit in both packages: the same classes, each stat within
    1e-5 relative of mxtpu's, nothing nonfinite, no anomaly; the gauges
    of every (class, stat)."""
    _, mine, _ = _fit(mt, net)
    _, theirs, _ = _fit(mx, net)
    assert mine["armed"] is False and mine["cadences"] == \
        theirs["cadences"] > 0
    assert [r["class"] for r in mine["classes"]] == \
        [r["class"] for r in theirs["classes"]]
    assert mine["anomalies"] == theirs["anomalies"] == {}
    for a, b in zip(mine["classes"], theirs["classes"]):
        assert a["nonfinite"] == b["nonfinite"] == 0
        for stat in ("grad_norm", "weight_norm", "update_ratio",
                     "grad_max"):
            assert a[stat] == pytest.approx(b[stat], rel=1e-5, abs=1e-9), \
                (a["class"], stat)
    gauge = mt.telemetry.registry().gauge(
        "train_health", labels={"layer_class": mine["classes"][0]["class"],
                                "stat": "grad_norm"})
    assert gauge.value == pytest.approx(mine["classes"][0]["grad_norm"])


def test_fit_health_adds_zero_host_round_trips(mt):
    """The accumulator's host transfers are the same with health on and
    off: the rows ride the metric sums' one ``.cpu()``; the weights are
    bit for bit the same."""
    off, _, s_off = _fit(mt, health=False)
    on, _, s_on = _fit(mt, health=True)
    assert s_off[-1] == s_on[-1] > 0
    for k, v in off.get_params()[0].items():
        np.testing.assert_array_equal(v.asnumpy(),
                                      on.get_params()[0][k].asnumpy())


def test_fit_health_bf16_walk(mt):
    """Under the bf16 pipeline the gradients of the f32 masters leave the
    walk through bf16 casts: every class's grad max-abs is a bfloat16
    value, which the f32 fit's are not; the stats stay within 5 % of
    mxtpu's bf16 fit and finite."""
    import torch

    def is_bf16(v):
        return float(torch.tensor(v).bfloat16().float()) == v
    mod, b16, _ = _fit(mt, pipe=("bf16",))
    assert "bf16" in mod._fused.pipeline_report.applied
    _, f32, _ = _fit(mt)
    _, ref, _ = _fit(mx, pipe=("bf16",))
    assert all(is_bf16(r["grad_max"]) for r in b16["classes"])
    assert not all(is_bf16(r["grad_max"]) for r in f32["classes"])
    for a, b in zip(b16["classes"], ref["classes"]):
        assert a["nonfinite"] == 0
        for stat in ("grad_norm", "weight_norm", "update_ratio"):
            assert a[stat] == pytest.approx(b[stat], rel=0.05), \
                (a["class"], stat)


def test_fit_health_corpus_rows(mt, tmp_path, monkeypatch):
    """With ``MXTPU_CORPUS_DIR`` set a health fit appends one v2 health
    row a cadence (and a fit_step service row a step), which mxtpu's
    ``corpus.load`` reads."""
    from mxtpu.obs import corpus as mxc
    monkeypatch.setenv("MXTPU_CORPUS_DIR", str(tmp_path))
    mt.obs.corpus.reset()
    try:
        _, panel, _ = _fit(mt)
    finally:
        mt.obs.corpus.reset()
    rows = mxc.load(str(tmp_path))
    health = [r for r in rows if r["row"] == "health"]
    steps = [r for r in rows if r["row"] == "service"
             and r["source"] == "fit_step"]
    assert len(health) == panel["cadences"] and len(steps) == 4
    assert health[0]["v"] == 2
    assert set(health[0]["stats"]) == {r["class"]
                                       for r in panel["classes"]}


def test_lr_bomb_fires_one_divergence_at_its_step(mt, tmp_path,
                                                   monkeypatch):
    """lr jumps to inf after step 2: step 3's fresh weights are
    nonfinite; both packages fire one divergence at cadence 4 (metric
    sync 1; read from each one's corpus health rows) and the port writes
    one health postmortem."""
    from mxtpu.obs import corpus as mxc
    reg = mt.telemetry.registry()

    def count(name, **labels):
        return reg.counter(name, labels=labels).value
    div0 = count("health_anomalies", kind="divergence")
    pm0 = count("diag_postmortems", source="health")
    fired = {}
    for pk, corpus in ((mt, mt.obs.corpus), (mx, mxc)):
        d = str(tmp_path / pk.__name__)
        monkeypatch.setenv("MXTPU_CORPUS_DIR", d)
        corpus.reset()
        try:
            _mod, panel, _ = _fit(pk, metric_sync=1, bomb=3)
        finally:
            corpus.reset()
        at = [r["cadence"] for r in mxc.load(d) if r["row"] == "health"
              and "divergence" in r.get("anomalies", ())]
        fired[pk.__name__] = (panel["anomalies"], at)
    assert fired["mxtpu_torch"] == fired["mxtpu"] == \
        ({"divergence": 1}, [4])
    assert count("health_anomalies", kind="divergence") - div0 == 1
    assert count("diag_postmortems", source="health") - pm0 == 1
    pm = mt.diagnostics.last_postmortem()
    assert pm["source"] == "health" and "training_health" in pm


def test_health_without_a_fused_step_is_disarmed(mt):
    """An optimizer without a fused rule keeps the Updater: health is
    disarmed with a log line, as mxtpu's."""
    x, y = _data(64)
    mod = mt.mod.Module(mt.models.get_mlp(10), context=mt.cpu())
    mod.fit(mt.io.NDArrayIter(x, y, 32), num_epoch=1, optimizer="nadam",
            health=True)
    assert mod._fused is None and mod._health_session is None


# ------------------------------------------------ hyperparameters past f32
def _drop_nonfinite_health_gauges(reg):
    """Remove the ``train_health`` gauges a diverged fit left nonfinite
    from a process-wide registry: mxtpu's Prometheus exposition raises on
    a NaN reading, which would fail a later test's scrape in this
    process."""
    with reg._lock:
        for key, m in list(reg._series.items()):
            if m.name == "train_health" and not np.isfinite(m.value):
                del reg._series[key]


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("knob", ["learning_rate", "wd", "rescale_grad"])
def test_hyperparameter_past_f32_saturates_as_mxtpu(mt, opt, knob):
    """An lr, wd or rescale_grad of 1e39 (past the f32 range) fits with
    no error in both packages: the fused update rounds the scalar to f32
    on the host (inf), as mxtpu's f32 arithmetic does, so the weights are
    nonfinite exactly where mxtpu's are, their finite entries agree, and
    health reports mxtpu's findings."""
    x, y = _data(n=128)
    got = {}
    for pk in (mt, mx):
        sym = _symbol(pk, "mlp")
        w = _weights(sym, {"data": (64, 784), "softmax_label": (64,)})
        params = {"learning_rate": 0.05, knob: 1e39}
        if opt == "sgd":
            params["momentum"] = 0.9
        mod = pk.mod.Module(sym, context=pk.cpu())
        it = pk.io.NDArrayIter(x, y, batch_size=64,
                               label_name="softmax_label")
        mod.fit(it, num_epoch=1, optimizer=opt, optimizer_params=params,
                arg_params={k: pk.nd.array(v, ctx=pk.cpu())
                            for k, v in w.items()},
                metric_sync=1, health=True)
        panel = (MH if pk is mx else pk.obs.health).panel()
        got[pk.__name__] = (
            {k: v.asnumpy() for k, v in mod.get_params()[0].items()},
            panel["anomalies"], panel["cadences"])
        _drop_nonfinite_health_gauges(pk.telemetry.registry())
    mine, theirs = got["mxtpu_torch"], got["mxtpu"]
    assert mine[1] == theirs[1] and mine[2] == theirs[2]
    assert "divergence" in mine[1]
    for k, a in mine[0].items():
        b = theirs[0][k]
        assert np.array_equal(np.isnan(a), np.isnan(b)), k
        assert np.array_equal(np.isposinf(a), np.isposinf(b)), k
        assert np.array_equal(np.isneginf(a), np.isneginf(b)), k
        fin = np.isfinite(a)
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-5, atol=1e-6)
    assert any(not np.isfinite(a).all() for a in mine[0].values())


# ------------------------------------------- the rollback gate
def _rollback_iter(pk, poison_batch=None):
    x, y = _data()
    if poison_batch is not None:
        x = x.copy()
        x[poison_batch * 64:(poison_batch + 1) * 64] = np.inf
    return pk.io.NDArrayIter(x, y, batch_size=64,
                             label_name="softmax_label")


def _rollback_fit(mt, mod, metric, it, **kw):
    mt.random.seed(11)
    np.random.seed(11)
    mod.fit(it, num_epoch=2, eval_metric=metric, optimizer="sgd",
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
            initializer=mt.initializer.Xavier(), metric_sync=1,
            health=True, **kw)


def test_health_divergence_rollback_gate(mt, tmp_path, monkeypatch):
    """Injected divergence (an inf batch mid-epoch) -> a divergence
    Finding + ``health_anomalies`` -> the armed rollback policy fires the
    supervisor seam -> the diverged trajectory aborts BEFORE its
    snapshot -> the retry restores the last good generation and the fit
    completes with weights bit-exact against a clean run."""
    import signal
    monkeypatch.setenv("MXTPU_HEALTH_ACTION", "rollback")
    handler = signal.getsignal(signal.SIGTERM)
    reg = mt.telemetry.registry()
    clean = mt.mod.Module(mt.models.mlp.get_symbol(10), context=mt.cpu())
    m_full = mt.metric.create(["acc", "ce"])
    _rollback_fit(mt, clean, m_full, _rollback_iter(mt))
    w_full = {k: v.asnumpy() for k, v in clean.get_params()[0].items()}

    prefix = str(tmp_path / "ck")
    sup = mt.elastic.Supervisor(retries=2, backoff_s=0.0)
    cfg = mt.elastic.ElasticConfig(prefix, every_n_steps=1, sync=True,
                                   supervisor=sup)
    mod = mt.mod.Module(mt.models.mlp.get_symbol(10), context=mt.cpu())
    metric = mt.metric.create(["acc", "ce"])
    attempts = []
    div0 = reg.counter("health_anomalies",
                       labels={"kind": "divergence"}).value
    restores0 = reg.counter("elastic_restores").value

    def fit_fn(resume):
        attempts.append(resume)
        # attempt 1 feeds an all-inf batch 2; the retry's data is clean
        it = _rollback_iter(mt, 2 if len(attempts) == 1 else None)
        _rollback_fit(mt, mod, metric, it, elastic=cfg, resume=resume)

    sup.run(fit_fn)
    assert signal.getsignal(signal.SIGTERM) is handler
    assert attempts == [False, True]
    assert sup.retries_done == 1
    assert reg.counter("elastic_restores").value == restores0 + 1
    # the detector fired exactly once (hysteresis) and was surfaced
    assert reg.counter("health_anomalies",
                       labels={"kind": "divergence"}).value == div0 + 1
    pm = mt.diagnostics.last_postmortem()
    assert pm is not None and pm["source"] == "health"
    assert "divergence" in pm["reason"]
    # the diverged step was never snapshotted: the retry replayed the
    # poisoned batch with clean data and the result is bit-exact
    w_sup = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    for k in w_full:
        np.testing.assert_array_equal(w_full[k], w_sup[k], err_msg=k)
    assert dict(m_full.get_name_value())["accuracy"] == \
        dict(metric.get_name_value())["accuracy"]
