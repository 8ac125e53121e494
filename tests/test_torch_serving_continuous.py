"""Continuous serving of the port (``mxtpu_torch.serving``) held to
mxtpu's on the CPU: twins of tests/test_serving_continuous.py, one body
through both packages where the gate is a pure function, the port's
session against mxtpu's Predictor on the same seeded weights where it
serves.

* ``ContinuousBatcher``: the refill watermark releases a partial batch
  to a hungry slot without the deadline, a full bucket flushes "full",
  a sated consumer waits the deadline, and the default watermark;
* admission: the signal matrix gives mxtpu's ``Decision`` row by row;
  ``derive_knobs`` and ``mix_service_model`` give mxtpu's on the same
  cost rows; the online tuner's ``sheds`` signal sums the labeled
  ``requests_shed{reason=}`` series as mxtpu's does (C.23);
* the session: K=3 in flight under 24 clients, every answer bit for bit
  the port's Predictor at one of the buckets and within ``MXTPU_ATOL``
  of mxtpu's there (XLA's f32 sums in other orders); the HTTP 429/504/503
  taxonomy; a hot-swap under load with zero failed requests; prewarm
  and a rollback with zero program builds; a reused tag never serving
  old weights; ``/v1/version``, ``/healthz`` and the three serving
  panels of ``/debug/state``; a kill at ``serving.replica.collect``
  quarantines and respawns the replica.

Every wait is bounded; the port runs on ``cpu()``.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import mxtpu as mx
from mxtpu.models.serving_fixtures import get_fixture as mx_fixture
from mxtpu.predict import Predictor as MxPredictor
from mxtpu.serving import admission as mx_adm
from mxtpu.serving import batcher as mx_batcher


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(2)
    import mxtpu_torch
    return mxtpu_torch


@pytest.fixture(scope="module")
def mlp(mt):
    """mxtpu's mlp fixture and its weights as numpy (one seed for both
    packages)."""
    sj, params, shapes = mx_fixture("mlp")
    host = {k: np.asarray(v.asnumpy()) for k, v in params.items()}
    return sj, host, shapes


def _rand(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


#: the port's f32 FullyConnected/softmax against XLA's on the CPU sum in
#: other orders: an answer is held to mxtpu's Predictor within this
#: (absolute, on probabilities), and bit for bit to the port's own
#: Predictor at one of the buckets
MXTPU_ATOL = 1e-6


class _Reference:
    """The port's and mxtpu's Predictors of one weight set, one per
    bucket: ``matches`` holds an answer bit for bit to the port's
    Predictor at one bucket and within ``MXTPU_ATOL`` to mxtpu's there."""

    def __init__(self, sj, params, buckets, mt):
        self.mx = {b: MxPredictor(sj, {k: mx.nd.array(v)
                                       for k, v in params.items()},
                                  input_shapes={"data": (b, 784)})
                   for b in buckets}
        self.port = {b: mt.Predictor(sj, dict(params), ctx=mt.cpu(),
                                     input_shapes={"data": (b, 784)})
                     for b in buckets}

    @staticmethod
    def _rows(p, x, b, get):
        p.forward(data=mx_batcher.pad_rows(x, b))
        return get(p)[:1]

    def matches(self, x, out):
        for b in self.port:
            mine = self._rows(self.port[b], x, b,
                              lambda p: p.get_outputs()[0])
            if np.array_equal(out, mine):
                theirs = self._rows(self.mx[b], x, b,
                                    lambda p: p.get_output(0))
                return bool(np.abs(out - theirs).max() <= MXTPU_ATOL)
        return False


# ---------------------------------------------------------- the batcher
@pytest.mark.parametrize("which", ["mxtpu", "port"])
def test_continuous_batcher_watermark_refill(mt, which):
    """A hungry slot takes a partial batch once pending rows reach the
    watermark (no deadline wait, reason "watermark"); below it a poll
    returns nothing; a full largest bucket flushes "full"."""
    B = mx_batcher if which == "mxtpu" else mt.serving.batcher
    b = B.ContinuousBatcher(["data"], buckets=(4, 8), max_delay_ms=10_000,
                            refill_watermark=2)
    assert b.refill_watermark == 2
    b.submit({"data": _rand((1, 3), 0)})
    b.submit({"data": _rand((1, 3), 1)})
    t0 = time.monotonic()
    batch = b.next_fill(timeout=5, hungry=True)
    assert time.monotonic() - t0 < 5
    assert batch is not None and batch.n_valid == 2
    assert b.last_flush_reason == batch.flush_reason == "watermark"
    b.submit({"data": _rand((1, 3), 2)})
    assert b.next_fill(timeout=0, hungry=True) is None
    for i in range(8):
        b.submit({"data": _rand((1, 3), 3 + i)})
    batch = b.next_fill(timeout=5, hungry=True)
    assert batch is not None and b.last_flush_reason == "full"


@pytest.mark.parametrize("which", ["mxtpu", "port"])
def test_continuous_batcher_not_hungry_behaves_like_burst(mt, which):
    B = mx_batcher if which == "mxtpu" else mt.serving.batcher
    b = B.ContinuousBatcher(["data"], buckets=(8,), max_delay_ms=40,
                            refill_watermark=1)
    b.submit({"data": _rand((1, 3), 0)})
    assert b.next_fill(timeout=0, hungry=False) is None
    t0 = time.monotonic()
    batch = b.next_fill(timeout=5, hungry=False)
    assert batch is not None and batch.n_valid == 1
    assert time.monotonic() - t0 >= 0.030
    assert b.last_flush_reason == "deadline"
    assert b.pending_rows == 0


def test_continuous_batcher_default_watermark(mt):
    for B in (mx_batcher, mt.serving.batcher):
        assert B.ContinuousBatcher(["data"], buckets=(1, 8, 32, 128)) \
            .refill_watermark == 32
        assert B.ContinuousBatcher(["data"], buckets=(4,)) \
            .refill_watermark == 1


# ---------------------------------------------------------- admission
_ROWS = [{}, {"est_queue_wait_ms": 150.0}, {"est_queue_wait_ms": 60.0},
         {"watchdog_age_s": 11.0}, {"mem_headroom_frac": 0.01},
         {"mem_headroom_frac": None}, {"mem_headroom_frac": 0.5},
         {"queue_depth": 240, "queue_limit": 256},
         {"queue_depth": 200, "queue_limit": 256},
         {"est_queue_wait_ms": 150.0, "watchdog_age_s": 11.0},
         {"queue_depth": 256, "queue_limit": 256,
          "est_queue_wait_ms": 1e9}]


def _signals(mod, **kw):
    base = dict(queue_depth=0, queue_limit=256, pending_rows=0,
                inflight_depth=0, inflight_limit=2, replicas=1,
                est_batch_ms=2.0, est_queue_wait_ms=0.0,
                watchdog_age_s=0.0, mem_headroom_frac=None)
    base.update(kw)
    return mod.AdmissionSignals(**base)


@pytest.mark.parametrize("row", range(len(_ROWS)))
def test_admission_signal_matrix_is_mxtpus(mt, row):
    """Each signal row gets mxtpu's Decision: admit, state and reason."""
    got = []
    for mod in (mx_adm, mt.serving.admission):
        pol = mod.SignalAdmissionPolicy(
            queue_wait_budget_ms=100.0, watchdog_shed_s=10.0,
            min_mem_headroom=0.05, queue_frac_shed=0.9, degrade_frac=0.5)
        d = pol.decide(_signals(mod, **_ROWS[row]))
        got.append((d.admit, d.state, d.reason))
    assert got[0] == got[1]


def test_decode_admission_policy_units_are_mxtpus(mt):
    rows = [dict(est_join_wait_ms=500.0, est_tokens_ahead=250,
                 slot_capacity=4, slots_free=0, queue_depth=2,
                 queue_limit=256),
            dict(est_join_wait_ms=12.0, est_tokens_ahead=6,
                 slot_capacity=4, slots_free=0, queue_depth=2,
                 queue_limit=256),
            dict(est_join_wait_ms=500.0, est_tokens_ahead=250,
                 slot_capacity=4, slots_free=0, queue_depth=1,
                 queue_limit=256),
            dict(est_join_wait_ms=0.0, slot_capacity=4, slots_free=2,
                 queue_depth=0, queue_limit=256),
            dict(watchdog_age_s=99.0, slot_capacity=4, slots_free=2),
            dict(est_join_wait_ms=70.0, slot_capacity=4, slots_free=1,
                 queue_depth=0, queue_limit=256)]
    for kw in rows:
        got = []
        for mod in (mx_adm, mt.serving.admission):
            pol = mod.DecodeAdmissionPolicy(join_wait_budget_ms=100.0,
                                            join_watermark=2)
            d = pol.decide(mod.AdmissionSignals(**kw))
            got.append((d.admit, d.state, d.reason))
        assert got[0] == got[1], kw


_COSTS = [{1: {"exec_ms": 1.0}, 8: {"exec_ms": 2.0}, 32: {"exec_ms": 4.0}},
          {1: {"exec_ms": 1.0}, 8: {"exec_ms": 8.0}},
          {},
          {1: {"exec_ms": 0.3}, 8: {"exec_ms": 0.9}, 32: {"exec_ms": 2.1},
           128: {"exec_ms": 7.7}}]


@pytest.mark.parametrize("case", range(len(_COSTS)))
def test_derive_knobs_and_mix_model_are_mxtpus(mt, case):
    costs = _COSTS[case]
    buckets = tuple(sorted(costs)) or (1, 8)
    live = {b: (n, m) for b, n, m in ((1, 5, 0.7), (8, 9, 1.9))}
    for args in ((costs, buckets),):
        assert mt.serving.derive_knobs(*args) == mx_adm.derive_knobs(*args)
    for lr in ({}, live, {1: (3, 0.5)}):
        assert mt.serving.mix_service_model(lr, costs, buckets) == \
            mx_adm.mix_service_model(lr, costs, buckets)


def test_online_tuner_sums_labeled_sheds_as_mxtpu(mt):
    """C.23: the online controller's ``sheds`` signal is the sum of every
    ``requests_shed{reason=}`` series, as mxtpu's, and the read creates
    no unlabeled series."""
    import mxtpu.serving.metrics as mxm
    from mxtpu.tune.online import OnlineController as MxOnline

    class Sess:
        def __init__(self, reg):
            self.metrics = reg
            self.batcher = type("B", (), {"depth": 0})()

    got = []
    for reg, ctl_cls in ((mxm.MetricsRegistry(), MxOnline),
                         (mt.serving.MetricsRegistry(),
                          mt.tune.OnlineController)):
        reg.counter("requests_shed", labels={"reason": "queue"}).inc(3)
        reg.counter("requests_shed", labels={"reason": "latency"}).inc(2)
        ctl = ctl_cls()
        ctl._session = Sess(reg)
        first = ctl.sample()["sheds"]
        reg.counter("requests_shed", labels={"reason": "queue"}).inc(4)
        second = ctl.sample()["sheds"]
        names = [(m.name, tuple(sorted(m.labels.items())))
                 for m in reg.series() if m.name == "requests_shed"]
        got.append((first, second, sorted(names)))
    assert got[0] == got[1] == (5, 4, [
        ("requests_shed", (("reason", "latency"),)),
        ("requests_shed", (("reason", "queue"),))])


def test_online_tuner_binds_the_continuous_sessions_knobs(mt, mlp):
    sj, params, shapes = mlp
    with mt.serving.ServingSession(sj, params, shapes, buckets=(1, 4),
                                   contexts=[mt.cpu()],
                                   version_tag="bind") as sess:
        ctl = mt.tune.OnlineController().bind_session(sess)
        assert set(ctl._bound) == {"serving.max_in_flight",
                                   "serving.refill_watermark",
                                   "serving.queue_wait_budget_ms"}
        ctl._bound["serving.max_in_flight"].set(3)
        assert sess.max_in_flight == 3


# ------------------------------------------------------------ sessions
def test_continuous_session_byte_identical_inflight(mt, mlp):
    """24 concurrent clients through K=3 in flight: every answer bit for
    bit the port's Predictor at one of the buckets on the same weights,
    and within MXTPU_ATOL of mxtpu's Predictor there."""
    sj, params, shapes = mlp
    buckets = (1, 8)
    ref = _Reference(sj, params, buckets, mt)
    with mt.serving.ServingSession(sj, params, shapes, buckets=buckets,
                                   max_delay_ms=3, contexts=[mt.cpu()],
                                   max_in_flight=3,
                                   version_tag="inflight") as sess:
        assert sess.mode == "continuous"
        results, errors = {}, []
        lock = threading.Lock()

        def client(i):
            x = _rand((1, 784), i)
            try:
                out = sess.predict({"data": x}, timeout=60)[0]
                with lock:
                    results[i] = (x, out)
            except Exception as exc:
                errors.append((i, exc))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors[:3]
        assert len(results) == 24
        for i, (x, out) in results.items():
            assert ref.matches(x, out), i
        for i in range(3):
            sess.predict({"data": _rand((1, 784), 100 + i)}, timeout=30)
        stats = sess.stats()
        assert stats["requests_completed"] == 27
        assert stats["batch_exec_ms"]["count"] >= 1
        assert stats["refill_latency_ms"]["count"] >= 1
        assert stats["admission_state"] == mt.serving.ACCEPTING
    assert sum(sess._inflight_n) == 0


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_overload_taxonomy_http_429_504_503(mt, mlp):
    """429 = shed (the body names the signal), 504 = the request
    out-waited its deadline in the queue, 503 = draining; a full queue
    is a 429 too."""
    sj, params, shapes = mlp
    sess = mt.serving.ServingSession(
        sj, params, shapes, buckets=(1, 4), max_delay_ms=1, max_queue=4,
        contexts=[mt.cpu()], version_tag="taxonomy",
        admission=mt.serving.SignalAdmissionPolicy(
            queue_wait_budget_ms=1000.0, queue_frac_shed=2.0))
    server = mt.serving.ServingHTTPServer(sess, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = server.endpoint + "/v1/predict"
    x = _rand((1, 784), 0).tolist()
    gate = threading.Event()
    try:
        assert _post(url, {"inputs": {"data": x}})[0] == 200
        rep = sess.pool.replicas[0]
        orig = rep.dispatch
        rep.dispatch = lambda inputs: (gate.wait(15), orig(inputs))[1]
        stuck = sess.predict_async({"data": _rand((1, 784), 1)})
        deadline = time.time() + 5
        while sess.batcher.depth > 0 and time.time() < deadline:
            time.sleep(0.005)
        filler = sess.predict_async({"data": _rand((1, 784), 2)})
        sess._admission.queue_wait_budget_ms = 1e-6
        code, body = _post(url, {"inputs": {"data": x}})
        assert code == 429
        assert body.get("shed") is True and "latency" in body["error"]
        assert sess.stats()["shed_rate"] > 0
        sess._admission.queue_wait_budget_ms = 1e9
        assert _post(url, {"inputs": {"data": x},
                           "timeout_sec": 0.1})[0] == 504
        held = []
        while sess.batcher.depth < sess.batcher.max_queue:
            held.append(sess.predict_async({"data": _rand((1, 784), 3)}))
        code, body = _post(url, {"inputs": {"data": x}})
        assert code == 429 and "full" in body["error"]
        gate.set()
        for f in [stuck, filler] + held:
            f.wait(30)
    finally:
        gate.set()
        sess.close()
    assert _post(url, {"inputs": {"data": x}})[0] == 503
    server.shutdown()


def test_hot_swap_zero_failed_requests_under_load(mt, mlp):
    """A version flip under 8 client threads fails no request: every
    answer is one version's (the port's Predictor on that version's
    weights bit for bit, mxtpu's within MXTPU_ATOL), and after the flip
    only the new one's."""
    sj, params_a, shapes = mlp
    params_b = {k: v + np.float32(0.25) for k, v in params_a.items()}
    buckets = (1, 8)
    refs = {"a": _Reference(sj, params_a, buckets, mt),
            "b": _Reference(sj, params_b, buckets, mt)}
    sess = mt.serving.ServingSession(sj, params_a, shapes, buckets=buckets,
                                     max_delay_ms=2, contexts=[mt.cpu()],
                                     version_tag="swap-a")
    results, errors = [], []
    lock = threading.Lock()

    def client(i):
        for n in range(12):
            x = _rand((1, 784), 1000 * i + n)
            try:
                out = sess.predict({"data": x}, timeout=60)[0]
                with lock:
                    results.append((x, out))
            except Exception as exc:
                errors.append(exc)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.15)
        info = sess.swap_model(sj, params_b, version_tag="swap-b")
        assert info["generation"] == 1 and info["version"] == "swap-b"
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors[:3]
        assert len(results) == 96
        for x, out in results:
            assert refs["a"].matches(x, out) or refs["b"].matches(x, out)
        x = _rand((1, 784), 424242)
        out = sess.predict({"data": x}, timeout=30)[0]
        assert refs["b"].matches(x, out) and not refs["a"].matches(x, out)
        assert sess.stats()["model_swaps"] == 1
    finally:
        sess.close()


def test_warm_cache_prewarm_and_rollback_zero_builds(mt, mlp):
    """prewarm makes the session's start build nothing; a swap back to a
    warm tag adopts it (zero builds, counted at the build seam) and
    serves the first weights again."""
    sj, params_a, shapes = mlp
    params_b = {k: v + np.float32(0.5) for k, v in params_a.items()}
    buckets = (1, 4)
    builds = mt.compile.pipeline.program_build_count
    built = mt.serving.prewarm(sj, params_a, shapes, buckets=buckets,
                               contexts=[mt.cpu()], version_tag="roll-a")
    assert built == len(buckets)
    b0 = builds()
    sess = mt.serving.ServingSession(sj, params_a, shapes, buckets=buckets,
                                     max_delay_ms=1, contexts=[mt.cpu()],
                                     version_tag="roll-a")
    try:
        assert builds() == b0
        assert sess.pool.adopted
        assert sorted(sess.pool.bucket_costs()) == list(buckets)
        sess.swap_model(sj, params_b, version_tag="roll-b")
        b1 = builds()
        assert b1 > b0
        sess.swap_model(sj, params_a, version_tag="roll-a")
        assert builds() == b1
        assert sess.stats()["warm_cache_adoptions"] >= 2
        x = _rand((1, 784), 7)
        out = sess.predict({"data": x}, timeout=30)[0]
        assert _Reference(sj, params_a, (1,), mt).matches(x, out)
    finally:
        sess.close()
    # close gives the warm cache back: no version of this session stays
    assert not [e for e in mt.serving.warm_cache().manifest()
                if e["version"] in ("roll-a", "roll-b")]


def test_stale_tag_never_serves_old_weights(mt, mlp):
    sj, params_a, shapes = mlp
    params_b = {k: v + np.float32(1.0) for k, v in params_a.items()}
    pa = {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in params_a.items()}
    s1 = mt.serving.ServingSession(sj, pa, shapes, buckets=(1,),
                                   max_delay_ms=1, contexts=[mt.cpu()],
                                   version_tag="stale-t")
    # a second weight set under the same tag while the first is cached
    s2 = mt.serving.ServingSession(sj, params_b, shapes, buckets=(1,),
                                   max_delay_ms=1, contexts=[mt.cpu()],
                                   version_tag="stale-t")
    try:
        assert not s2.pool.adopted
        x = _rand((1, 784), 3)
        assert _Reference(sj, params_b, (1,), mt).matches(
            x, s2.predict({"data": x}, timeout=30)[0])
        assert _Reference(sj, params_a, (1,), mt).matches(
            x, s1.predict({"data": x}, timeout=30)[0])
    finally:
        s1.close()
        s2.close()


def test_version_endpoint_health_and_debug_panels(mt, mlp):
    sj, params, shapes = mlp
    sess = mt.serving.ServingSession(sj, params, shapes, buckets=(1, 4),
                                     max_delay_ms=1, contexts=[mt.cpu()],
                                     version_tag="panel-v0")
    server = mt.serving.ServingHTTPServer(sess, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        base = server.endpoint
        sess.predict({"data": _rand((1, 784), 0)}, timeout=30)
        with urllib.request.urlopen(base + "/v1/version", timeout=10) as r:
            v = json.loads(r.read())
        assert v["version"] == "panel-v0" and v["generation"] == 0
        assert v["mode"] == "continuous" and len(v["symbol_hash"]) == 16
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            h = json.loads(r.read())
        assert h["mode"] == "continuous" and h["admission"] == "accepting"
        assert h["healthy_replicas"] == h["replicas"] == 1
        with urllib.request.urlopen(base + "/debug/state", timeout=10) as r:
            state = json.loads(r.read())
        adm = state["serving_admission"]
        assert adm["state"] == "accepting"
        assert adm["policy"] == "SignalAdmissionPolicy"
        assert "est_queue_wait_ms" in adm["signals"]
        assert state["serving_version"]["version"] == "panel-v0"
        assert any(e["version"] == "panel-v0"
                   for e in state["serving_warm_cache"])
        sess._admission.queue_wait_budget_ms = -1.0
        with pytest.raises(mt.serving.AdmissionShed):
            sess.predict_async({"data": _rand((1, 784), 1)})
        assert sess.stats()["requests_shed{reason=latency}"] == 1
    finally:
        server.shutdown()


def test_admin_swap_needs_the_token(mt, mlp, tmp_path):
    sj, params, shapes = mlp
    sym_file = tmp_path / "m.json"
    sym_file.write_text(sj)
    params_file = str(tmp_path / "m.params")
    mt.nd.save(params_file, {k: mt.nd.array(v + np.float32(0.125),
                                            ctx=mt.cpu())
                             for k, v in params.items()})
    sess = mt.serving.ServingSession(sj, params, shapes, buckets=(1,),
                                     max_delay_ms=1, contexts=[mt.cpu()],
                                     version_tag="admin-v0")
    server = mt.serving.ServingHTTPServer(sess, port=0, admin_token="s3")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = server.endpoint + "/v1/admin/swap"
    body = {"symbol_file": str(sym_file), "params_file": params_file,
            "version_tag": "admin-v1"}
    try:
        assert _post(url, body)[0] == 403
        req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                     headers={"X-Admin-Token": "s3"})
        with urllib.request.urlopen(req, timeout=60) as r:
            info = json.loads(r.read())
        assert info["version"] == "admin-v1" and info["generation"] == 1
    finally:
        server.shutdown()


def test_replica_kill_quarantines_and_respawns(mt, mlp):
    """A kill at serving.replica.collect: that request fails with a
    ReplicaCrash (HTTP 500), the replica is quarantined, rebuilt and
    re-warmed off the hot path, and the session serves on."""
    sj, params, shapes = mlp
    ref = _Reference(sj, params, (1,), mt)
    with mt.serving.ServingSession(sj, params, shapes, buckets=(1,),
                                   max_delay_ms=1, contexts=[mt.cpu()],
                                   version_tag="kill") as sess:
        x = _rand((1, 784), 5)
        try:
            with mt.faults.scope("serving.replica.collect:kind=kill,"
                                 "times=1"):
                with pytest.raises(mt.serving.ReplicaCrash):
                    sess.predict({"data": x}, timeout=30)
        finally:
            mt.faults.reset()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and sess.metrics.counter(
                "replica_respawned", labels={"outcome": "ok"}).value < 1:
            time.sleep(0.01)
        assert sess.metrics.counter("replica_quarantined").value == 1
        assert sess.healthy_replicas() == 1
        assert ref.matches(x, sess.predict({"data": x}, timeout=30)[0])
