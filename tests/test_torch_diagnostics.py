"""The port's diagnostics (``mxtpu_torch.diagnostics``: the device-memory
ledger, the hang watchdog, ``debug_state``/``postmortem``, and the
serving server's ``/debug/state``) held to mxtpu's on the CPU:

* the ledger on the same mlp fit in both packages: the bytes by origin,
  with the two pinned deltas of an eager fused step (the port's
  executor holds a flat gradient buffer, which mxtpu's fused program
  keeps as XLA temporaries; mxtpu's fused state holds its own donated
  copy of the parameters, which the port updates in place): parameters
  + gradients + optimizer state equal; views never count twice; a freed
  NDArray returns its bytes; slots; gauges;
* ``reconcile()`` on the CPU: no allocator counter, so the allocator
  figures are None and ``debug_state`` leaves the key out (a pinned
  delta: mxtpu sums ``jax.live_arrays()``, which has a CPU backend);
* the watchdog: an injected latency at ``executor.device_wait`` inside
  a fit fires exactly one postmortem naming the wait, with mxtpu's keys;
  mxtpu's own unit cases through both packages (engine stall, one dump
  per wedge, re-arming, actions);
* ``debug_state()``'s and ``/debug/state``'s key sets against mxtpu's,
  every key the port lacks named as a pinned delta; the fit's fatal
  exception postmortem; SIGUSR2.
"""
import gc
import json
import os
import signal
import time
import urllib.request

import numpy as np
import pytest

import mxtpu as mx
from mxtpu.models import mlp as mx_mlp


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(2)
    import mxtpu_torch
    return mxtpu_torch


#: the keys of mxtpu's debug_state the port does not give on the CPU, and
#: why: reconcile needs a CUDA allocator (pinned CPU delta)
CPU_STATE_DELTA = {"reconcile"}
#: mxtpu's /debug/state panels of serving subsystems the port has not
#: yet (ROADMAP A.11): admission, hot-swap versions, the warm cache
SERVING_DELTA = {"serving_admission", "serving_version",
                 "serving_warm_cache"}


def _mlp_fit(pk, sym):
    rng = np.random.RandomState(0)
    x = rng.rand(128, 784).astype("float32")
    y = rng.randint(0, 10, 128).astype("float32")
    mod = pk.mod.Module(sym, context=pk.cpu())
    mod.fit(pk.io.NDArrayIter(x, y, 64), num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    return mod


ORIGINS = ("executor", "executor_outputs", "fused_step")


def _by_origin(pk, sym):
    led = pk.diagnostics.ledger()
    gc.collect()
    before = {o: led.live_bytes(origin=o) for o in ORIGINS}
    mod = _mlp_fit(pk, sym)
    gc.collect()
    return mod, {o: led.live_bytes(origin=o) - before[o] for o in ORIGINS}


def test_ledger_bytes_by_origin_match_mxtpus(mt):
    sym = mt.models.get_mlp(10)
    mine_mod, mine = _by_origin(mt, sym)
    _theirs_mod, theirs = _by_origin(mx, mx_mlp.get_symbol(10))
    shapes = sym.infer_shape(data=(64, 784), softmax_label=(64,))[0]
    params = 4 * sum(int(np.prod(s)) for n, s in
                     zip(sym.list_arguments(), shapes)
                     if n not in ("data", "softmax_label"))
    assert mine["executor"] == theirs["executor"] + params  # + gradients
    assert mine["fused_step"] == theirs["fused_step"] - params
    assert mine["fused_step"] == mine_mod._fused.opt_state_bytes()[0]
    assert mine["executor_outputs"] == 64 * 10 * 4
    assert theirs["executor_outputs"] == 0
    assert sum(mine.values()) - mine["executor_outputs"] == \
        sum(theirs.values())


def test_views_count_once_and_frees_return_bytes(mt):
    led = mt.diagnostics.ledger()
    gc.collect()
    base = led.live_bytes(origin="ndarray")
    a = mt.nd.zeros((16, 16), ctx=mt.cpu())
    views = [a[2:5], a[7], a.reshape((256,))]
    c = mt.nd.array(a, ctx=mt.cpu())  # a copy: its own storage
    assert led.live_bytes(origin="ndarray") - base == 2 * 16 * 16 * 4
    for v in views:
        mt.diagnostics.ledger().track(v._data)  # re-tracking a view
    assert led.live_bytes(origin="ndarray") - base == 2 * 16 * 16 * 4
    del a
    gc.collect()
    # the views keep the storage alive, so its bytes stay
    assert led.live_bytes(origin="ndarray") - base == 2 * 16 * 16 * 4
    del views, c, v
    gc.collect()
    assert led.live_bytes(origin="ndarray") == base
    with mt.diagnostics.alloc_origin("outer"):
        with mt.diagnostics.alloc_origin("inner"):
            b = mt.nd.ones((8,), ctx=mt.cpu())
    assert led.live_bytes(origin="outer") == 32
    snap = led.snapshot()
    assert snap["live_bytes"]["cpu(0)/outer"] == 32
    assert set(snap) == set(mx.diagnostics.ledger().snapshot())
    del b
    gc.collect()
    assert led.live_bytes(origin="outer") == 0


def test_slots_gauges_and_primitives_match_mxtpus(mt):
    """The primitive pair and slot accounting behave as mxtpu's, and the
    gauges read the same series names."""
    out = []
    for pk in (mt, mx):
        led = pk.diagnostics.DeviceMemoryLedger(register_gauges=False)
        tok = led.alloc(100, ctx="cpu(0)", origin="x")

        class Owner:
            pass
        o = Owner()
        s = led.slot(o, 40, "slot", ctx="cpu(0)")
        s.set(60)
        peak = led.peak_bytes()
        led.free(tok)
        del o
        gc.collect()
        out.append((peak, led.live_bytes(), led.shard_bytes()))
    assert out[0] == out[1] == (160, 0, {"cpu(0)": 0})
    names = {m.name for m in mt.telemetry.registry().series()}
    assert {"mem_tracked_buffers", "mem_live_bytes", "mem_peak_bytes"} <= \
        names


def test_reconcile_on_the_cpu_is_a_pinned_delta(mt):
    """No CUDA allocator holds the ledger's bytes: reconcile says so with
    None figures, and debug_state leaves the key out."""
    keep = mt.nd.zeros((4,), ctx=mt.cpu())
    rec = mt.diagnostics.reconcile()
    assert rec["allocator"] is None and rec["drift_bytes"] is None
    assert rec["ledger_bytes"] == mt.diagnostics.ledger().live_bytes()
    assert "reconcile" not in mt.diagnostics.debug_state()
    del keep


def test_debug_state_keys_are_mxtpus(mt):
    mine = set(mt.diagnostics.debug_state())
    theirs = set(mx.diagnostics.debug_state())
    theirs.discard("training_health")
    mine.discard("training_health")
    assert mine == theirs - CPU_STATE_DELTA
    eng = mt.diagnostics.debug_state()["engine"]
    assert set(eng) == set(mx.diagnostics.debug_state()["engine"])


# ------------------------------------------------------------ watchdog
@pytest.mark.parametrize("which", ["mxtpu", "port"])
def test_watchdog_unit_cases_hold_in_both_packages(mt, which):
    """mxtpu's watchdog cases: a stalled engine fires once per wedge and
    re-arms on progress; a stalled wait fires once; actions run after
    the detection; progress_age_s reads the singleton."""
    pk = mx if which == "mxtpu" else mt
    W = pk.diagnostics.watchdog
    state = {"depth": 3, "done": 5}
    fired = []
    wd = W.Watchdog(interval=0.01, engine_stall_s=0.0, wait_stall_s=0.05,
                    engine_probe=lambda: (state["depth"], state["done"]),
                    on_detect=fired.append)
    acted = []
    W.add_action(acted.append)
    try:
        assert wd.check() is None        # first sample: progress
        time.sleep(0.01)
        assert "engine stalled" in wd.check()
        assert wd.check() is None        # one dump per wedge
        state["done"] += 1
        assert wd.check() is None        # progress re-arms
        time.sleep(0.01)
        assert wd.check() is not None
        state["depth"] = 0
        W.wait_begin("device_wait")
        time.sleep(0.08)
        r = wd.check()
        assert r.startswith("device_wait stalled") and "device_wait" in r
        assert wd.check() is None
        W.wait_end()
        assert W.active_waits() == []
        assert wd.check() is None
    finally:
        W.remove_action(acted.append)
    assert len(fired) == 3 == wd.detections and acted == fired
    assert W.progress_age_s() >= 0.0


def test_injected_wait_latency_fires_one_postmortem(mt, monkeypatch):
    """A latency at executor.device_wait inside a fit, past the
    watchdog's deadline: one postmortem naming the wait, with mxtpu's
    keys; the fit ends with the bare fit's weights."""
    diag = mt.diagnostics
    reg = mt.telemetry.registry()
    sym = mt.models.get_mlp(10)
    rng = np.random.RandomState(1)
    x = rng.rand(256, 784).astype("float32")
    y = rng.randint(0, 10, 256).astype("float32")

    def fit():
        mod = mt.mod.Module(sym, context=mt.cpu())
        mt.random.seed(0)
        np.random.seed(0)
        mod.fit(mt.io.NDArrayIter(x, y, 64), num_epoch=1, max_in_flight=1,
                optimizer="sgd", optimizer_params={"learning_rate": 0.1})
        return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    bare = fit()
    diag.stop_watchdog()
    monkeypatch.setenv("MXTPU_WATCHDOG_WAIT_S", "0.1")
    monkeypatch.setenv("MXTPU_WATCHDOG_INTERVAL_S", "0.02")
    n0 = reg.counter("diag_postmortems", labels={"source": "watchdog"}).value
    try:
        with mt.faults.scope("executor.device_wait:latency_ms=500,times=1,"
                             "after=1"):
            faulted = fit()
        time.sleep(0.1)
    finally:
        diag.stop_watchdog()
    n = reg.counter("diag_postmortems",
                    labels={"source": "watchdog"}).value - n0
    pm = diag.last_postmortem()
    assert n == 1 and pm["source"] == "watchdog"
    assert "device_wait" in pm["reason"]
    want = set(mx.diagnostics.debug_state()) - CPU_STATE_DELTA - \
        {"training_health"}
    assert want <= set(pm) and pm["flight"]
    for k in bare:
        np.testing.assert_array_equal(bare[k], faulted[k])


def test_fit_exception_leaves_a_postmortem(mt, monkeypatch):
    """An exception (not a usage MXNetError) escaping fit leaves a
    postmortem with source "fit" before it propagates (mxtpu :276-291);
    a usage error does not."""
    sym = mt.models.get_mlp(10)
    x = np.zeros((64, 784), np.float32)
    y = np.zeros(64, np.float32)
    mod = mt.mod.Module(sym, context=mt.cpu())

    def boom(param):
        raise RuntimeError("callback failed")
    with pytest.raises(RuntimeError):
        mod.fit(mt.io.NDArrayIter(x, y, 32), num_epoch=1,
                batch_end_callback=boom)
    pm = mt.diagnostics.last_postmortem()
    assert pm["source"] == "fit" and "callback failed" in pm["exception"]
    before = pm
    with pytest.raises(mt.MXNetError):
        mod.fit(mt.io.NDArrayIter(x, y, 32), num_epoch=None)
    assert mt.diagnostics.last_postmortem() is before


def test_sigusr2_dumps_a_postmortem(mt, tmp_path):
    """SIGUSR2 dumps a postmortem while the port's handler is installed;
    a fit holds the handler only while it runs and gives the signal back
    (so mxtpu's own handler can claim it in the same process)."""
    diag = mt.diagnostics
    prev = signal.signal(signal.SIGUSR2, signal.SIG_DFL)
    try:
        assert diag.install_signal_handler()
        before = diag.last_postmortem()
        os.kill(os.getpid(), signal.SIGUSR2)
        for _ in range(100):
            if diag.last_postmortem() is not before:
                break
            time.sleep(0.02)
        pm = diag.last_postmortem()
        assert pm is not before and pm["source"] == "signal"
        assert diag.uninstall_signal_handler()
        assert signal.getsignal(signal.SIGUSR2) is signal.SIG_DFL
        held = []
        mod = mt.mod.Module(mt.models.get_mlp(10), context=mt.cpu())
        mod.fit(mt.io.NDArrayIter(np.zeros((32, 784), np.float32),
                                  np.zeros(32, np.float32), 16),
                num_epoch=1, batch_end_callback=lambda p: held.append(
                    signal.getsignal(signal.SIGUSR2)))
        assert held and all(h is not signal.SIG_DFL for h in held)
        assert signal.getsignal(signal.SIGUSR2) is signal.SIG_DFL
    finally:
        diag.uninstall_signal_handler()
        signal.signal(signal.SIGUSR2, prev)
    path = diag.dump_state(str(tmp_path / "state.json"))
    assert set(json.load(open(path))) == set(diag.debug_state())


# ------------------------------------------------------ /debug/state
def _serve(pk, **kw):
    from mxtpu_torch.models.serving_fixtures import get_fixture as mine
    from mxtpu.models.serving_fixtures import get_fixture as theirs
    sj, params, shapes = (mine if pk is not mx else theirs)("mlp")
    srv = pk.serving.serve(sj, params, shapes, port=0, block=False,
                           buckets=(1, 4), **kw)
    x = np.random.RandomState(0).rand(*shapes["data"]).astype("float32")
    body = json.dumps({"inputs": {"data": x.tolist()}}).encode()
    for _ in range(2):
        urllib.request.urlopen(urllib.request.Request(
            srv.endpoint + "/v1/predict", data=body), timeout=60).read()
    state = json.loads(urllib.request.urlopen(
        srv.endpoint + "/debug/state", timeout=60).read())
    trace = json.loads(urllib.request.urlopen(
        srv.endpoint + "/debug/trace", timeout=60).read())
    return srv, state, trace


def test_debug_state_route_keys_are_mxtpus(mt):
    """The port's /debug/state has mxtpu's keys, less the pinned deltas
    (CPU reconcile; A.11's serving panels), with the serving pool's
    ledger origin; /debug/trace is a Chrome trace holding the requests'
    spans; the stdlib mxtpu_top renders the port's server."""
    import subprocess
    import sys
    srv, mine, trace = _serve(mt, contexts=[mt.cpu()])
    try:
        top = subprocess.run([sys.executable, "tools/mxtpu_top.py", "--once",
                              srv.endpoint], capture_output=True, text=True,
                             timeout=60, cwd=os.path.dirname(
                                 os.path.dirname(os.path.abspath(__file__))))
    finally:
        srv.shutdown()
    srv, theirs, their_trace = _serve(mx)
    srv.shutdown()
    want = set(theirs) - CPU_STATE_DELTA - SERVING_DELTA - \
        {"training_health"}
    assert set(mine) - {"training_health"} == want
    assert mine["ledger"]["live_bytes"].get("cpu(0)/serving_pool", 0) > 0
    names = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
    assert {"serving.request", "batch[1]"} <= names
    assert set(trace) == set(their_trace)
    assert top.returncode == 0 and "serving_pool" in top.stdout
