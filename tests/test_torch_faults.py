"""The port's faults package held to mxtpu's exactly: the MXTPU_FAULTS
grammar parses to equal schedules (and refuses the same typos), one
seeded schedule fires on the same crossings, RetryPolicy's backoff and
env_attempts agree, FaultKill escapes ``except Exception``, and a local
kvstore under a transient schedule stores what it stores unarmed, with
mxtpu's retry count. Every schedule armed here is disarmed on exit."""
import logging

import numpy as np
import pytest

SCHEDULES = [
    "kvstore.push:errno=ECONNRESET,p=0.5,seed=3",
    "kvstore.pull:kind=errno,errno=ECONNRESET,p=0.25,seed=8",
    "elastic.snapshot.write:errno=ENOSPC,p=0.3,seed=7;"
    "serving.replica.dispatch:kind=kill,after=5",
    "io.prefetch.produce:kind=raise,times=2",
    "executor.device_wait:latency_ms=12.5,p=0.1",
    "engine.dispatch:kind=latency,latency_ms=1,seed=4,times=3",
    "serving.decode.step:kind=kill,times=2;serving.decode.evict:after=1",
    "quant.calibration_load:errno=5",
    "  kvstore.push : p=1 ; ; kvstore.pull:seed=2  ",
    "serving.replica.collect:kind=errno,errno=EIO,after=3,times=4,p=0.75",
    "serving.decode.prefill:;serving.decode.block_alloc:kind=raise",
    "elastic.snapshot.fsync_rename:kind=kill",
]

TYPOS = [
    "kvstore.psh:p=0.5",                       # unknown point
    "kvstore.push:prob=0.5",                   # unknown key
    "kvstore.push:p=half",                     # not a number
    "kvstore.push:kind=explode",               # unknown kind
    "kvstore.push:errno=ENOTANERRNO",          # unknown errno
    "kvstore.push:p",                          # no key=value
]


@pytest.fixture(scope="module")
def pkgs():
    import torch
    torch.set_num_threads(1)
    import mxtpu
    import mxtpu_torch
    for name in ("mxtpu.faults", "mxtpu_torch.faults"):
        logging.getLogger(name).setLevel(logging.CRITICAL)
    return mxtpu, mxtpu_torch


@pytest.fixture(autouse=True)
def _disarmed(pkgs):
    for p in pkgs:
        p.faults.reset()
    yield
    for p in pkgs:
        p.faults.reset()


@pytest.mark.parametrize("text", SCHEDULES)
def test_parse_schedule_describes_as_mxtpu(pkgs, text):
    mx, mt = pkgs
    assert mt.faults.parse_schedule(text).describe() == \
        mx.faults.parse_schedule(text).describe()


@pytest.mark.parametrize("text", TYPOS)
def test_typoed_schedule_raises_in_both(pkgs, text):
    mx, mt = pkgs
    with pytest.raises(mx.MXNetError):
        mx.faults.parse_schedule(text)
    with pytest.raises(mt.MXNetError):
        mt.faults.parse_schedule(text)


def test_points_catalog_is_mxtpus(pkgs):
    mx, mt = pkgs
    assert mt.faults.POINTS == mx.faults.POINTS


def _firings(faults, n=1000):
    """Crossings of kvstore.push that fired (by index) under one seeded
    schedule with a probability, a skip and a cap."""
    fired = []
    with faults.scope("kvstore.push:kind=raise,p=0.3,seed=11,after=7,"
                      "times=250;kvstore.pull:kind=errno,errno=EIO,"
                      "p=0.6,seed=12"):
        for i in range(n):
            try:
                faults.point("kvstore.push")
            except faults.FaultInjected:
                fired.append(("push", i))
            try:
                faults.point("kvstore.pull")
            except OSError as exc:
                fired.append(("pull", i, exc.errno))
    return fired


def test_seeded_schedule_fires_on_mxtpus_crossings(pkgs):
    mx, mt = pkgs
    want = _firings(mx.faults)
    assert 0 < len(want) < 2000
    assert _firings(mt.faults) == want


def test_retry_backoff_equals_mxtpus(pkgs):
    mx, mt = pkgs
    for op in ("kvstore.push", "kvstore.pull", "elastic.restore"):
        for seed in (0, 1, 7):
            for base, cap, jitter in ((0.05, 1.0, 0.1), (0.1, 30.0, 0.1),
                                      (1.0, 4.0, 0.0), (0.2, 30.0, 0.5)):
                a = mx.faults.RetryPolicy(op, backoff_s=base,
                                          backoff_cap_s=cap,
                                          jitter_frac=jitter, seed=seed)
                b = mt.faults.RetryPolicy(op, backoff_s=base,
                                          backoff_cap_s=cap,
                                          jitter_frac=jitter, seed=seed)
                for k in range(1, 12):
                    assert b.backoff(k) == a.backoff(k), (op, seed, k)


@pytest.mark.parametrize("raw", [None, "3", "0", "-2", "abc", " 5"])
def test_env_attempts_parses_as_mxtpu(pkgs, monkeypatch, raw):
    mx, mt = pkgs
    if raw is None:
        monkeypatch.delenv("MXTPU_TEST_RETRIES", raising=False)
    else:
        monkeypatch.setenv("MXTPU_TEST_RETRIES", raw)
    assert mt.faults.env_attempts("MXTPU_TEST_RETRIES", 2) == \
        mx.faults.env_attempts("MXTPU_TEST_RETRIES", 2)


def test_fault_kill_is_not_caught_by_except_exception(pkgs):
    _mx, mt = pkgs
    caught = []
    with mt.faults.scope("engine.dispatch:kind=kill"):
        with pytest.raises(mt.faults.FaultKill):
            try:
                mt.faults.point("engine.dispatch")
            except Exception as exc:  # must not see it
                caught.append(exc)
    assert not caught
    assert issubclass(mt.faults.FaultKill, BaseException)
    assert not issubclass(mt.faults.FaultKill, Exception)


def test_retry_policy_counts_and_exhausts_as_mxtpu(pkgs):
    mx, mt = pkgs
    for pkg in (mx, mt):
        slept = []
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise ConnectionResetError("reset")
            return "ok"
        pol = pkg.faults.RetryPolicy("test.op", max_attempts=4,
                                     sleep=slept.append)
        assert pol.call(flaky) == "ok" and calls["n"] == 3
        assert slept == [pol.backoff(1), pol.backoff(2)]
        pol = pkg.faults.RetryPolicy("test.op", max_attempts=2,
                                     sleep=slept.append)
        with pytest.raises(ValueError):   # not retryable: no retry
            pol.call(lambda: (_ for _ in ()).throw(ValueError("usage")))
        with pytest.raises(TimeoutError):
            pol.call(lambda: (_ for _ in ()).throw(TimeoutError("slow")))


def _counter(pkg, name, op):
    for m in pkg.telemetry.registry().series():
        if m.name == name and m.labels == {"op": op}:
            return m.value
    return 0


def _kv_run(pkg, schedule):
    """A local kvstore with an SGD updater: init three keys, push lists
    and single values and pull them back, under ``schedule`` (None:
    unarmed). Returns the stored values and the retries taken."""
    rng = np.random.RandomState(5)
    shapes = {3: (4, 5), 5: (7,), 9: (2, 3)}
    kv = pkg.kv.create("local")
    for k, s in shapes.items():
        kv.init(k, pkg.nd.array(rng.rand(*s).astype(np.float32),
                                ctx=pkg.cpu()))
    kv.set_optimizer(pkg.optimizer.create("sgd", learning_rate=0.1))
    before = (_counter(pkg, "retry_attempts", "kvstore.push"),
              _counter(pkg, "retry_attempts", "kvstore.pull"))
    scope = pkg.faults.scope(schedule) if schedule else None
    if scope is not None:
        scope.__enter__()
    try:
        for step in range(6):
            for k, s in shapes.items():
                grads = [pkg.nd.array(rng.rand(*s).astype(np.float32),
                                      ctx=pkg.cpu()) for _ in range(2)]
                kv.push(k, grads if step % 2 else grads[0])
                out = pkg.nd.zeros(s, ctx=pkg.cpu())
                kv.pull(k, out=out)
    finally:
        if scope is not None:
            scope.__exit__(None, None, None)
    stored = {}
    for k, s in shapes.items():
        out = pkg.nd.zeros(s, ctx=pkg.cpu())
        kv.pull(k, out=out)
        stored[k] = out.asnumpy()
    retries = (_counter(pkg, "retry_attempts", "kvstore.push") - before[0],
               _counter(pkg, "retry_attempts", "kvstore.pull") - before[1])
    return stored, retries


def test_local_kvstore_under_transient_faults_stores_the_unarmed_values(
        pkgs, monkeypatch):
    mx, mt = pkgs
    monkeypatch.setenv("MXTPU_KVSTORE_RETRIES", "10")
    monkeypatch.setenv("MXTPU_KVSTORE_BACKOFF_S", "0")
    schedule = ("kvstore.push:kind=errno,errno=ECONNRESET,p=0.4,seed=7;"
                "kvstore.pull:kind=errno,errno=ECONNRESET,p=0.4,seed=8")
    clean, no_retries = _kv_run(mt, None)
    assert no_retries == (0, 0)
    faulted, retries = _kv_run(mt, schedule)
    for k in clean:
        np.testing.assert_array_equal(faulted[k], clean[k])
    assert retries[0] > 0 and retries[1] > 0
    ref_clean, _ = _kv_run(mx, None)
    _ref, ref_retries = _kv_run(mx, schedule)
    assert retries == ref_retries
    for k in clean:   # and the port's update is mxtpu's
        np.testing.assert_allclose(clean[k], ref_clean[k], rtol=1e-6,
                                   atol=1e-7)


def test_exhausted_retries_raise_the_transport_error(pkgs, monkeypatch):
    _mx, mt = pkgs
    monkeypatch.setenv("MXTPU_KVSTORE_RETRIES", "1")
    monkeypatch.setenv("MXTPU_KVSTORE_BACKOFF_S", "0")
    kv = mt.kv.create("local")
    kv.init("w", mt.nd.ones((3,), ctx=mt.cpu()))
    with mt.faults.scope("kvstore.push:kind=errno,errno=ECONNRESET"):
        with pytest.raises(mt.faults.InjectedIOError) as err:
            kv.push("w", mt.nd.ones((3,), ctx=mt.cpu()))
    import errno
    assert err.value.errno == errno.ECONNRESET
    out = mt.nd.zeros((3,), ctx=mt.cpu())
    kv.pull("w", out=out)   # the failed push stored nothing
    np.testing.assert_array_equal(out.asnumpy(), np.ones(3, np.float32))


def _tcp_store(mt, monkeypatch):
    """A ``dist_sync`` store of one worker over a TCP server in a
    thread; returns both."""
    from mxtpu_torch import kvstore_server as kvs
    server = kvs.KVServer(0, 1)
    server.run_in_thread()
    for k, v in (("MXTPU_ROLE", "worker"), ("MXTPU_ROOT_URI", "127.0.0.1"),
                 ("MXTPU_ROOT_PORT", str(server.port)),
                 ("MXTPU_NUM_WORKERS", "1"), ("MXTPU_WORKER_ID", "0"),
                 ("MXTPU_HEARTBEAT_INTERVAL", "3600"),
                 ("MXTPU_KVSTORE_RETRIES", "3"),
                 ("MXTPU_KVSTORE_BACKOFF_S", "0")):
        monkeypatch.setenv(k, v)
    kv = mt.kv.create("dist_sync")
    return kv, server


def _mine(kv, sock):
    return kv._client is not None and sock is kv._client._sock


def test_tcp_push_whose_reply_is_lost_is_not_sent_again(pkgs, monkeypatch):
    """The server applies a push and its reply is lost (a socket timeout
    on the worker): the push raises instead of going out again, so the
    sync round holds this worker's gradient once. A pull whose reply is
    lost reads again on a new connection."""
    import socket
    from mxtpu_torch import kvstore_server as kvs
    _mx, mt = pkgs
    kv, server = _tcp_store(mt, monkeypatch)
    real = kvs._recv_msg
    lose = {"op": None}

    def recv(sock):
        resp = real(sock)
        if lose["op"] is not None and _mine(kv, sock):
            lose["op"] = None
            raise socket.timeout("timed out")
        return resp
    monkeypatch.setattr(kvs, "_recv_msg", recv)
    try:
        w0 = np.arange(6, dtype=np.float32).reshape(2, 3)
        g = np.ones((2, 3), np.float32)
        kv.init(3, mt.nd.array(w0, ctx=mt.cpu()))
        kv.set_optimizer(mt.optimizer.create("sgd", learning_rate=0.5))
        pushes = _counter(mt, "retry_attempts", "kvstore.push")
        pulls = _counter(mt, "retry_attempts", "kvstore.pull")
        lose["op"] = "PUSH"
        with pytest.raises(mt.base.MXNetError, match="not sent again"):
            kv.push(3, mt.nd.array(g, ctx=mt.cpu()))
        assert _counter(mt, "retry_attempts", "kvstore.push") == pushes
        assert server.versions[3] == 1 and 3 not in server.merge
        assert kv._client._push_counts.get(3, 0) == 0
        lose["op"] = "PULL"
        out = mt.nd.zeros((2, 3), ctx=mt.cpu())
        kv.pull(3, out=out)
        assert _counter(mt, "retry_attempts", "kvstore.pull") == pulls + 1
        np.testing.assert_array_equal(out.asnumpy(), w0 - 0.5 * g)
        np.testing.assert_array_equal(server.store[3], w0 - 0.5 * g)
    finally:
        kv.close()


def test_tcp_push_cut_mid_send_is_retried_once_on_a_new_connection(
        pkgs, monkeypatch):
    """A push whose send fails after part of its frame went out: the
    server drops the partial frame with its connection, and the retry
    sends the push whole on a new connection, applied once."""
    from mxtpu_torch import kvstore_server as kvs
    _mx, mt = pkgs
    kv, server = _tcp_store(mt, monkeypatch)
    real = kvs._send_msg
    cut = {"armed": False}

    def send(sock, obj):
        if cut["armed"] and obj[0] == "PUSH" and _mine(kv, sock):
            cut["armed"] = False
            sock.sendall(b"\0" * 5)   # less than a frame header
            raise ConnectionResetError("reset mid-frame")
        return real(sock, obj)
    monkeypatch.setattr(kvs, "_send_msg", send)
    try:
        w0 = np.arange(6, dtype=np.float32).reshape(2, 3)
        g = np.full((2, 3), 2.0, np.float32)
        kv.init(3, mt.nd.array(w0, ctx=mt.cpu()))
        kv.set_optimizer(mt.optimizer.create("sgd", learning_rate=0.5))
        first = kv._client._sock
        pushes = _counter(mt, "retry_attempts", "kvstore.push")
        cut["armed"] = True
        kv.push(3, mt.nd.array(g, ctx=mt.cpu()))
        assert not cut["armed"] and kv._client._sock is not first
        assert _counter(mt, "retry_attempts", "kvstore.push") == pushes + 1
        assert server.versions[3] == 1
        assert kv._client._push_counts[3] == 1
        out = mt.nd.zeros((2, 3), ctx=mt.cpu())
        kv.pull(3, out=out)
        np.testing.assert_array_equal(out.asnumpy(), w0 - 0.5 * g)
    finally:
        kv.close()


#: the point the test treats as unreached, and the slice it says brings
#: its seam: the port crosses every point now, so the test puts one into
#: ``UNREACHED`` itself to exercise the warning
UNREACHED_POINT, LATER = "elastic.snapshot.write", "a later slice (test)"


def test_unreached_points_are_exactly_those_the_port_never_crosses(
        pkgs, caplog, monkeypatch):
    """Every point outside ``UNREACHED`` is crossed by some module of the
    port; arming one inside it warns, naming the slice that brings its
    seam."""
    import os
    import re
    _mx, mt = pkgs
    inj = mt.faults.injection
    root = os.path.dirname(mt.__file__)
    crossed = set()
    for d, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith(".py") and f != "injection.py":
                with open(os.path.join(d, f)) as fh:
                    crossed |= set(re.findall(
                        r'point(?:\(|, )\s*"([a-z_.]+)"', fh.read()))
    assert set(inj.UNREACHED) <= set(inj.POINTS)
    assert crossed == set(inj.POINTS) - set(inj.UNREACHED)
    assert UNREACHED_POINT in crossed
    monkeypatch.setattr(inj, "UNREACHED", {UNREACHED_POINT: LATER})
    caplog.set_level(logging.WARNING, logger="mxtpu_torch.faults")
    with mt.faults.scope("kvstore.push:p=0;%s:p=0" % UNREACHED_POINT):
        pass
    never = [r.getMessage() for r in caplog.records
             if "never fires" in r.getMessage()]
    assert len(never) == 1 and UNREACHED_POINT in never[0] \
        and LATER in never[0]


def test_bad_env_schedule_refuses_to_import(tmp_path):
    """A schedule that does not parse stops the port's import (mxtpu's
    logs and arms nothing)."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", "import mxtpu_torch"], cwd=str(tmp_path),
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1",
                 MXTPU_FAULTS="kvstore.psh:p=1"))
    assert out.returncode != 0
    assert "unknown injection point 'kvstore.psh'" in out.stderr
