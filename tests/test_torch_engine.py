"""The port's dependency engine (mxtpu_torch.engine over the native
scheduler it builds from src/core) run through mxtpu's engine cases by
one body for both packages: write serialization, the reader/writer
protocol, a random DAG, priorities and parallelism, NaiveEngine, and
wait_for_var. Its series count the pushes; a failed native build raises
instead of falling back; NaiveEngine runs only when asked for."""
import random
import threading
import time

import pytest


@pytest.fixture(scope="module")
def pkgs():
    import torch
    torch.set_num_threads(1)
    import mxtpu
    import mxtpu_torch
    return mxtpu, mxtpu_torch


@pytest.fixture(params=["mxtpu", "mxtpu_torch"])
def eng(request, pkgs):
    pkg = dict(zip(("mxtpu", "mxtpu_torch"), pkgs))[request.param]
    if request.param == "mxtpu" and not pkg._native.native_available():
        pytest.skip("mxtpu's libmxtpu.so is not built")
    return pkg.engine


def test_write_serialization(eng):
    e = eng.ThreadedEngine()
    var = e.new_variable()
    out = []
    for i in range(200):
        e.push(lambda i=i: out.append(i), mutable_vars=[var])
    e.wait_for_var(var)
    assert out == list(range(200))
    e.delete_variable(var)
    e.wait_for_all()


def test_reader_writer_protocol(eng):
    e = eng.ThreadedEngine()
    var = e.new_variable()
    state = {"v": 0}
    reads = []
    lock = threading.Lock()

    def write(i):
        time.sleep(0.001)
        state["v"] = i

    def read():
        with lock:
            reads.append(state["v"])

    for i in range(1, 11):
        e.push(lambda i=i: write(i), mutable_vars=[var])
        for _ in range(3):
            e.push(read, const_vars=[var])
    e.wait_for_all()
    # every read observes the value of the write just before it
    for i in range(1, 11):
        assert reads[(i - 1) * 3:(i - 1) * 3 + 3] == [i, i, i]


def test_random_dag_stress(eng):
    e = eng.ThreadedEngine()
    rng = random.Random(0)
    n_vars = 8
    vars_ = [e.new_variable() for _ in range(n_vars)]
    counters = [0] * n_vars
    expected = [0] * n_vars

    def bump(idxs):
        for i in idxs:
            counters[i] += 1

    for _ in range(300):
        k = rng.randint(1, 3)
        mut = rng.sample(range(n_vars), k)
        const = [i for i in rng.sample(range(n_vars), rng.randint(0, 2))
                 if i not in mut]
        for i in mut:
            expected[i] += 1
        e.push(lambda mut=mut: bump(mut),
               const_vars=[vars_[i] for i in const],
               mutable_vars=[vars_[i] for i in mut])
    e.wait_for_all()
    assert counters == expected
    for v in vars_:
        e.delete_variable(v)
    e.wait_for_all()


def test_priority_and_parallelism(eng):
    e = eng.ThreadedEngine()
    assert e.num_workers >= 2
    done = threading.Event()
    e.push(done.wait)  # occupies one worker until released
    ran = threading.Event()
    e.push(ran.set, priority=10)
    assert ran.wait(timeout=5)  # an independent op runs despite it
    done.set()
    e.wait_for_all()


def test_naive_engine(eng):
    e = eng.NaiveEngine()
    var = e.new_variable()
    out = []
    e.push(lambda: out.append(1), mutable_vars=[var])
    assert out == [1]
    e.wait_for_var(var)
    e.wait_for_all()
    e.delete_variable(var)


def test_dispatch_span_is_the_pushers_child(eng, pkgs):
    """The trace parent is captured at push time and restored on the
    native worker thread."""
    tel = eng._tel
    e = eng.ThreadedEngine()
    got = []
    seen = {}
    tel.tracing.set_span_sink(lambda s: seen.setdefault(s.name, s))
    try:
        with tel.span("pusher") as root:
            e.push(lambda: got.append(tel.current_span()))
        e.wait_for_all()
    finally:
        tel.tracing.set_span_sink(None)
    assert got[0].name == "engine.dispatch"
    assert got[0].parent_id == root.span_id
    assert got[0].trace_id == root.trace_id


def test_series_count_the_pushes(pkgs):
    _mx, mt = pkgs
    reg = mt.telemetry.registry()
    disp = reg.counter("engine_ops_dispatched")
    comp = reg.counter("engine_ops_completed")
    waits = reg.histogram("engine_queue_wait_ms")
    before = (disp.value, comp.value, waits.count)
    e = mt.engine.ThreadedEngine()
    var = e.new_variable()
    for _ in range(25):
        e.push(lambda: None, mutable_vars=[var])
    e.wait_for_all()
    n = mt.engine.NaiveEngine()
    for _ in range(5):
        n.push(lambda: None)
    assert disp.value - before[0] == 30
    assert comp.value - before[1] == 30
    assert waits.count - before[2] == 30
    text = mt.telemetry.prometheus_text(reg)
    for name in ("mxtpu_engine_ops_dispatched", "mxtpu_engine_ops_completed",
                 "mxtpu_engine_queue_depth", "mxtpu_engine_workers",
                 "mxtpu_engine_worker_busy_ms"):
        assert name in text


def test_a_raising_callback_is_raised_by_the_next_wait(pkgs):
    _mx, mt = pkgs
    e = mt.engine.ThreadedEngine()
    var = e.new_variable()

    def boom():
        raise ValueError("op failed")
    e.push(boom, mutable_vars=[var])
    with pytest.raises(mt.MXNetError, match="ValueError: op failed"):
        e.wait_for_var(var)
    e.wait_for_all()   # reported once


def test_dispatch_fault_point_fires_before_the_push(pkgs):
    _mx, mt = pkgs
    e = mt.engine.ThreadedEngine()
    ran = []
    try:
        with mt.faults.scope("engine.dispatch:kind=raise,times=1"):
            with pytest.raises(mt.faults.FaultInjected):
                e.push(lambda: ran.append(1))
            e.push(lambda: ran.append(2))
        e.wait_for_all()
    finally:
        mt.faults.reset()
    assert ran == [2] and not e._pending


def test_failed_native_build_raises_instead_of_falling_back(pkgs,
                                                            monkeypatch):
    _mx, mt = pkgs
    from mxtpu_torch import _native, engine
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native.shutil, "which", lambda name: None)
    monkeypatch.setattr(engine, "_ENGINE", None)
    monkeypatch.setenv("MXTPU_ENGINE_TYPE", "ThreadedEngine")
    with pytest.raises(mt.MXNetError, match="g..? not found"):
        engine.ThreadedEngine()
    with pytest.raises(mt.MXNetError, match="g..? not found"):
        engine.get()
    assert engine.started() is None


def test_naive_engine_only_when_asked(pkgs, monkeypatch):
    _mx, mt = pkgs
    from mxtpu_torch import engine
    for var, kind, cls in (("MXTPU_ENGINE_TYPE", "NaiveEngine",
                            engine.NaiveEngine),
                           ("MXNET_ENGINE_TYPE", "NaiveEngine",
                            engine.NaiveEngine),
                           ("MXTPU_ENGINE_TYPE", "ThreadedEngine",
                            engine.ThreadedEngine)):
        monkeypatch.delenv("MXTPU_ENGINE_TYPE", raising=False)
        monkeypatch.delenv("MXNET_ENGINE_TYPE", raising=False)
        monkeypatch.setattr(engine, "_ENGINE", None)
        monkeypatch.setenv(var, kind)
        assert type(engine.get()) is cls
    monkeypatch.setattr(engine, "_ENGINE", None)
    monkeypatch.setenv("MXTPU_ENGINE_TYPE", "FastEngine")
    with pytest.raises(mt.MXNetError, match="FastEngine"):
        engine.get()


def test_waitall_drains_the_engine_and_every_initialised_card(
        pkgs, monkeypatch):
    """ROADMAP C.20 on the CPU, with torch.cuda stood in: ``waitall``
    drains the started engine first, then synchronizes each device that
    has a context (0, 1 and 3 of four here), not just the current one."""
    import torch
    _mx, mt = pkgs
    from mxtpu_torch import engine
    calls = []

    class Drained:
        def wait_for_all(self):
            calls.append("engine")
    monkeypatch.setattr(engine, "_ENGINE", Drained())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch._C, "_cuda_hasPrimaryContext",
                        lambda d: d != 2, raising=False)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: calls.append(d))
    mt.nd.waitall()
    assert calls == ["engine", 0, 1, 3]
    # no CUDA: the engine only; no engine started: the cards only
    calls.clear()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mt.nd.waitall()
    assert calls == ["engine"]
    calls.clear()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(engine, "_ENGINE", None)
    mt.nd.waitall()
    assert calls == [0, 1, 3]


def test_waitall_waits_for_pushed_host_tasks(pkgs):
    _mx, mt = pkgs
    e = mt.engine.get()
    done = []

    def slow():
        time.sleep(0.05)
        done.append(1)
    e.push(slow)
    mt.nd.waitall()
    assert done == [1]
