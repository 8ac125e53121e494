"""The port's concurrency witness (mxtpu_torch.analysis.concurrency): armed
over the port's engine, fault points, kvstore client and server and the
serving batcher it finds nothing; a deliberate lock inversion gives
mxtpu's finding; every tracked lock the port creates has a declared key;
and the declared hierarchy is mxtpu's, with the port's own owners. The
witness and every fault schedule are disarmed after each test."""
import ast
import threading
from pathlib import Path

import numpy as np
import pytest

PKG = Path(__file__).resolve().parent.parent / "mxtpu_torch"


@pytest.fixture(scope="module")
def pkgs():
    import torch
    torch.set_num_threads(1)
    import mxtpu
    import mxtpu_torch
    return mxtpu, mxtpu_torch


@pytest.fixture(autouse=True)
def _disarmed(pkgs):
    for p in pkgs:
        p.analysis.concurrency.disarm()
        p.faults.reset()
    yield
    for p in pkgs:
        p.analysis.concurrency.disarm()
        p.faults.reset()


def test_declared_hierarchy_is_mxtpus_with_the_ports_owners(pkgs):
    mx, mt = pkgs
    ref = mx.analysis.declarations
    got = mt.analysis.declarations
    assert got.level_names() == ref.level_names()
    rename = {("_NativePrefetcher", "_lock"): ("_Prefetcher", "_lock")}
    for (lv, keys), (ref_lv, ref_keys) in zip(got.LOCK_LEVELS,
                                              ref.LOCK_LEVELS):
        assert lv == ref_lv
        assert keys == {rename.get(k, k) for k in ref_keys}
    assert got.BLOCKING_KINDS.keys() == ref.BLOCKING_KINDS.keys()
    assert got.ALLOWED_BLOCKING.keys() == ref.ALLOWED_BLOCKING.keys()
    assert got.ALLOWED_EDGES == ref.ALLOWED_EDGES


def _tracked_lock_keys():
    """Every ``_conc.lock(owner, attr)`` / ``_conc.condition(owner=,
    attr=)`` / ``_conc.rlock`` the port's source creates, resolved to
    its (owner, attr) key (``type(self).__name__`` is the enclosing
    class)."""
    keys = []
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for cls in [None] + [n for n in ast.walk(tree)
                             if isinstance(n, ast.ClassDef)]:
            body = tree if cls is None else cls
            for node in ast.walk(body):
                if not (isinstance(node, ast.Call) and
                        isinstance(node.func, ast.Attribute) and
                        isinstance(node.func.value, ast.Name) and
                        node.func.value.id == "_conc" and
                        node.func.attr in ("lock", "rlock", "condition")):
                    continue
                kw = {k.arg: k.value for k in node.keywords}
                args = list(node.args)
                if node.func.attr == "condition":
                    if args or "lock" in kw:
                        continue   # over an existing tracked lock
                    args = [kw["owner"], kw["attr"]]
                owner, attr = args[:2]
                if isinstance(owner, ast.Constant):
                    owner_name = owner.value
                elif cls is None:
                    continue   # type(self).__name__: its class's pass
                else:
                    owner_name = cls.name
                keys.append((path.relative_to(PKG.parent).as_posix(),
                             (owner_name, attr.value)))
    return sorted(set(keys))


def test_every_tracked_lock_of_the_port_has_a_declared_key(pkgs):
    _mx, mt = pkgs
    found = _tracked_lock_keys()
    files = {f for f, _ in found}
    for want in ("mxtpu_torch/serving/batcher.py",
                 "mxtpu_torch/serving/pool.py", "mxtpu_torch/image_record.py",
                 "mxtpu_torch/sharding/plan.py",
                 "mxtpu_torch/kvstore_server.py", "mxtpu_torch/engine.py",
                 "mxtpu_torch/faults/injection.py",
                 "mxtpu_torch/telemetry/metrics.py",
                 "mxtpu_torch/profiler.py", "mxtpu_torch/tune/config.py"):
        assert want in files, want
    undeclared = [(f, k) for f, k in found
                  if mt.analysis.declarations.lock_rank(k) is None]
    assert not undeclared, undeclared


def _workload(mt):
    """The port's engine, fault points, kvstore client and server, and
    the serving batcher, driven from several threads."""
    from mxtpu_torch import kvstore_server as kvs
    from mxtpu_torch.serving.batcher import DynamicBatcher
    # engine: a chain of host tasks on two vars
    e = mt.engine.ThreadedEngine()
    a, b = e.new_variable(), e.new_variable()
    log = []
    for i in range(20):
        e.push(lambda i=i: log.append(i), const_vars=[a], mutable_vars=[b])
    e.wait_for_all()
    # the TCP parameter server and a worker's client
    server = kvs.KVServer(0, 1)
    server.run_in_thread()
    client = kvs.KVClient("127.0.0.1", server.port)
    client.init("w", np.ones(4, np.float32))
    for _ in range(3):
        client.push("w", np.ones(4, np.float32))
        client.pull("w")
    client.barrier()
    client.stop()
    # the batcher: clients submit while a dispatcher drains
    bat = DynamicBatcher(["data"], buckets=(1, 4), max_delay_ms=1.0,
                         example_shapes={"data": (1, 3)})
    items = []

    def submit():
        for _ in range(5):
            items.append(bat.submit({"data": np.zeros((1, 3), np.float32)}))
    threads = [threading.Thread(target=submit) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    drained = 0
    while drained < 15:
        batch = bat.next_batch(timeout=1.0)
        assert batch is not None
        batch.finish([np.zeros((batch.bucket, 2), np.float32)])
        drained += batch.n_valid
    bat.close()
    # a latency fault at the engine seam and a local kvstore under faults
    with mt.faults.scope("engine.dispatch:latency_ms=0.5,p=0.5,seed=1;"
                         "kvstore.push:errno=ECONNRESET,p=0.3,seed=2"):
        for _ in range(6):
            e.push(lambda: None, mutable_vars=[a])
        kv = mt.kv.create("local")
        kv.init("k", mt.nd.ones((2,), ctx=mt.cpu()))
        for _ in range(6):
            kv.push("k", mt.nd.ones((2,), ctx=mt.cpu()))
    e.wait_for_all()
    return log


def test_witness_armed_over_the_ports_subsystems_finds_nothing(pkgs,
                                                               monkeypatch):
    _mx, mt = pkgs
    monkeypatch.setenv("MXTPU_KVSTORE_BACKOFF_S", "0")
    monkeypatch.setenv("MXTPU_KVSTORE_RETRIES", "20")
    with mt.analysis.concurrency.scope() as w:
        log = _workload(mt)
        rep = w.report()
        state = w.state()
    assert log == list(range(20))
    assert rep.ok and not rep.findings, rep.render()
    assert state["acyclic"] and state["violations"] == 0
    assert state["acquisitions"] > 0
    seen = {row["lock"] for row in state["top_locks"]}
    assert {"KVClient._lock", "KVServer.cv",
            "DynamicBatcher._lock"} <= seen, seen


def _inversion(conc):
    outer = conc.lock("ThreadedEngine", "_pending_lock")
    inner = conc.lock("DynamicBatcher", "_lock")
    with conc.scope() as w:
        with outer:
            with inner:
                pass
        rep = w.report()
    return rep, w


def test_a_deliberate_inversion_gives_mxtpus_finding(pkgs):
    mx, mt = pkgs
    ref_rep, ref_w = _inversion(mx.analysis.concurrency)
    rep, w = _inversion(mt.analysis.concurrency)
    strip = ("thread",)
    got = [dict(f.to_dict(), details={k: v for k, v in f.details.items()
                                      if k not in strip})
           for f in rep.findings]
    want = [dict(f.to_dict(), details={k: v for k, v in f.details.items()
                                       if k not in strip})
            for f in ref_rep.findings]
    assert got == want and got
    assert got[0]["details"] == {"held": "ThreadedEngine._pending_lock",
                                 "acquired": "DynamicBatcher._lock"}
    assert w.violations == ref_w.violations == 1


def test_blocking_under_lock_and_its_allowlist(pkgs):
    _mx, mt = pkgs
    conc = mt.analysis.concurrency
    lk = conc.lock("DynamicBatcher", "_lock")
    client_lock = conc.lock("KVClient", "_lock")
    with conc.scope() as w:
        with client_lock:
            conc.blocking("http", "rpc")   # allowlisted
        assert w.report().ok
        with lk:
            conc.blocking("sleep", "backoff")
        errs = w.report().errors
    assert len(errs) == 1 and errs[0].details["kind"] == "sleep"


def test_schedule_fuzzer_is_seeded_like_mxtpus(pkgs):
    mx, mt = pkgs
    for seed in (0, 7):
        assert mt.analysis.concurrency.ScheduleFuzzer(seed).describe() == \
            mx.analysis.concurrency.ScheduleFuzzer(seed).describe()
    with pytest.raises(mt.MXNetError, match="unknown yield point"):
        mt.analysis.concurrency.ScheduleFuzzer(points=["nope"])


def test_pass_web_names_the_slice_it_waits_for(pkgs):
    """The pass web has landed: every lazily loaded name of mxtpu's
    analysis package resolves in the port's, as mxtpu's loads it; an
    unknown name still raises AttributeError."""
    mx, mt = pkgs
    for name in mx.analysis._LAZY_MODULES:
        assert getattr(mt.analysis, name).__name__ == \
            "mxtpu_torch.analysis." + name
    for name, (mod, attr) in mx.analysis._LAZY_ATTRS.items():
        assert getattr(mt.analysis, name) is getattr(
            getattr(mt.analysis, mod), attr), name
    with pytest.raises(AttributeError):
        getattr(mt.analysis, "no_such_pass_web_name")
