"""The port's elastic package (``mxtpu_torch.elastic``: async snapshots,
exact fit-resume, the supervisor) on ``cpu()``, twins of every test in
tests/test_elastic.py at mxtpu's sizes, and the files held across the
packages:

* **kill-at-step-N resume parity**: a fit killed at step N and resumed
  from its elastic snapshot equals an uninterrupted fit BIT FOR BIT on
  weights and exactly on accuracy — on the plain fused path, under
  ``MXTPU_PIPELINE=bf16`` (f32 masters) and on a 4-replica CPU mesh
  (the optimizer leaves written per replica row block, the plan's spec
  in the manifest);
* crash-window atomicity: a torn generation, a writer that dies in its
  serialize or is killed at ``fsync_rename`` leave the previous
  generation loadable;
* supervision: the watchdog's wedge restores and retries, a bounded
  give-up, SIGTERM flushes a final snapshot then raises ``Preempted``,
  and ``Supervisor.run`` puts the previous handler back;
* epoch checkpoint callbacks ride the writer; the iterator cursors; the
  series;
* across the packages: mxtpu's ``elastic.load_arrays`` reads a port
  generation's params and optimizer leaves bit for bit and the port's
  reads mxtpu's; an async ``.states`` pickle loads in both packages'
  ``load_optimizer_states``; resuming from an mxtpu generation raises.

Each test restores the SIGTERM handler, the environment and the
pipeline configuration it touched.
"""
import json
import os
import signal
import time

import numpy as np
import pytest

import mxtpu as mx


class Kill(Exception):
    """Simulated hard death of the training process."""


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(2)
    import mxtpu_torch
    return mxtpu_torch


@pytest.fixture(autouse=True)
def _restore_process_state(monkeypatch):
    """The SIGTERM handler, the environment and the pipelines of both
    packages as they were before the test."""
    handler = signal.getsignal(signal.SIGTERM)
    env = dict(os.environ)
    yield
    signal.signal(signal.SIGTERM, handler)
    os.environ.clear()
    os.environ.update(env)
    # mxtpu's writer thread holds its last job (and the module state the
    # job references) until the next job comes: stop the thread, so a
    # later test of the process does not count that state in mxtpu's
    # memory ledger (a later submit starts the thread again)
    from mxtpu.elastic import snapshot as mx_snap
    if mx_snap._WRITER is not None:
        mx_snap._WRITER.close()
    import mxtpu_torch
    from mxtpu.compile import pipeline as mx_pipeline
    for pipe in (mxtpu_torch.compile.pipeline, mx_pipeline):
        pipe.configure(None)


def _esnap(mt):
    return mt.elastic.snapshot


def _mnist_like(n=256, seed=7):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 784).astype("float32"),
            rng.randint(0, 10, n).astype("float32"))


def _make_iter(pkg, batch_size=64, shuffle=False, poison_batch=None):
    X, y = _mnist_like()
    if poison_batch is not None:
        X = X.copy()
        X[poison_batch * batch_size:(poison_batch + 1) * batch_size] = \
            np.inf
    return pkg.io.NDArrayIter(X, y, batch_size=batch_size, shuffle=shuffle,
                              label_name="softmax_label")


def _module(pkg):
    return pkg.mod.Module(pkg.models.mlp.get_symbol(10), context=pkg.cpu())


def _fit(mt, num_epoch=2, seed=11, kill_at_step=None, module=None,
         optimizer="sgd", opt_params=None, pkg=None, **fit_kwargs):
    """One mlp fit; ``kill_at_step`` raises Kill after that many batch
    callbacks (1-based), simulating the process dying mid-epoch."""
    pkg = pkg or mt
    it = _make_iter(pkg)
    mod = module or _module(pkg)
    metric = pkg.metric.create(["acc", "ce"])
    pkg.random.seed(seed)
    np.random.seed(seed)
    steps = [0]
    cb = None
    if kill_at_step is not None:
        def cb(param):
            steps[0] += 1
            if steps[0] >= kill_at_step:
                raise Kill()
    try:
        mod.fit(it, num_epoch=num_epoch, eval_metric=metric,
                optimizer=optimizer,
                optimizer_params=opt_params or {"learning_rate": 0.05,
                                                "momentum": 0.9},
                initializer=pkg.initializer.Xavier(),
                batch_end_callback=cb, metric_sync=2, **fit_kwargs)
    except Kill:
        pass
    weights = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    return dict(metric.get_name_value()), weights, mod


def _assert_resume_parity(mt, tmp_path, kill_at_step=3, **fit_kwargs):
    """Uninterrupted vs killed-at-step-N + resumed: weights bit-exact,
    integer-summed metrics exact."""
    prefix = str(tmp_path / "ck")
    m_full, w_full, _ = _fit(mt, **fit_kwargs)
    cfg = mt.elastic.ElasticConfig(prefix, every_n_steps=1, sync=True)
    _fit(mt, kill_at_step=kill_at_step, elastic=cfg, **fit_kwargs)
    man = _esnap(mt).latest_manifest(prefix)
    assert man is not None and man["cursor"]["global_step"] == kill_at_step
    m_res, w_res, mod = _fit(mt, resume=prefix, elastic=False,
                             **fit_kwargs)
    for k in w_full:
        np.testing.assert_array_equal(
            w_full[k], w_res[k],
            err_msg="weights diverged at %s: resume is not exact" % k)
    assert m_full["accuracy"] == m_res["accuracy"], (m_full, m_res)
    # float sums may differ in summation order only
    np.testing.assert_allclose(m_full["cross-entropy"],
                               m_res["cross-entropy"], rtol=1e-5)
    return mod


def _cpu_mesh(mt, n=4):
    return mt.sharding.MeshContext.create(
        n, devices=[mt.cpu(i) for i in range(n)])


# --------------------------------------------------------- the parity gate
def test_kill_at_step_resume_parity(mt, tmp_path):
    mod = _assert_resume_parity(mt, tmp_path)
    assert mod._fused is not None


def test_kill_at_step_resume_parity_bf16(mt, tmp_path):
    """Same gate under the bf16 rewrite: the snapshot carries the f32
    masters (the executors' arguments) and resume is still bit-exact."""
    os.environ["MXTPU_PIPELINE"] = "bf16"
    mt.compile.pipeline.configure(None)
    mod = _assert_resume_parity(mt, tmp_path)
    rep = mod._fused.pipeline_report
    assert rep is not None and "bf16" in rep.applied, \
        "bf16 rewrite was not applied — gate would not cover masters"
    for v in mod.get_params()[0].values():
        assert v.dtype == np.float32  # masters, not bf16
    man = _esnap(mt).latest_manifest(str(tmp_path / "ck"))
    assert man["pipeline"] == ["bf16"]


def test_kill_at_step_resume_parity_mesh(mt, tmp_path):
    """Same gate on a 4-replica CPU mesh: the snapshot writes the
    optimizer state the plan keeps by rows as each replica's row block
    with the plan's spec in the manifest, and the restored state keeps
    the split."""
    mod = _assert_resume_parity(mt, tmp_path, mesh=_cpu_mesh(mt))
    fused = mod._fused
    assert fused is not None and fused._plan is not None
    assert "fc1_weight" in fused.sharded_names
    assert fused.opt_state[0]["fc1_weight"].shape[0] * 4 == 128
    man = _esnap(mt).latest_manifest(str(tmp_path / "ck"))
    entry = man["opt_entries"]["fc1_weight"]
    assert entry["spec"] == ["data"]
    pieces = entry["shards"]["0"]["pieces"]
    assert len(pieces) == 4
    assert [p["index"][0] for p in pieces] == [[0, 32], [32, 64],
                                               [64, 96], [96, 128]]
    assert man["mesh"] == {"data": 4}


def test_resume_from_epoch_boundary_snapshot(mt, tmp_path):
    """With epoch-cadence snapshots only, a mid-epoch kill resumes from
    the epoch boundary and replays the epoch — still bit-exact (RNG
    streams restored to the boundary state)."""
    prefix = str(tmp_path / "ck")
    m_full, w_full, _ = _fit(mt)
    cfg = mt.elastic.ElasticConfig(prefix, every_n_steps=0, sync=True)
    _fit(mt, kill_at_step=6, elastic=cfg)          # dies inside epoch 1
    man = _esnap(mt).latest_manifest(prefix)
    assert man["cursor"]["epoch_boundary"] is True
    assert man["cursor"]["epoch"] == 0
    m_res, w_res, _ = _fit(mt, resume=prefix, elastic=False)
    for k in w_full:
        np.testing.assert_array_equal(w_full[k], w_res[k], err_msg=k)
    assert m_full["accuracy"] == m_res["accuracy"]


def test_epoch_boundary_snapshot_carries_post_reset_iterator(mt, tmp_path):
    """An epoch-boundary generation records the POST-reset iterator
    state (a reshuffling iterator has drawn the next epoch's schedule
    when the snapshot is taken)."""
    prefix = str(tmp_path / "ck")
    cfg = mt.elastic.ElasticConfig(prefix, every_n_steps=0, sync=True)
    _fit(mt, num_epoch=1, elastic=cfg)
    esnap = _esnap(mt)
    man = esnap.latest_manifest(prefix)
    assert man["cursor"]["epoch_boundary"] is True
    assert man["iterator"]["supported"] is True
    state = mt.elastic.ResumeState(man, esnap.load_arrays(man))
    # post-reset NDArrayIter cursor: one batch BEFORE the first
    assert state.iterator_state()["cursor"] == -64


def test_resume_adam_counters(mt, tmp_path):
    """Adam's bias correction reads the per-index update counts: the
    exact resumed weights prove the counters round-tripped."""
    _assert_resume_parity(mt, tmp_path, optimizer="adam",
                          opt_params={"learning_rate": 0.003})


# ------------------------------------------------------- atomicity / files
def _job(mt, prefix, gen, value, keep=2):
    esnap = _esnap(mt)
    return esnap.SnapshotJob(
        "generation", {"arg:w": np.full(4, value, "f4")}, prefix=prefix,
        generation=gen, keep=keep,
        manifest={"format": esnap.FORMAT,
                  "cursor": {"epoch": 0, "nbatch": gen, "global_step": gen}})


def test_generation_pointer_and_prune(mt, tmp_path):
    esnap = _esnap(mt)
    prefix = str(tmp_path / "run")
    w = esnap.writer()
    for g in (1, 2, 3, 4):
        w.submit(_job(mt, prefix, g, g))
    w.flush()
    man = esnap.latest_manifest(prefix)
    assert man["_generation"] == 4
    assert esnap.load_arrays(man)["arg:w"][0] == 4.0
    assert esnap.list_generations(prefix) == [3, 4]  # keep=2 pruned 1, 2


def test_torn_generation_falls_back(mt, tmp_path):
    """A generation whose data file is torn (or missing) must not load —
    the previous generation does."""
    esnap = _esnap(mt)
    prefix = str(tmp_path / "run")
    w = esnap.writer()
    w.submit(esnap.SnapshotJob(
        "generation", {"arg:w": np.arange(4, dtype="f4")}, prefix=prefix,
        generation=1,
        manifest={"format": esnap.FORMAT,
                  "cursor": {"epoch": 0, "nbatch": 0, "global_step": 1}}))
    w.flush()
    base = esnap.data_basename(prefix, 2)
    with open(str(tmp_path / base), "wb") as f:
        f.write(b"MXTPU001\x00")  # truncated mid-header
    man2 = {"format": esnap.FORMAT,
            "cursor": {"epoch": 0, "nbatch": 1, "global_step": 2},
            "data_files": {base: {"bytes": 9999}}}
    with open(esnap.manifest_path(prefix, 2), "w") as f:
        json.dump(man2, f)
    with open(esnap.pointer_path(prefix), "w") as f:
        json.dump({"format": esnap.FORMAT, "generation": 2,
                   "manifest": os.path.basename(
                       esnap.manifest_path(prefix, 2))}, f)
    man = esnap.latest_manifest(prefix)
    assert man is not None and man["_generation"] == 1
    np.testing.assert_array_equal(esnap.load_arrays(man)["arg:w"],
                                  np.arange(4, dtype="f4"))


def test_writer_killed_mid_serialize_keeps_previous(mt, tmp_path,
                                                    monkeypatch):
    """The writer dies inside the data serialize: the tmp file may be
    torn but no manifest/pointer flips — the previous generation loads
    and the error is counted, not raised into training."""
    esnap = _esnap(mt)
    reg = mt.telemetry.registry()
    prefix = str(tmp_path / "run")
    w = esnap.writer()
    w.submit(_job(mt, prefix, 1, 1.0))
    w.flush()

    def _die(path, arrays):
        with open(path, "wb") as f:
            f.write(b"MXTPU0")      # partial magic, then "power loss"
        raise OSError("simulated writer death mid-serialize")

    monkeypatch.setattr(esnap, "_write_ndsave_atomic", _die)
    errs0 = reg.counter("elastic_snapshot_errors").value
    w.submit(_job(mt, prefix, 2, 2.0))
    w.flush()
    monkeypatch.undo()
    assert reg.counter("elastic_snapshot_errors").value == errs0 + 1
    man = esnap.latest_manifest(prefix)
    assert man["_generation"] == 1
    assert esnap.load_arrays(man)["arg:w"][0] == 1.0


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_writer_killed_at_fsync_rename_keeps_previous(mt, tmp_path):
    """``kind=kill`` at ``elastic.snapshot.fsync_rename``: the writer
    thread dies between the data file's tmp write and its rename. The
    generation is counted lost, the pointer still names the previous
    one, which loads, and the writer respawns for the next job."""
    esnap = _esnap(mt)
    reg = mt.telemetry.registry()
    prefix = str(tmp_path / "run")
    w = esnap.writer()
    w.submit(_job(mt, prefix, 1, 1.0))
    w.flush()
    lost0 = reg.counter("elastic_write_failures").value
    with mt.faults.scope("elastic.snapshot.fsync_rename:kind=kill"):
        w.submit(_job(mt, prefix, 2, 2.0))
        assert w.flush(timeout=30)
    assert reg.counter("elastic_write_failures").value == lost0 + 1
    assert os.path.exists(str(tmp_path / esnap.data_basename(prefix, 2))
                          + ".tmp")
    man = esnap.latest_manifest(prefix)
    assert man["_generation"] == 1
    assert esnap.load_arrays(man)["arg:w"][0] == 1.0
    w.submit(_job(mt, prefix, 3, 3.0))
    w.flush(timeout=30)
    assert esnap.latest_manifest(prefix)["_generation"] == 3


# ----------------------------------------------------------- supervision
def test_watchdog_action_hook_fires_after_postmortem(mt):
    diag = mt.diagnostics
    seen = []
    diag.add_action(seen.append)
    try:
        wd = diag.Watchdog(interval=0.01, engine_stall_s=0.02,
                           wait_stall_s=99, engine_probe=lambda: (3, 7))
        t0 = time.monotonic()
        while not seen and time.monotonic() - t0 < 3.0:
            time.sleep(0.03)
            wd.check()
    finally:
        diag.remove_action(seen.append)
    assert seen and "engine stalled" in seen[0]
    pm = diag.last_postmortem()
    assert pm is not None and pm["source"] == "watchdog"


def test_watchdog_restore_retry_end_to_end(mt, tmp_path):
    """A fit wedged mid-flight is detected by the watchdog, aborted at
    the next step boundary, restored from the last durable generation,
    retried, and completes — and the final numbers equal an
    uninterrupted fit's."""
    prefix = str(tmp_path / "ck")
    m_full, w_full, _ = _fit(mt)

    wedge = {"on": False}
    wd = mt.diagnostics.Watchdog(
        interval=0.01, engine_stall_s=0.03, wait_stall_s=99,
        engine_probe=lambda: (3, 7) if wedge["on"] else (0, 0)).start()
    sup = mt.elastic.Supervisor(retries=2, backoff_s=0.05)
    cfg = mt.elastic.ElasticConfig(prefix, every_n_steps=1, sync=True,
                                   supervisor=sup)
    mod = _module(mt)
    metric = mt.metric.create(["acc", "ce"])
    attempts = []

    def fit_fn(resume):
        attempts.append(resume)
        if len(attempts) == 1:
            def cb(param):
                if param.nbatch == 2:     # wedge mid-epoch, attempt 1
                    wedge["on"] = True
                    time.sleep(0.2)       # let the watchdog sample it
        else:
            wedge["on"] = False
            cb = None
        mt.random.seed(11)
        np.random.seed(11)
        mod.fit(_make_iter(mt), num_epoch=2, eval_metric=metric,
                optimizer="sgd",
                optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
                initializer=mt.initializer.Xavier(),
                batch_end_callback=cb, metric_sync=2,
                elastic=cfg, resume=resume)

    try:
        sup.run(fit_fn)
    finally:
        wd.stop()
    assert attempts == [False, True]
    assert sup.retries_done == 1
    assert m_full["accuracy"] == dict(metric.get_name_value())["accuracy"]
    w_sup = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    for k in w_full:
        np.testing.assert_array_equal(w_full[k], w_sup[k], err_msg=k)


def test_supervisor_gives_up_after_bounded_retries(mt):
    sup = mt.elastic.Supervisor(retries=2, backoff_s=0.0)
    calls = []

    def always_wedged(resume):
        calls.append(resume)
        raise mt.elastic.WedgeAbort("synthetic wedge")

    with pytest.raises(mt.elastic.WedgeAbort):
        sup.run(always_wedged)
    assert calls == [False, True, True]     # 1 try + 2 bounded retries


def test_sigterm_flushes_final_snapshot_then_resume(mt, tmp_path):
    """SIGTERM as a preemption warning: the handler flags, the fit
    flushes a FINAL durable snapshot at the next step boundary and
    raises Preempted; a later fit(resume=) continues from it."""
    esnap = _esnap(mt)
    prefix = str(tmp_path / "ck")
    sup = mt.elastic.Supervisor()
    assert sup.install_sigterm()
    cfg = mt.elastic.ElasticConfig(prefix, supervisor=sup)  # no cadence

    def cb(param):
        if param.nbatch == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    mod = _module(mt)
    mt.random.seed(11)
    np.random.seed(11)
    try:
        with pytest.raises(mt.elastic.Preempted):
            mod.fit(_make_iter(mt), num_epoch=2, optimizer="sgd",
                    optimizer_params={"learning_rate": 0.05},
                    initializer=mt.initializer.Xavier(),
                    batch_end_callback=cb, elastic=cfg)
    finally:
        sup.uninstall_sigterm()
    man = esnap.latest_manifest(prefix)
    assert man is not None and man["cursor"]["global_step"] == 3
    metric = mt.metric.create(["acc", "ce"])
    mod2 = _module(mt)
    mt.random.seed(11)
    np.random.seed(11)
    mod2.fit(_make_iter(mt), num_epoch=2, eval_metric=metric,
             optimizer="sgd", optimizer_params={"learning_rate": 0.05},
             initializer=mt.initializer.Xavier(), resume=prefix)
    assert metric.get_name_value()


def test_supervisor_run_restores_the_sigterm_handler(mt, tmp_path):
    """The handler is process-wide: ``run`` holds it only while it runs
    and puts the previous one back on every exit path — a normal
    return, a preemption and a give-up."""
    def mine(sig, frame):
        pass
    signal.signal(signal.SIGTERM, mine)
    sup = mt.elastic.Supervisor(retries=0, backoff_s=0.0)
    inside = []
    sup.run(lambda resume: inside.append(signal.getsignal(signal.SIGTERM)))
    assert inside[0] is not mine and signal.getsignal(signal.SIGTERM) is mine

    def preempted(resume):
        raise mt.elastic.Preempted("synthetic")

    def wedged(resume):
        raise mt.elastic.WedgeAbort("synthetic")
    for fn, exc in ((preempted, mt.elastic.Preempted),
                    (wedged, mt.elastic.WedgeAbort)):
        with pytest.raises(exc):
            sup.run(fn)
        assert signal.getsignal(signal.SIGTERM) is mine
    assert sup.retries_done == 1


# ------------------------------------------------- epoch checkpoints / io
def test_epoch_checkpoint_callbacks_ride_async_writer(mt, tmp_path):
    """module_checkpoint/do_checkpoint go through the snapshot writer:
    fit never hands the elastic-aware callback host params (set_params
    spy), and the files load back equal to the live weights."""
    prefix_m = str(tmp_path / "modck")
    prefix_d = str(tmp_path / "dock")
    mod = _module(mt)
    set_calls = []
    orig = mod.set_params
    mod.set_params = lambda *a, **k: (set_calls.append(1),
                                      orig(*a, **k))[1]
    get_calls = []
    orig_get = mod.get_params
    mod.get_params = lambda *a, **k: (get_calls.append(1),
                                      orig_get(*a, **k))[1]
    mt.random.seed(11)
    np.random.seed(11)
    mod.fit(_make_iter(mt), num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.05},
            initializer=mt.initializer.Xavier(),
            epoch_end_callback=mt.callback.module_checkpoint(
                mod, prefix_m, save_optimizer_states=True))
    assert mod._fused is not None
    assert not set_calls and not get_calls, \
        "fit round-tripped params for an elastic-aware checkpoint callback"
    mt.model.wait_checkpoints()
    sym, args, auxs = mt.model.load_checkpoint(prefix_m, 2)
    live = orig_get()[0]
    for k, v in args.items():
        np.testing.assert_array_equal(v.asnumpy(), live[k].asnumpy(),
                                      err_msg=k)
    man = json.load(open(prefix_m + "-0002.params.manifest.json"))
    assert man["format"] == "mxtpu-checkpoint-1"
    assert sorted(args) == man["params"]
    mod.load_optimizer_states(prefix_m + "-0002.states")

    mod2 = _module(mt)
    mt.random.seed(11)
    np.random.seed(11)
    mod2.fit(_make_iter(mt), num_epoch=1, optimizer="sgd",
             optimizer_params={"learning_rate": 0.05},
             initializer=mt.initializer.Xavier(),
             epoch_end_callback=mt.callback.do_checkpoint(prefix_d))
    assert mod2._fused is not None
    mt.model.wait_checkpoints()
    _, args2, _ = mt.model.load_checkpoint(prefix_d, 1)
    live2 = mod2.get_params()[0]
    for k, v in args2.items():
        np.testing.assert_array_equal(v.asnumpy(), live2[k].asnumpy(),
                                      err_msg=k)


def test_ndarrayiter_cursor_roundtrip(mt):
    """The shuffle permutation travels with the cursor: a freshly
    constructed (differently shuffled) iterator restored from the state
    yields the exact continuation of the original stream."""
    X, y = _mnist_like(n=96)
    np.random.seed(3)
    it1 = mt.io.NDArrayIter(X, y, batch_size=16, shuffle=True)
    batches = []
    for i, b in enumerate(it1):
        if i == 2:
            state = it1.checkpoint_state()
        batches.append(b.data[0].asnumpy())
    np.random.seed(99)  # a resumed process draws a different shuffle
    it2 = mt.io.NDArrayIter(X, y, batch_size=16, shuffle=True)
    assert it2.restore_state(state)
    for want in batches[3:]:
        got = next(it2).data[0].asnumpy()
        np.testing.assert_array_equal(want, got)
    it3 = mt.io.NDArrayIter(X[:32], y[:32], batch_size=16, shuffle=True)
    assert not it3.restore_state(state)


def test_bucket_sentence_iter_cursor_roundtrip(mt):
    import random as pyrandom
    sent = [[i % 17 + 1] * (3 + i % 5) for i in range(60)]
    pyrandom.seed(5)
    np.random.seed(5)
    it1 = mt.rnn.BucketSentenceIter(sent, batch_size=4, buckets=[4, 8])
    firsts = []
    for i, b in enumerate(it1):
        if i == 1:
            state = it1.checkpoint_state()
        firsts.append((b.bucket_key, b.data[0].asnumpy()))
    pyrandom.seed(77)
    np.random.seed(77)
    it2 = mt.rnn.BucketSentenceIter(sent, batch_size=4, buckets=[4, 8])
    assert it2.restore_state(state)
    for want_key, want in firsts[2:]:
        got = next(it2)
        assert got.bucket_key == want_key
        np.testing.assert_array_equal(want, got.data[0].asnumpy())


def test_snapshot_series_emitted(mt, tmp_path):
    reg = mt.telemetry.registry()
    prefix = str(tmp_path / "ck")
    cfg = mt.elastic.ElasticConfig(prefix, every_n_steps=2, sync=True)
    b0 = reg.counter("elastic_snapshot_bytes").value
    s0 = reg.histogram("elastic_snapshot_stall_ms").count
    n0 = reg.counter("elastic_snapshots", labels={"kind": "step"}).value
    w0 = reg.histogram("elastic_snapshot_write_ms").count
    _fit(mt, num_epoch=1, elastic=cfg)
    assert reg.counter("elastic_snapshot_bytes").value > b0
    assert reg.histogram("elastic_snapshot_stall_ms").count > s0
    assert reg.counter("elastic_snapshots",
                       labels={"kind": "step"}).value == n0 + 2
    assert reg.histogram("elastic_snapshot_write_ms").count > w0
    assert reg.gauge("elastic_snapshot_age_s").value >= 0.0


# ------------------------------------------------------ across the packages
def _live_state(mod):
    """{key: numpy} of a fused port module as a generation names them."""
    from mxtpu_torch.module.fused import state_leaves
    arg, aux = mod.get_params()
    out = {"arg:%s" % k: v.asnumpy() for k, v in arg.items()}
    out.update({"aux:%s" % k: v.asnumpy() for k, v in aux.items()})
    for n, st in mod._fused.opt_state[0].items():
        for i, leaf in enumerate(state_leaves(st)):
            out["opt:%s/%d" % (n, i)] = leaf.numpy()
    return out


def test_generations_cross_between_the_packages(mt, tmp_path):
    """mxtpu's ``elastic.load_arrays`` reads a port generation's params
    and optimizer leaves bit for bit (they are the live values at the
    kill), and the port's reads mxtpu's generation as mxtpu does."""
    from mxtpu.elastic import snapshot as mx_snap
    prefix = str(tmp_path / "pt")
    cfg = mt.elastic.ElasticConfig(prefix, every_n_steps=1, sync=True)
    _, _, mod = _fit(mt, kill_at_step=3, elastic=cfg, optimizer="adam",
                     opt_params={"learning_rate": 0.003})
    live = _live_state(mod)
    mine = _esnap(mt).load_arrays(_esnap(mt).latest_manifest(prefix))
    man = mx_snap.latest_manifest(prefix)
    theirs = mx_snap.load_arrays(man)
    assert man["format"] == "mxtpu-elastic-1"
    assert man["opt_format"] == "leaves"
    assert man["opt_entries"]["fc1_weight"]["leaves"] == 2
    for k, v in live.items():
        np.testing.assert_array_equal(theirs[k], v, err_msg=k)
        np.testing.assert_array_equal(mine[k], v, err_msg=k)
    assert sorted(mine) == sorted(theirs)

    prefix = str(tmp_path / "mx")
    cfg = mx.elastic.ElasticConfig(prefix, every_n_steps=1, sync=True)
    _fit(mt, pkg=mx, kill_at_step=3, elastic=cfg, optimizer="adam",
         opt_params={"learning_rate": 0.003})
    want = mx_snap.load_arrays(mx_snap.latest_manifest(prefix))
    got = _esnap(mt).load_arrays(_esnap(mt).latest_manifest(prefix))
    assert sorted(got) == sorted(want) and "rng:key" in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_resume_from_an_mxtpu_generation_raises(mt, tmp_path):
    """An mxtpu generation carries its JAX key, not the port's generator
    states: resuming from one raises, saying so."""
    prefix = str(tmp_path / "mx")
    cfg = mx.elastic.ElasticConfig(prefix, every_n_steps=1, sync=True)
    _fit(mt, pkg=mx, kill_at_step=2, elastic=cfg)
    with pytest.raises(mt.MXNetError, match="JAX key"):
        _fit(mt, resume=prefix)


def test_async_states_pickle_loads_in_both_packages(mt, tmp_path):
    """``save_optimizer_states(async_write=True)`` of the port's fused
    step loads in mxtpu's ``load_optimizer_states`` and back, bit for
    bit, and mxtpu's async pickle loads in the port's."""
    _, _, mod = _fit(mt, num_epoch=1, optimizer="adam",
                     opt_params={"learning_rate": 0.003})
    fname = str(tmp_path / "pt.states")
    mod.save_optimizer_states(fname, async_write=True)
    want = mod._fused.export_opt_state()
    _, _, mx_mod = _fit(mt, pkg=mx, num_epoch=1, optimizer="adam",
                        opt_params={"learning_rate": 0.003})
    mx_mod.load_optimizer_states(fname)
    got = mx_mod._fused.export_opt_state()
    assert sorted(got) == sorted(want)
    for idx in want:
        for a, b in zip(got[idx], want[idx]):
            np.testing.assert_array_equal(a, b, err_msg=str(idx))
    fname = str(tmp_path / "mx.states")
    mx_mod.save_optimizer_states(fname, async_write=True)
    mx.model.wait_checkpoints()
    mine = _module(mt)
    mine.bind(data_shapes=[("data", (64, 784))],
              label_shapes=[("softmax_label", (64,))])
    mine.init_params(initializer=mt.initializer.Xavier())
    mine.init_optimizer(optimizer="adam",
                        optimizer_params={"learning_rate": 0.003})
    mine.load_optimizer_states(fname)
    back = mine._fused.export_opt_state()
    for idx in want:
        for a, b in zip(back[idx], got[idx]):
            np.testing.assert_array_equal(a, b, err_msg=str(idx))


def test_sharded_async_states_round_trip_without_gathering(mt, tmp_path):
    """Under a plan that keeps state by rows, the async ``.states`` is
    mxtpu's sharded manifest with each replica's row block; it loads
    back into the plan bit for bit, and a one-context Module assembles
    it to the full leaves."""
    _, _, mod = _fit(mt, num_epoch=1, mesh=_cpu_mesh(mt))
    fused = mod._fused
    fname = str(tmp_path / "mesh.states")
    mod.save_optimizer_states(fname, async_write=True)
    mt.model.wait_checkpoints()
    man = json.load(open(fname))
    assert man["format"] == "mxtpu-opt-states-sharded-1"
    assert len(man["entries"]["fc1_weight"]["shards"]["0"]["pieces"]) == 4
    want = fused.export_opt_state()
    before = [{k: v.clone() for k, v in st.items()}
              for st in fused.opt_state]
    for st in fused.opt_state:
        for v in st.values():
            v.zero_()
    mod.load_optimizer_states(fname)
    import torch
    for st, old in zip(fused.opt_state, before):
        for k in old:
            assert torch.equal(st[k], old[k]), k
    one = _module(mt)
    one.bind(data_shapes=[("data", (64, 784))],
             label_shapes=[("softmax_label", (64,))])
    one.init_params(initializer=mt.initializer.Xavier())
    one.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.05, "momentum": 0.9})
    one.load_optimizer_states(fname)
    got = one._fused.export_opt_state()
    for idx in want:
        np.testing.assert_array_equal(got[idx], want[idx])
