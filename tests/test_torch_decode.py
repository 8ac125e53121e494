"""The port's decode session on the slot arena (``mxtpu_torch.serving.
decode``: ``SequenceSlotArena``, ``lm_step_symbol``, ``DecodeSession``)
held to mxtpu's on the CPU, twins of tests/test_decode.py:

* ``state_spec`` of LSTM/GRU cells and stacks is mxtpu's;
* the arena: slots and the ledger's ``decode_state``; gather and scatter
  give mxtpu's arena's rows exactly (pad rows dropped, fresh rows zeroed,
  a previous occupant's NaN never reaching a fresh sequence);
* the step graph is mxtpu's symbol (its arguments and its nodes' ops in
  order), with mxtpu's parameter names: mxtpu's weights bind through
  ``convert.params_from_mxtpu`` (no decode converter), and its outputs
  are mxtpu's within ``STEP_RTOL``/``STEP_ATOL`` (XLA's f32 sums in other
  orders);
* ``DecodeSession``'s tokens equal mxtpu's ``DecodeSession``'s for the
  same requests, greedy and at seeded temperatures, in the slot and the
  paged-rows layouts;
* joined equals alone; a mid-run swap pins in-flight sequences to their
  version; no step runs with admittable work waiting and a freed slot is
  reused by the next step; the series and the debug panel; length-aware
  admission; the chaos and evict gates leak no slot and leave the
  ledger at its start; the data-plane caps; the knobs; HTTP generate.

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
from mxtpu.serving import DecodeSession as MxDecodeSession
from mxtpu.serving import SequenceSlotArena as MxSlotArena
from mxtpu.serving.decode import model as mx_model

#: the step graph's outputs against mxtpu's on the same weights and
#: inputs: the same ops summing f32 in other orders (relative, absolute)
STEP_RTOL, STEP_ATOL = 1e-5, 1e-6

REQS = [([3, 5], 5, 0, 0.0), ([2], 6, 1, 0.5), ([7, 8, 9], 4, 2, 0.5),
        ([4], 5, 3, 0.0), ([6, 2], 3, 4, 0.9)]


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(2)
    import mxtpu_torch
    return mxtpu_torch


_FIX = {}


def _fixture(mt, seed=0):
    """The port's LM step fixture (its weights are mxtpu's: the same
    draws from the same seed, as host arrays)."""
    if seed not in _FIX:
        _FIX[seed] = mt.serving.decode.lm_decode_fixture(seed=seed)
    return _FIX[seed]


def _session(mt, seed=0, **kwargs):
    sym, params, shapes, state_names, _ = _fixture(mt, seed)
    kwargs.setdefault("buckets", (4,))
    kwargs.setdefault("slot_capacity", 2)
    kwargs.setdefault("version_tag", "pt-v%d" % seed)
    kwargs.setdefault("contexts", [mt.cpu()])
    return mt.serving.DecodeSession(sym, params, shapes, state_names,
                                    **kwargs)


def _run_joined(sess, reqs):
    """The requests from their own threads at once (staggered): they
    join and leave between steps."""
    res = [None] * len(reqs)

    def run(i):
        prompt, max_new, rseed, temp = reqs[i]
        res[i] = sess.generate(prompt, max_new_tokens=max_new, seed=rseed,
                               temperature=temp, timeout=60)

    ts = [threading.Thread(target=run, args=(i,)) for i in range(len(reqs))]
    for j, t in enumerate(ts):
        t.start()
        if j % 2:
            time.sleep(0.003)
    for t in ts:
        t.join(timeout=120)
    assert all(r is not None for r in res), "hung generate waiter"
    return res


def _alone(sess, reqs):
    return [sess.generate(p, max_new_tokens=m, seed=s, temperature=t,
                          timeout=60)["tokens"] for p, m, s, t in reqs]


def _swallow(fn, *a, **kw):
    try:
        fn(*a, **kw)
    except Exception:
        pass


# -------------------------------------------------------------- state_spec
def test_state_spec_is_mxtpus(mt):
    for build in (lambda R: R.LSTMCell(8, prefix="l_"),
                  lambda R: R.GRUCell(5, prefix="g_"),
                  lambda R: _stack(R)):
        mine, theirs = build(mt.rnn), build(mx.rnn)
        assert mine.state_spec(3) == theirs.state_spec(3)
        for a, b in zip(mine.begin_state_arrays(2),
                        theirs.begin_state_arrays(2)):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert not a.any()


def _stack(R):
    s = R.SequentialRNNCell()
    s.add(R.LSTMCell(4, prefix="s0_"))
    s.add(R.GRUCell(6, prefix="s1_"))
    return s


# ------------------------------------------------------------------ arena
def _tiny_specs():
    return [{"name": "h", "shape": (1, 3), "dtype": "float32"},
            {"name": "c", "shape": (1, 3), "dtype": "float32"}]


def test_arena_alloc_release_and_ledger(mt):
    led = mt.diagnostics.ledger()
    base = led.live_bytes(origin="decode_state")
    arena = mt.serving.SequenceSlotArena(3, _tiny_specs(), ctx=mt.cpu())
    assert led.live_bytes(origin="decode_state") == base + 2 * 3 * 3 * 4
    slots = [arena.allocate() for _ in range(3)]
    assert sorted(slots) == [0, 1, 2]
    assert arena.allocate() is None
    assert arena.free_slots == 0 and arena.occupancy == 1.0
    arena.release(slots[1])
    assert arena.allocate() == slots[1]
    with pytest.raises(mt.MXNetError):
        arena.release(99)
    arena.release(slots[0])
    with pytest.raises(mt.MXNetError):
        arena.release(slots[0])
    arena.close()
    assert led.live_bytes(origin="decode_state") == base


def _host(x):
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def test_arena_gather_scatter_equal_mxtpus(mt):
    """The same scatters and gathers through both arenas give the same
    rows: writes land at their slots, pad rows (index == capacity) are
    dropped, fresh and pad rows gather as zeros."""
    import jax
    rows = np.arange(8, dtype=np.float32).reshape(4, 2)[:, :1] \
        * np.ones((4, 3), np.float32)
    new = [rows + 10, rows + 20]
    ops = [("scatter", np.array([0, 1, 2, 3], np.int32), new),
           ("gather", np.array([2, 0, 4], np.int32),
            np.array([0.0, 0.0, 1.0], np.float32)),
           ("scatter", np.array([1, 4], np.int32),
            [np.full((2, 3), -1, np.float32)] * 2),
           ("gather", np.array([1, 0], np.int32), np.zeros(2, np.float32)),
           ("gather", np.array([0], np.int32), np.ones(1, np.float32)),
           ("scatter", np.array([3, 3, 4, 4], np.int32),
            [rows + 7, rows + 9]),
           ("gather", np.array([3, 2, 1, 0], np.int32),
            np.array([0, 1, 0, 0], np.float32))]
    mine = mt.serving.SequenceSlotArena(4, _tiny_specs(), ctx=mt.cpu())
    theirs = MxSlotArena(4, _tiny_specs())
    for op, idx, arg in ops:
        if op == "scatter":
            # duplicate live indices are not a session pattern: keep the
            # last op's rows distinct per live index
            keep = [i for i in range(len(idx))
                    if idx[i] < 4 and list(idx[:i + 1]).count(idx[i]) == 1]
            idx2 = np.where(np.isin(np.arange(len(idx)), keep), idx, 4)
            mine.scatter(idx2.astype(np.int32), arg)
            theirs.scatter(idx2.astype(np.int32), arg)
        else:
            a = [_host(t) for t in mine.gather(idx, arg)]
            b = [np.asarray(t) for t in jax.device_get(
                theirs.gather(idx, arg))]
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    mine.close()
    theirs.close()


def test_arena_fresh_mask_clears_nan_from_previous_occupant(mt):
    arena = mt.serving.SequenceSlotArena(2, _tiny_specs(), ctx=mt.cpu())
    poison = [np.full((2, 3), np.nan, np.float32),
              np.full((2, 3), np.inf, np.float32)]
    arena.scatter(np.array([0, 1], np.int32), poison)
    for leaf in arena.gather(np.array([0, 1], np.int32),
                             np.ones(2, np.float32)):
        leaf = _host(leaf)
        assert np.isfinite(leaf).all() and not leaf.any()
    arena.close()


def test_state_dtype_bf16_halves_arena_bytes(mt):
    with _session(mt, slot_capacity=2) as f32:
        f32_bytes = f32.arena.state_bytes()
        with _session(mt, slot_capacity=2, state_dtype="bfloat16",
                      version_tag="pt-bf16") as bf:
            assert bf.arena.state_bytes() * 2 == f32_bytes
            a = bf.generate([3, 5], max_new_tokens=4, timeout=60)
            b = bf.generate([3, 5], max_new_tokens=4, timeout=60)
            assert a["tokens"] == b["tokens"]


# ------------------------------------------------------- the step graph
def _graph(sym):
    """A graph's arguments and its nodes' ops in topological order (the
    auto-generated node names count the process's earlier symbols)."""
    ops = [n["op"] for n in json.loads(sym.tojson())["nodes"]]
    return sym.list_arguments(), ops


def test_step_symbol_is_mxtpus_and_binds_its_weights(mt):
    """The step graph is mxtpu's symbol, node for node, with mxtpu's
    parameter names: mxtpu's own fixture weights bind through
    ``params_from_mxtpu`` and one step's logits and states are mxtpu's
    executor's within STEP_RTOL/STEP_ATOL."""
    mxsj, mxp, shapes, names, _ = mx_model.lm_decode_fixture(seed=3)
    mine = mt.serving.decode.lm_decode_fixture(seed=3)
    assert _graph(mt.sym.load_json(mine[0])) == \
        _graph(mx.sym.load_json(mxsj))
    assert mine[2] == shapes and mine[3] == names
    for k, v in mxp.items():
        np.testing.assert_array_equal(mine[1][k], v.asnumpy())
    params = mt.convert.params_from_mxtpu(mxp, mt.cpu())
    rng = np.random.RandomState(0)
    feed = {"data": rng.randint(0, 16, (4, 1)).astype(np.float32)}
    for n in names:
        feed[n] = rng.randn(4, *shapes[n][1:]).astype(np.float32)
    batch = {k: v.shape for k, v in feed.items()}
    p_mt = mt.Predictor(mxsj, params, ctx=mt.cpu(), input_shapes=batch)
    p_mx = mx.predict.Predictor(mxsj, mxp, input_shapes=batch)
    p_mt.forward(**feed)
    p_mx.forward(**feed)
    outs = p_mt.get_outputs()
    assert len(outs) == 1 + len(names)
    for i, a in enumerate(outs):
        np.testing.assert_allclose(a, p_mx.get_output(i), rtol=STEP_RTOL,
                                   atol=STEP_ATOL)


# ------------------------------------------------- tokens against mxtpu
def _mx_tokens(reqs, seed=0, **kw):
    sym, params, shapes, names, _ = mx_model.lm_decode_fixture(seed=seed)
    with MxDecodeSession(sym, params, shapes, names, buckets=(4,),
                         slot_capacity=2, contexts=[mx.cpu()],
                         version_tag="mx-v%d" % seed, **kw) as s:
        return _alone(s, reqs)


@pytest.mark.parametrize("arena", ["slots", "paged"])
def test_decode_tokens_equal_mxtpus(mt, arena):
    """The same requests, greedy and at seeded temperatures, give
    mxtpu's tokens: the logits agree within STEP_RTOL and the sampling
    is host f32 numpy from a per-request RandomState in both."""
    with _session(mt, arena=arena, version_tag="pt-%s" % arena) as sess:
        mine = _alone(sess, REQS)
        if arena == "paged":
            assert type(sess.arena).__name__ == "PagedArena"
    assert mine == _mx_tokens(REQS)


# ------------------------------------------------------ correctness gates
def test_correctness_gate_joined_equals_alone(mt):
    with _session(mt, slot_capacity=1, version_tag="pt-alone") as sess:
        alone = _alone(sess, REQS)
    with _session(mt) as sess:
        res = _run_joined(sess, REQS)
        tripped = sess.metrics.counter(
            "decode_steps_with_admittable_waiting").value
    assert [r["tokens"] for r in res] == alone
    assert tripped == 0
    assert max(r["join_step"] for r in res) > 0


def test_correctness_gate_mid_run_swap(mt):
    """In-flight sequences finish on their admission-time version; the
    ones admitted after the swap run the new weights."""
    with _session(mt, slot_capacity=1, version_tag="pt-a1") as s:
        alone_v1 = _alone(s, [([3], 24, 0, 0.0), ([5], 24, 0, 0.0)])
    with _session(mt, seed=9, slot_capacity=1, version_tag="pt-a9") as s:
        alone_v2 = _alone(s, [([4], 6, 0, 0.0)])
    sym2, params2, _, _, _ = _fixture(mt, 9)
    res = [None] * 3
    with _session(mt, slot_capacity=2) as sess:

        def run(i, prompt, n):
            res[i] = sess.generate(prompt, max_new_tokens=n, timeout=120)

        ts = [threading.Thread(target=run, args=(0, [3], 24)),
              threading.Thread(target=run, args=(1, [5], 24))]
        for t in ts:
            t.start()
        deadline = time.monotonic() + 10
        while len(sess._active) < 2 and time.monotonic() < deadline:
            time.sleep(0.002)
        info = sess.swap_model(sym2, params2, version_tag="pt-v9")
        assert info["generation"] == 1
        run(2, [4], 6)
        for t in ts:
            t.join(timeout=120)
    assert [res[0]["version"], res[1]["version"]] == ["pt-v0", "pt-v0"]
    assert res[2]["version"] == "pt-v9"
    assert [res[0]["tokens"], res[1]["tokens"]] == alone_v1
    assert [res[2]["tokens"]] == alone_v2


def test_liveness_gate_zero_idle_steps_and_slot_reuse(mt):
    with _session(mt, slot_capacity=2) as sess:
        res = _run_joined(sess, [([2], 6, 0, 0.0)] * 4)
        tripped = sess.metrics.counter(
            "decode_steps_with_admittable_waiting").value
    assert tripped == 0
    finishes = sorted(r["finish_step"] for r in res)
    late_joins = sorted(r["join_step"] for r in res)[2:]
    assert late_joins == finishes[:2]


def test_join_latency_series_and_panel(mt):
    with _session(mt, slot_capacity=2) as sess:
        sess.generate([2], max_new_tokens=2, timeout=60)
        stats = sess.stats()
        assert stats["decode_steps_total"] == 2
        assert stats["decode_tokens_total"] == 2
        assert stats["decode_join_latency_ms"]["count"] == 1
        assert stats["decode_evictions{reason=length}"] == 1
        assert stats["decode_active_sequences"] == 0
        panel = sess.debug_panel()
        assert panel["slot_capacity"] == 2 and panel["arena"] == "slots"
        assert panel["admission"]["step_cost_basis"] in (
            "cost-rows", "live-steps")
        assert panel["state_bytes"] > 0


def test_admission_gate_length_aware_pricing(mt):
    """Arena full and the queue at the watermark: long remaining
    sequences price the join wait over budget (429, reason "slots"); a
    short mix at the same queue shape admits."""
    def load(max_new):
        sess = _session(mt, slot_capacity=2, join_watermark=1,
                        join_wait_budget_ms=60.0, version_tag="pt-adm")
        threads = [threading.Thread(
            target=lambda: _swallow(sess.generate, [2],
                                    max_new_tokens=max_new, timeout=120))
            for _ in range(3)]
        threads[0].start()
        threads[1].start()
        deadline = time.monotonic() + 10
        while sess.arena.free_slots and time.monotonic() < deadline:
            time.sleep(0.002)
        threads[2].start()
        deadline = time.monotonic() + 10
        while not sess._queue and sess.arena.free_slots == 0 \
                and time.monotonic() < deadline:
            time.sleep(0.002)
        return sess, threads

    sess, threads = load(4000)
    if sess.arena.free_slots == 0:
        with pytest.raises(mt.serving.AdmissionShed) as exc:
            sess.generate_async([5], max_new_tokens=4000)
        assert "slots" in str(exc.value)
        assert sess._sheds_by_reason.get("slots") == 1
        assert sess.stats()["requests_shed{reason=slots}"] == 1
    sess.close(drain=False)
    for t in threads:
        t.join(timeout=30)
    sess, threads = load(2)
    assert sess.generate_async([5], max_new_tokens=2).wait(60)[
        "finish_reason"] == "length"
    sess.close()
    for t in threads:
        t.join(timeout=30)


# -------------------------------------------------------------- chaos
def test_chaos_gate_step_errors_and_kill(mt):
    """Step errors and a worker kill mid-decode: every request resolves,
    the worker respawns, no slot leaks, and the ledger's decode_state is
    back at its start after close."""
    led = mt.diagnostics.ledger()
    base = led.live_bytes(origin="decode_state")
    sess = _session(mt, slot_capacity=2)
    outcomes = []

    def run(i):
        try:
            sess.generate([2 + i % 8], max_new_tokens=6, timeout=30)
            outcomes.append("ok")
        except Exception as exc:
            outcomes.append(type(exc).__name__)

    with mt.faults.scope("serving.decode.step:kind=kill,after=4;"
                         "serving.decode.step:p=0.4,seed=7;"
                         "serving.decode.evict:p=0.3,seed=3"):
        ts = [threading.Thread(target=run, args=(i,)) for i in range(10)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    assert len(outcomes) == 10, "hung waiters under chaos"
    deadline = time.monotonic() + 10
    while sess.metrics.counter("decode_worker_respawns").value < 1 \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    assert sess.metrics.counter("decode_worker_respawns").value >= 1
    deadline = time.monotonic() + 10
    while sess.arena.free_slots < sess.arena.capacity \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    assert sess.arena.free_slots == sess.arena.capacity
    assert sess.generate([3], max_new_tokens=2,
                         timeout=30)["finish_reason"] == "length"
    sess.close()
    assert led.live_bytes(origin="decode_state") == base


def test_evict_injection_never_leaks_slots(mt):
    with _session(mt, slot_capacity=2) as sess:
        with mt.faults.scope("serving.decode.evict:p=1.0,seed=1,times=4"):
            for _ in range(4):
                _swallow(sess.generate, [2], max_new_tokens=1, timeout=30)
        assert sess.arena.free_slots == sess.arena.capacity
        evs = [v for k, v in sess.stats().items()
               if str(k).startswith("decode_evictions")]
        assert sum(evs) >= 4


def test_fail_chunk_preserves_already_finished_results(mt):
    from mxtpu_torch.serving.decode.session import _Sequence
    with _session(mt, slot_capacity=2) as sess:
        done = _Sequence([2], 1, None, 0, 0.0, None)
        done.item.finish({"tokens": [7], "finish_reason": "length"})
        pending = _Sequence([3], 1, None, 0, 0.0, None)
        before = sess.metrics.counter("requests_failed").value
        sess._fail_chunk([done, pending], RuntimeError("step died"))
        assert done.item.wait(1)["tokens"] == [7]
        with pytest.raises(RuntimeError):
            pending.item.wait(1)
        assert sess.metrics.counter("requests_failed").value == before + 1


def test_max_new_tokens_cap_protects_the_data_plane(mt):
    from mxtpu_torch.serving.decode.session import (MAX_NEW_TOKENS_CAP,
                                                    MAX_REQUEST_TOKENS_CAP)
    from mxtpu.serving.decode import session as mx_session
    assert (MAX_NEW_TOKENS_CAP, MAX_REQUEST_TOKENS_CAP) == (
        mx_session.MAX_NEW_TOKENS_CAP, mx_session.MAX_REQUEST_TOKENS_CAP)
    with _session(mt, slot_capacity=1) as sess:
        with pytest.raises(mt.MXNetError):
            sess.generate_async([2], max_new_tokens=MAX_NEW_TOKENS_CAP + 1)
        with pytest.raises(mt.MXNetError):
            sess.generate_async([2] * MAX_REQUEST_TOKENS_CAP,
                                max_new_tokens=1)
        with pytest.raises(mt.MXNetError):
            sess.generate_async([], max_new_tokens=1)


def test_decode_knobs_resolve_through_tune(mt, monkeypatch):
    monkeypatch.setenv("MXTPU_DECODE_SLOTS", "3")
    with _session(mt, slot_capacity=None, warmup=False,
                  version_tag="pt-knob") as sess:
        assert sess.slot_capacity == 3 and sess.arena.capacity == 3
        assert sess.max_new_tokens_default == 32
        assert sess.join_watermark == 4


def test_session_without_contexts_needs_cuda(mt):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    sym, params, shapes, names, _ = _fixture(mt)
    with pytest.raises(mt.MXNetError, match="CUDA"):
        mt.serving.DecodeSession(sym, params, shapes, names)


# ---------------------------------------------------------------- HTTP
def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_generate_roundtrip_and_debug_panel(mt):
    sym, params, shapes, names, _ = _fixture(mt)
    server = mt.serving.serve_decode(
        sym, params, shapes, names, port=0, block=False, buckets=(4,),
        slot_capacity=2, contexts=[mt.cpu()], version_tag="pt-http",
        id2word={i: "w%d" % i for i in range(16)})
    try:
        base = server.endpoint
        code, body = _post(base + "/v1/generate",
                           {"prompt": [3, 5], "max_new_tokens": 5})
        assert code == 200 and body["tokens"] == _mx_tokens(
            [([3, 5], 5, 0, 0.0)])[0]
        assert body["text"].split() == ["w%d" % t for t in body["tokens"]]
        assert _post(base + "/v1/generate", {"prompt": "x"})[0] == 400
        assert _post(base + "/v1/predict", {"inputs": {}})[0] == 404
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            h = json.loads(r.read())
        assert h["mode"] == "decode" and h["version"] == "pt-http"
        with urllib.request.urlopen(base + "/debug/state", timeout=10) as r:
            state = json.loads(r.read())
        assert state["decode"]["slot_capacity"] == 2
        assert state["decode"]["tokens_out"] == 5
    finally:
        server.shutdown()


def test_http_combined_server_exposes_both_sessions(mt):
    from mxtpu_torch.models.serving_fixtures import get_fixture
    sj, p, shp = get_fixture("mlp")
    predict = mt.serving.ServingSession(sj, p, shp, buckets=(1,),
                                        contexts=[mt.cpu()],
                                        version_tag="pt-comb-p")
    decode = _session(mt, version_tag="pt-comb-d")
    server = mt.serving.ServingHTTPServer(predict, port=0, decode=decode)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        base = server.endpoint
        assert _post(base + "/v1/generate",
                     {"prompt": [2], "max_new_tokens": 2})[0] == 200
        x = np.zeros((1, 784), np.float32).tolist()
        assert _post(base + "/v1/predict", {"inputs": {"data": x}})[0] \
            == 200
        with urllib.request.urlopen(base + "/v1/version", timeout=10) as r:
            v = json.loads(r.read())
        assert v["version"] == "pt-comb-p"
        assert v["decode"]["version"] == "pt-comb-d"
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            h = json.loads(r.read())
        assert h["decode"]["version"] == "pt-comb-d"
    finally:
        server.shutdown()
