"""The port's paged decode (``PagedArena``, ``attn_step_symbol`` /
``attn_prefill_symbol``, ``DecodeSession`` in the ``rows`` and ``kv``
layouts, ``TokenStream``, ``POST /v1/generate?stream=1``) held to
mxtpu's on the CPU, twins of tests/test_decode_paged.py:

* the paged arena: the ledger's ``decode_kv`` at live blocks x block
  bytes at every transition; the free lists exact; ``gather_view``,
  ``gather_rows`` and ``scatter_rows`` give mxtpu's arena's values
  exactly, pad rows and pad blocks included (the port drops pad rows on
  the host and clamps the gathers' indices, where XLA drops and clips);
* the attention step and prefill graphs are mxtpu's symbols with mxtpu's
  parameter names, their outputs mxtpu's within ``STEP_RTOL``/
  ``STEP_ATOL``; the kv session's tokens are mxtpu's session's, greedy
  and sampled;
* joined equals alone; NaN in every block leaves the tokens as they
  were (padded blocks are select-masked, never multiplied); a long
  prompt never stalls decode when chunked and does unchunked; the
  chunk pricing; the KV budget at submit; the chaos and evict gates
  leak no block; the stream's events equal the result, a failure closes
  the stream; HTTP streaming and its error taxonomy; the debug panel.

Every wait is bounded; the port runs on ``cpu()``.
"""
import http.client
import json
import threading
import time

import numpy as np
import pytest

import mxtpu as mx
from mxtpu.serving import DecodeSession as MxDecodeSession
from mxtpu.serving import PagedArena as MxPagedArena
from mxtpu.serving.decode import model as mx_model

#: the attention graphs' outputs against mxtpu's on the same weights and
#: inputs: the same ops summing f32 in other orders (relative, absolute)
STEP_RTOL, STEP_ATOL = 1e-5, 1e-6

REQS = [([3, 5], 5, 0, 0.0), ([2], 6, 1, 0.5), ([7, 8, 9], 4, 2, 0.5),
        ([4], 5, 3, 0.0), ([6, 2], 3, 4, 0.9)]
KV_REQS = [([1, 2, 3, 4, 5], 5, 0, 0.0), ([3, 1], 5, 1, 0.5),
           ([2, 2, 2, 2, 2, 2, 2], 4, 2, 0.5), ([4], 6, 3, 0.9)]


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(2)
    import mxtpu_torch
    return mxtpu_torch


_ATTN = {}


def _attn(mt, seed=0):
    if seed not in _ATTN:
        _ATTN[seed] = mt.serving.decode.attn_decode_fixture(seed=seed)
    return _ATTN[seed]


def _kv_session(mt, seed=0, **kwargs):
    fx = _attn(mt, seed)
    kwargs.setdefault("buckets", (2,))
    kwargs.setdefault("slot_capacity", 2)
    kwargs.setdefault("prefill_chunk_tokens", 2)
    kwargs.setdefault("prefill_buckets", (2,))
    kwargs.setdefault("version_tag", "ptkv-v%d" % seed)
    kwargs.setdefault("contexts", [mt.cpu()])
    return mt.serving.DecodeSession(fx["step_symbol_json"], fx["params"],
                                    fx["step_example_shapes"], [],
                                    arena="paged", paged=fx, **kwargs)


def _run_joined(sess, reqs):
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
    return [r["tokens"] for r in res]


def _alone(sess, reqs):
    return [sess.generate(p, max_new_tokens=m, seed=s, temperature=t,
                          timeout=60)["tokens"] for p, m, s, t in reqs]


def _host(x):
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# -------------------------------------------------------- the arena
def test_paged_arena_ledger_exact_and_free_list(mt):
    led = mt.diagnostics.ledger()
    base = led.live_bytes(origin="decode_kv")
    specs = [{"name": "k", "shape": (2, 4), "dtype": "float32"},
             {"name": "v", "shape": (2, 4), "dtype": "float32"}]
    with mt.serving.PagedArena(2, 4, 5, 3, specs, ctx=mt.cpu()) as a:
        assert a.block_bytes == 256
        s0, s1 = a.allocate(), a.allocate()
        assert a.allocate() is None
        assert a.ensure_tokens(s0, 5) == 2
        assert a.ensure_tokens(s1, 4) == 1
        assert a.ensure_tokens(s1, 3) == 0
        assert a.blocks_live == 3
        assert led.live_bytes(origin="decode_kv") == base + 3 * 256
        with pytest.raises(mt.MXNetError):
            a.ensure_tokens(s1, 13)
        a.ensure_tokens(s1, 12)
        assert a.blocks_live == 5
        with pytest.raises(mt.MXNetError):
            a.ensure_tokens(s0, 9)
        a.release(s1)
        assert a.blocks_live == 2 and a.blocks_free == 3
        assert led.live_bytes(origin="decode_kv") == base + 2 * 256
        a.release(s0)
        assert a.blocks_free == a.blocks_total
        assert led.live_bytes(origin="decode_kv") == base
        assert a.state_bytes() == 5 * 256
    assert led.live_bytes(origin="decode_kv") == base


def test_paged_arena_moves_equal_mxtpus(mt):
    """The same block growth, row scatters (pad rows at the out-of-range
    flat index), views (pad table entries, ``None`` slots) and row
    gathers (fresh and pad rows zeroed) through both arenas."""
    import jax
    specs = [{"name": "k", "shape": (2, 3), "dtype": "float32"},
             {"name": "v", "shape": (2, 3), "dtype": "float32"}]
    mine = mt.serving.PagedArena(3, 2, 6, 3, specs, ctx=mt.cpu())
    theirs = MxPagedArena(3, 2, 6, 3, specs)
    rng = np.random.RandomState(0)
    for a in (mine, theirs):
        slots = [a.allocate(), a.allocate(), a.allocate()]
        a.ensure_tokens(slots[0], 5)
        a.ensure_tokens(slots[1], 2)
        a.ensure_tokens(slots[2], 1)
    assert mine.block_table([0, 1, None, 2]).tolist() == \
        theirs.block_table([0, 1, None, 2]).tolist()
    for step in range(3):
        flat = [mine.flat_index(0, step), mine.flat_index(1, step % 2),
                mine.pad_flat_index, mine.flat_index(2, 0)]
        assert flat == [theirs.flat_index(0, step),
                        theirs.flat_index(1, step % 2),
                        theirs.pad_flat_index, theirs.flat_index(2, 0)]
        rows = [rng.randn(4, 2, 3).astype(np.float32) for _ in range(2)]
        mine.scatter_rows(np.array(flat, np.int32), rows)
        theirs.scatter_rows(np.array(flat, np.int32), rows)
    for a_, b_ in zip(mine.gather_view([0, None, 2, 1]),
                      jax.device_get(theirs.gather_view([0, None, 2, 1]))):
        # table padding views the last block (clamped here, clipped
        # there): the same garbage by design
        np.testing.assert_array_equal(_host(a_), np.asarray(b_))
    idx = np.array([mine.flat_index(0, 1), mine.pad_flat_index,
                    mine.flat_index(1, 0)], np.int32)
    fresh = np.array([0, 1, 1], np.float32)
    for a_, b_ in zip(mine.gather_rows(idx, fresh),
                      jax.device_get(theirs.gather_rows(idx, fresh))):
        np.testing.assert_array_equal(_host(a_), np.asarray(b_))
    mine.close()
    theirs.close()


def test_paged_rows_byte_identity_with_contiguous_slots(mt):
    sym, params, shapes, names, _ = mt.serving.decode.lm_decode_fixture()
    out = {}
    for arena in ("slots", "paged"):
        with mt.serving.DecodeSession(
                sym, params, shapes, names, buckets=(4,), slot_capacity=2,
                arena=arena, contexts=[mt.cpu()],
                version_tag="ptr-%s" % arena) as sess:
            out[arena] = _run_joined(sess, REQS)
            assert sess.metrics.counter(
                "decode_steps_with_admittable_waiting").value == 0
    assert out["paged"] == out["slots"]


# ------------------------------------------------ the attention graphs
def _feed(mt, fx, which, bucket, rng):
    shapes = fx["%s_example_shapes" % which]
    axes = fx["prefill_bucket_axes"] if which == "prefill" else {}
    feed = {}
    for name, shape in shapes.items():
        shape = list(shape)
        for a in axes.get(name, (0,)):
            shape[a] = bucket
        if name == "data":
            feed[name] = rng.randint(0, 16, shape).astype(np.float32)
        elif name.startswith("kv_"):
            feed[name] = rng.randn(*shape).astype(np.float32)
        else:
            feed[name] = (rng.rand(*shape) > 0.4).astype(np.float32)
    if which == "prefill":
        feed["attn_mask_chunk"] = np.tril(np.ones((bucket, bucket),
                                                  np.float32))
    return feed


@pytest.mark.parametrize("which", ["step", "prefill"])
def test_attention_graphs_are_mxtpus(mt, which):
    """mxtpu's graph node for node, mxtpu's parameter names (its weights
    bind through ``params_from_mxtpu``: no decode converter), and its
    outputs within STEP_RTOL/STEP_ATOL on the same inputs."""
    mfx = mx_model.attn_decode_fixture(num_layers=2, seed=4)
    pfx = mt.serving.decode.attn_decode_fixture(num_layers=2, seed=4)
    sj = pfx["%s_symbol_json" % which]
    mine, theirs = mt.sym.load_json(sj), \
        mx.sym.load_json(mfx["%s_symbol_json" % which])
    assert mine.list_arguments() == theirs.list_arguments()
    assert [n["op"] for n in json.loads(mine.tojson())["nodes"]] == \
        [n["op"] for n in json.loads(theirs.tojson())["nodes"]]
    assert pfx["kv_specs"] == mfx["kv_specs"]
    for k, v in mfx["params"].items():
        np.testing.assert_array_equal(pfx["params"][k], v.asnumpy())
    feed = _feed(mt, mfx, which, 3, np.random.RandomState(1))
    shapes = {k: v.shape for k, v in feed.items()}
    p_mt = mt.Predictor(sj, mt.convert.params_from_mxtpu(mfx["params"],
                                                         mt.cpu()),
                        ctx=mt.cpu(), input_shapes=shapes)
    p_mx = mx.predict.Predictor(mfx["%s_symbol_json" % which],
                                mfx["params"], input_shapes=shapes)
    p_mt.forward(**feed)
    p_mx.forward(**feed)
    for i, a in enumerate(p_mt.get_outputs()):
        np.testing.assert_allclose(a, p_mx.get_output(i), rtol=STEP_RTOL,
                                   atol=STEP_ATOL)


def test_kv_tokens_equal_mxtpus(mt):
    """The kv session's tokens for the same requests (chunked prefill and
    paged attention) equal mxtpu's session's, greedy and sampled."""
    fx = mx_model.attn_decode_fixture()
    with MxDecodeSession(fx["step_symbol_json"], fx["params"],
                         fx["step_example_shapes"], [], buckets=(2,),
                         slot_capacity=2, prefill_chunk_tokens=2,
                         prefill_buckets=(2,), arena="paged", paged=fx,
                         contexts=[mx.cpu()], version_tag="mxkv") as s:
        theirs = _alone(s, KV_REQS)
    with _kv_session(mt) as sess:
        assert _alone(sess, KV_REQS) == theirs


# ---------------------------------------------------- the kv gates
def test_attn_joined_vs_alone_byte_identity(mt):
    with _kv_session(mt) as sess:
        joined = _run_joined(sess, KV_REQS)
        alone = _alone(sess, KV_REQS)
        assert sess.arena.blocks_free == sess.arena.blocks_total
        assert sess.metrics.counter("decode_prefill_stalls").value == 0
    assert joined == alone


def test_attn_padded_blocks_provably_inert(mt):
    """NaN in every row of the KV pool: the tokens are the clean run's
    (a lane reads only rows written before it, and padded blocks and
    masked scores are replaced with ``where``)."""
    reqs = [([1, 2, 3, 4, 5], 4, 0, 0.0), ([3, 1], 4, 1, 0.5)]
    with _kv_session(mt) as sess:
        clean = _alone(sess, reqs)
        assert sess.arena.blocks_free == sess.arena.blocks_total
        for t in sess.arena._arrays:
            t.fill_(float("nan"))
        poisoned = _alone(sess, reqs)
        joined = _run_joined(sess, reqs)
    assert poisoned == clean and joined == clean


def test_long_prompt_never_stalls_decode_chunked_vs_baseline(mt):
    def run(chunked, tag):
        kwargs = dict(prefill_chunk_tokens=2, version_tag=tag)
        if chunked:
            kwargs["prefill_buckets"] = (2,)
        else:
            kwargs.update(prefill_chunked=False, prefill_buckets=(8,))
        with _kv_session(mt, **kwargs) as sess:
            short = sess.generate_async([1], max_new_tokens=15, timeout=60)
            deadline = time.monotonic() + 30
            while sess.metrics.counter("decode_tokens_total").value < 1 \
                    and time.monotonic() < deadline:
                time.sleep(0.002)
            long = sess.generate_async([1, 2, 3, 4, 5, 6, 7, 8],
                                       max_new_tokens=4, timeout=60)
            a, b = short.wait(60), long.wait(60)
            assert len(a["tokens"]) == 15 and len(b["tokens"]) == 4
            assert sess.metrics.counter(
                "decode_steps_with_admittable_waiting").value == 0
            return (sess.metrics.counter("decode_prefill_stalls").value,
                    sess.metrics.counter("decode_prefill_chunks").value,
                    sess.stats()["decode_ttft_ms"]["count"])

    stalls_c, chunks_c, ttft_c = run(True, "ptkv-chunked")
    stalls_u, chunks_u, _ = run(False, "ptkv-unchunked")
    assert stalls_c == 0
    assert stalls_u >= 1
    assert chunks_c > chunks_u
    assert ttft_c >= 2


def test_prefill_chunk_pricing_math(mt):
    from mxtpu_torch.serving.decode.session import _Sequence
    from mxtpu.serving.decode.session import _Sequence as MxSequence
    for S in (_Sequence, MxSequence):
        s = S(list(range(10)), 6, None, 0, 0.0, None)
        got = [s.remaining_tokens(), s.remaining_tokens(4)]
        s.pos = 8
        got.append(s.remaining_tokens(4))
        s.pos = 10
        s.out_tokens = [1]
        got.append(s.remaining_tokens(4))
        assert got == [16, 8, 6, 5]


def test_paged_knobs_and_kv_budget(mt, monkeypatch):
    with _kv_session(mt, warmup=False, version_tag="ptkv-knob") as sess:
        assert (sess.block_size, sess.max_blocks_per_seq,
                sess.prefill_chunk_tokens) == (4, 4, 2)
        budget = sess.block_size * sess.max_blocks_per_seq
        with pytest.raises(mt.MXNetError):
            sess.generate_async([1] * budget, max_new_tokens=1)
    with _kv_session(mt, warmup=False, kv_blocks=6, max_blocks_per_seq=3,
                     version_tag="ptkv-knob2") as sess:
        assert sess.max_blocks_per_seq == 3 and sess.arena.blocks_total == 6
    monkeypatch.setenv("MXTPU_DECODE_BLOCK_SIZE", "64")
    sym, params, shapes, names, _ = mt.serving.decode.lm_decode_fixture()
    with mt.serving.DecodeSession(sym, params, shapes, names, buckets=(4,),
                                  warmup=False, contexts=[mt.cpu()],
                                  version_tag="ptkv-knob3") as sess:
        assert sess.block_size == 64


# ------------------------------------------------------------- chaos
def test_chaos_prefill_and_block_alloc_leak_nothing(mt):
    led = mt.diagnostics.ledger()
    base = led.live_bytes(origin="decode_kv")
    with _kv_session(mt) as sess:
        with mt.faults.scope("serving.decode.prefill:p=1.0,seed=2,times=3"):
            for _ in range(3):
                with pytest.raises(mt.faults.FaultInjected):
                    sess.generate([1, 2, 3, 4], max_new_tokens=2,
                                  timeout=30)
        with mt.faults.scope(
                "serving.decode.block_alloc:p=1.0,seed=3,times=2"):
            for _ in range(2):
                with pytest.raises(mt.faults.FaultInjected):
                    sess.generate([1, 2], max_new_tokens=2, timeout=30)
        with mt.faults.scope("serving.decode.step:kind=raise,times=1"):
            with pytest.raises(mt.faults.FaultInjected):
                sess.generate([1, 2], max_new_tokens=2, timeout=30)
        assert sess.arena.blocks_free == sess.arena.blocks_total
        assert sess.arena.free_slots == sess.arena.capacity
        assert led.live_bytes(origin="decode_kv") == base
        assert sess.generate([1, 2, 3], max_new_tokens=2,
                             timeout=30)["finish_reason"] == "length"
        assert sess.arena.blocks_free == sess.arena.blocks_total
    assert led.live_bytes(origin="decode_kv") == base


def test_evict_injection_never_leaks_blocks(mt):
    with _kv_session(mt) as sess:
        with mt.faults.scope("serving.decode.evict:p=1.0,seed=1,times=3"):
            for _ in range(3):
                try:
                    sess.generate([1, 2, 3], max_new_tokens=2, timeout=30)
                except mt.faults.FaultInjected:
                    pass
        assert sess.arena.blocks_free == sess.arena.blocks_total
        assert sess.arena.free_slots == sess.arena.capacity


# --------------------------------------------------------- streaming
def test_token_stream_unit(mt):
    from mxtpu.serving.decode import TokenStream as MxTokenStream
    for S in (mt.serving.TokenStream, MxTokenStream):
        s = S()
        s.put({"token": 1, "index": 0})
        s.put({"done": {}})
        s.close()
        s.put({"token": 9, "index": 9})
        assert s.get(1) == {"token": 1, "index": 0}
        assert s.get(1) == {"done": {}}
        assert s.get(1) is None and s.closed
        with pytest.raises(TimeoutError):
            S().get(0.01)


def test_generate_stream_events_match_result(mt):
    with _kv_session(mt) as sess:
        item = sess.generate_async([1, 2, 3, 4, 5], max_new_tokens=4,
                                   stream=True, timeout=60)
        events = list(item.stream.events(timeout=60))
        tokens = [e["token"] for e in events if "token" in e]
        done = [e for e in events if "done" in e]
        assert done and done[0]["done"]["tokens"] == tokens
        assert [e["index"] for e in events if "token" in e] \
            == list(range(len(tokens)))
        assert item.wait(1)["tokens"] == tokens
        stream = sess.generate_stream([1, 2, 3, 4, 5], max_new_tokens=4,
                                      timeout=60)
        again = [e["token"] for e in stream.events(timeout=60)
                 if "token" in e]
        assert again == tokens


def test_stream_closed_on_every_failure_path(mt):
    with _kv_session(mt) as sess:
        with mt.faults.scope("serving.decode.prefill:p=1.0,seed=5,times=1"):
            stream = sess.generate_stream([1, 2, 3, 4], max_new_tokens=2,
                                          timeout=30)
            events = list(stream.events(timeout=30))
        assert events and events[-1]["type"] == "FaultInjected"


def _http_sess(mt):
    sess = _kv_session(mt, version_tag="ptkv-http")
    server = mt.serving.ServingHTTPServer(None, decode=sess, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return sess, server


def _request(server, path, body):
    host, port = server.server_address[:2]
    c = http.client.HTTPConnection(host, port, timeout=60)
    c.request("POST", path, json.dumps(body),
              {"Content-Type": "application/json"})
    return c, c.getresponse()


def test_http_stream_tokens_and_terminal_event(mt):
    sess, server = _http_sess(mt)
    try:
        body = {"prompt": [1, 2, 3, 4, 5], "max_new_tokens": 4, "seed": 1,
                "temperature": 0.5}
        c, r = _request(server, "/v1/generate?stream=1", body)
        assert r.status == 200
        assert r.getheader("Transfer-Encoding") == "chunked"
        assert r.getheader("Content-Type") == "application/x-ndjson"
        lines = [json.loads(line) for line in r if line.strip()]
        c.close()
        tokens = [e["token"] for e in lines if "token" in e]
        assert lines[-1]["done"]["tokens"] == tokens and len(tokens) == 4
        c, r = _request(server, "/v1/generate", body)
        assert r.status == 200
        assert json.loads(r.read())["tokens"] == tokens
        c.close()
        assert tokens == sess.generate([1, 2, 3, 4, 5], max_new_tokens=4,
                                       seed=1, temperature=0.5,
                                       timeout=60)["tokens"]
    finally:
        server.shutdown()


def test_http_stream_error_taxonomy(mt):
    sess, server = _http_sess(mt)
    try:
        c, r = _request(server, "/v1/generate?stream=1", {"prompt": []})
        assert r.status == 400 and "error" in json.loads(r.read())
        c.close()
        c, r = _request(server, "/v1/generate?stream=1",
                        {"prompt": [1] * 20, "max_new_tokens": 4})
        assert r.status == 400
        r.read()
        c.close()
        c, r = _request(server, "/v1/generate?stream=1",
                        {"prompt": [1] * 8, "max_new_tokens": 8,
                         "timeout_sec": 0.0005})
        assert r.status == 200
        lines = [json.loads(line) for line in r if line.strip()]
        c.close()
        assert lines and lines[-1].get("type") == "TimeoutError"
    finally:
        server.shutdown()


def test_debug_panel_kv_block(mt):
    with _kv_session(mt) as sess:
        sess.generate([1, 2, 3], max_new_tokens=2, timeout=30)
        panel = sess.debug_panel()
        assert panel["arena"] == "kv"
        assert panel["kv"]["blocks_total"] == sess.arena.blocks_total
        assert panel["kv"]["live_kv_bytes"] == 0
        assert panel["prefill"]["chunk_tokens"] == 2
        assert panel["prefill"]["chunks"] >= 1
        assert panel["prefill"]["stalls"] == 0
