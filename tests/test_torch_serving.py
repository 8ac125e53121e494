"""The port's serving path on the CPU against mxtpu: a tiny transformer LM
(vocab 32, 2 layers, d_model 32, 4 heads, seq 16) with seeded weights,
carried over by ``convert.params_from_mxtpu``, served by
``mxtpu_torch.serving.ServingSession(contexts=[cpu()])`` and compared
with ``mxtpu.predict.Predictor`` (atol 1e-5 on probabilities); the HTTP
front end on port 0; and the batcher's slicing rules."""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import mxtpu as mx

VOCAB, SEQ, LAYERS, HEADS, D = 32, 16, 2, 4, 32
ATOL = 1e-5


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


@pytest.fixture(scope="module")
def lm():
    """(symbol json, mxtpu params as numpy, mxtpu Predictor at (1, SEQ))."""
    sym = mx.models.get_transformer_lm(vocab_size=VOCAB, seq_len=SEQ,
                                       num_layers=LAYERS, num_heads=HEADS,
                                       d_model=D)
    shapes, _, _ = sym.infer_shape(data=(1, SEQ))
    rng = np.random.RandomState(0)
    params = {}
    for n, s in zip(sym.list_arguments(), shapes):
        if n in ("data", "softmax_label"):
            continue
        params["arg:" + n] = (rng.randn(*s) * 0.3).astype(np.float32)
    js = sym.tojson()
    ref = mx.predict.Predictor(js, {k: mx.nd.array(v)
                                    for k, v in params.items()},
                               ctx=mx.cpu(), input_shapes={"data": (1, SEQ)})
    return js, params, ref


def _tokens(n, seed):
    return np.random.RandomState(seed).randint(0, VOCAB, (n, 1, SEQ)) \
        .astype(np.float32)


def _mxtpu_probs(ref, toks):
    ref.forward(data=toks)
    return ref.get_output(0)


def test_params_from_mxtpu_is_exact(mt, lm):
    _, params, _ = lm
    got = mt.convert.params_from_mxtpu(params, mt.cpu())
    assert set(got) == set(params)
    for k, v in params.items():
        assert got[k].shape == v.shape and got[k].dtype == mt.nd.array(
            v, ctx=mt.cpu()).dtype
        assert np.array_equal(got[k].asnumpy(), v)
    # also from objects with asnumpy() (mxtpu NDArrays)
    got2 = mt.convert.params_from_mxtpu(
        {k: mx.nd.array(v) for k, v in params.items()}, "cpu")
    for k, v in params.items():
        assert np.array_equal(got2[k].asnumpy(), v)


@pytest.mark.parametrize("batch", [1, 3])
def test_predictor_matches_mxtpu_predictor(mt, lm, batch):
    js, params, _ = lm
    toks = _tokens(batch, seed=batch)[:, 0]
    ref = mx.predict.Predictor(js, {k: mx.nd.array(v)
                                    for k, v in params.items()},
                               ctx=mx.cpu(), input_shapes={"data": toks.shape})
    pred = mt.Predictor(js, mt.convert.params_from_mxtpu(params, mt.cpu()),
                        ctx=mt.cpu(), input_shapes={"data": toks.shape})
    pred.forward(data=toks)
    got = pred.get_outputs()[0]
    assert got.shape == (batch * SEQ, VOCAB)
    np.testing.assert_allclose(got, _mxtpu_probs(ref, toks), rtol=0,
                               atol=ATOL)


def test_predictor_reshape_reuses_bind_cache(mt, lm):
    js, params, _ = lm
    pred = mt.Predictor(js, params, ctx=mt.cpu(),
                        input_shapes={"data": (1, SEQ)})
    ex1 = pred._executor
    pred.reshape({"data": (2, SEQ)})
    assert pred._executor is not ex1
    pred.reshape({"data": (1, SEQ)})
    assert pred._executor is ex1
    assert pred.get_output_shape(0) == (SEQ, VOCAB)


@pytest.mark.parametrize("buckets", [(1,), (1, 4)])
def test_session_matches_mxtpu_predictor(mt, lm, buckets):
    """Single requests, then 6 concurrent ones (batched and padded into
    the buckets): each answer equals mxtpu's on that request alone."""
    js, params, ref = lm
    toks = _tokens(7, seed=11)
    with mt.serving.ServingSession(
            js, mt.convert.params_from_mxtpu(params, mt.cpu()),
            {"data": (1, SEQ)}, buckets=buckets, contexts=[mt.cpu()],
            max_delay_ms=20.0) as sess:
        out = sess.predict({"data": toks[0]})
        assert len(out) == 1 and out[0].shape == (SEQ, VOCAB)
        np.testing.assert_allclose(out[0], _mxtpu_probs(ref, toks[0]),
                                   rtol=0, atol=ATOL)
        futures = [sess.predict_async({"data": t}) for t in toks[1:]]
        answers = [f.wait(60)[0] for f in futures]
        stats = sess.stats()
    for t, a in zip(toks[1:], answers):
        np.testing.assert_allclose(a, _mxtpu_probs(ref, t), rtol=0,
                                   atol=ATOL)
    assert stats["requests_completed"] == 7
    assert stats["batches_dispatched"] >= (7 if buckets == (1,) else 3)


def test_session_warms_each_replica_on_its_dispatcher_thread(mt, lm,
                                                            monkeypatch):
    """cuDNN keeps its plans per thread, so the warmup runs on the thread
    that will serve, once per replica, before the session accepts."""
    from mxtpu_torch.serving import pool
    seen = []
    real = pool.ExecutorPool.warmup_replica

    def spy(self, rep, buckets):
        seen.append((threading.current_thread().name, tuple(buckets)))
        return real(self, rep, buckets)

    monkeypatch.setattr(pool.ExecutorPool, "warmup_replica", spy)
    js, params, _ = lm
    with mt.serving.ServingSession(js, params, {"data": (1, SEQ)},
                                   buckets=(2, 1),
                                   contexts=[mt.cpu(), mt.cpu()]) as sess:
        assert sorted(sess.warmup_ms) == [1, 2]
        assert len(sess.predict({"data": _tokens(1, seed=2)[0]})) == 1
    assert sorted(seen) == [("mxtpu-torch-serving-0", (1, 2)),
                            ("mxtpu-torch-serving-1", (1, 2))]


def test_session_warmup_failure_raises_and_stops_its_threads(mt, lm,
                                                             monkeypatch):
    from mxtpu_torch.serving import pool

    def fail(self, rep, buckets):
        raise mt.MXNetError("warmup failed")

    monkeypatch.setattr(pool.ExecutorPool, "warmup_replica", fail)
    js, params, _ = lm
    before = set(threading.enumerate())
    with pytest.raises(mt.MXNetError, match="warmup failed"):
        mt.serving.ServingSession(js, params, {"data": (1, SEQ)},
                                  buckets=(1,), contexts=[mt.cpu()])
    assert not [t for t in threading.enumerate()
                if t not in before and t.name.startswith("mxtpu-torch")]


def test_session_without_contexts_needs_cuda(mt, lm):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    js, params, _ = lm
    with pytest.raises(mt.MXNetError, match="CUDA"):
        mt.serving.ServingSession(js, params, {"data": (1, SEQ)},
                                  buckets=(1,))


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_predict_on_port_0(mt, lm):
    js, params, ref = lm
    server = mt.serving.serve(js, params, {"data": (1, SEQ)},
                              port=0, block=False, buckets=(1, 2),
                              contexts=[mt.cpu()])
    try:
        toks = _tokens(2, seed=21)
        results = [None, None]

        def client(i):
            results[i] = _post(server.endpoint + "/v1/predict",
                               {"inputs": {"data": toks[i].tolist()}})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        for i, (code, body) in enumerate(results):
            assert code == 200
            got = np.asarray(body["outputs"][0], np.float32)
            np.testing.assert_allclose(got, _mxtpu_probs(ref, toks[i]),
                                       rtol=0, atol=ATOL)
        assert _post(server.endpoint + "/v1/nope", {})[0] == 404
        assert _post(server.endpoint + "/v1/predict", {"x": 1})[0] == 400
        code, body = _post(server.endpoint + "/v1/predict",
                           {"inputs": {"data": [[1.0, 2.0]]}})
        assert code == 400 and "shape" in body["error"]
    finally:
        server.shutdown()
    assert server.session.closed


def test_batch_finish_slices_rows_per_example(mt):
    """An output whose leading dim is bucket*T hands each request its T
    rows; a one-row-per-example output its one row."""
    from mxtpu_torch.serving.batcher import Batch, WorkItem
    items = [WorkItem({"data": np.zeros((1, 2))}, 1),
             WorkItem({"data": np.ones((2, 2))}, 2)]
    batch = Batch(items, 4, ["data"])
    assert batch.inputs["data"].shape == (4, 2)
    per_token = np.arange(4 * 3)[:, None] * np.ones((1, 5))
    per_row = np.arange(4)[:, None]
    batch.finish([per_token, per_row])
    a, b = items[0].wait(1), items[1].wait(1)
    assert np.array_equal(a[0][:, 0], [0, 1, 2]) and a[1].tolist() == [[0]]
    assert np.array_equal(b[0][:, 0], [3, 4, 5, 6, 7, 8])
    assert b[1].tolist() == [[1], [2]]


def test_batcher_buckets_padding_and_backpressure(mt):
    from mxtpu_torch.serving import batcher as B
    assert B.pick_bucket(3, (1, 4, 8)) == 4
    assert B.pick_bucket(9, (1, 4, 8)) == 8
    assert B.pad_rows(np.ones((1, 3)), 4).tolist() == \
        [[1, 1, 1]] + [[0, 0, 0]] * 3
    q = B.DynamicBatcher(["data"], buckets=(1, 2), max_queue=2,
                         example_shapes={"data": (1, 3)})
    q.submit({"data": np.zeros((1, 3))})
    q.submit({"data": np.zeros((1, 3))})
    with pytest.raises(B.QueueFull):
        q.submit({"data": np.zeros((1, 3))})
    with pytest.raises(mt.MXNetError, match="per-example"):
        q.submit({"data": np.zeros((1, 4))})
    batch = q.next_batch(timeout=1)
    assert batch.bucket == 2 and batch.n_valid == 2
    q.close()
    assert q.next_batch(timeout=0.1) is None
    with pytest.raises(B.BatcherClosed):
        q.submit({"data": np.zeros((1, 3))})


def _get(url, accept=None):
    req = urllib.request.Request(url, headers={"Accept": accept}
                                 if accept else {})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read().decode(), r.headers.get("Content-Type")


def _span_counts(snap):
    """span_ms{span=...} observation counts of a /metrics JSON body."""
    return {k: v["count"] for k, v in snap["mxtpu"].items()
            if k.startswith("span_ms{")}


def _scraped(pkg, server, n_requests):
    """/v1/metrics after ``n_requests`` sequential predicts, the change of
    the process-wide span counts over them, and the Prometheus text."""
    ep = "http://%s:%d" % server.server_address[:2]
    before = _span_counts(json.loads(_get(ep + "/metrics?format=json")[0]))
    for i in range(n_requests):
        code, _ = _post(ep + "/v1/predict",
                        {"inputs": {"data": _tokens(1, 40 + i)[0].tolist()}})
        assert code == 200
    v1 = json.loads(_get(ep + "/v1/metrics")[0])
    after = _span_counts(json.loads(_get(ep + "/metrics?format=json")[0]))
    text, ctype = _get(ep + "/metrics")
    assert ctype == pkg.telemetry.PROMETHEUS_CONTENT_TYPE
    spans = {k: v - before.get(k, 0) for k, v in after.items()
             if v != before.get(k, 0)}
    return v1, spans, text


@pytest.mark.parametrize("mode", ["burst", "continuous"])
def test_metrics_endpoints_hold_mxtpus_series(mt, lm, mode):
    """/v1/metrics and /metrics on cpu() after the same 3 requests: the
    series mxtpu's server exposes in the same mode, with the same counts
    (a batch's pool span is ``pool.run`` in burst mode and
    ``pool.dispatch`` in continuous mode)."""
    js, params, _ = lm
    n = 3
    ref_srv = mx.serving.serve(js, {k: mx.nd.array(v)
                                    for k, v in params.items()},
                               {"data": (1, SEQ)}, port=0, block=False,
                               buckets=(1, 2), mode=mode,
                               contexts=[mx.cpu()])
    try:
        ref_v1, ref_spans, ref_text = _scraped(mx, ref_srv, n)
    finally:
        ref_srv.shutdown()
    server = mt.serving.serve(js, params, {"data": (1, SEQ)}, port=0,
                              block=False, buckets=(1, 2), mode=mode,
                              contexts=[mt.cpu()])
    try:
        v1, spans, text = _scraped(mt, server, n)
        ep = server.endpoint
        body, ctype = _get(ep + "/metrics", accept="application/json")
        assert ctype == "application/json"
        assert set(json.loads(body)) == {"mxtpu", "mxtpu_serving"}
    finally:
        server.shutdown()
    for key in ("requests_received", "requests_completed", "batches_formed",
                "batch_rows_valid", "batch_rows_padded", "batch_fill_ratio",
                "shed_rate", "executor_cache_misses"):
        assert v1[key] == ref_v1[key], key
    for key in ("batch_exec_ms", "request_latency_ms"):
        assert v1[key]["count"] == ref_v1[key]["count"] == n
        assert set(v1[key]) == set(ref_v1[key])
    assert v1["requests_completed"] == n and v1["batches_dispatched"] == n
    pool_span = "pool.run" if mode == "burst" else "pool.dispatch"
    for span in ("batch[1]", "serving.request", pool_span):
        key = "span_ms{span=%s}" % span
        assert spans[key] == ref_spans[key] == n, key
    for line in ("mxtpu_serving_requests_completed 3",
                 "mxtpu_serving_batches_formed 3",
                 'mxtpu_span_ms_count{span="batch[1]"}',
                 "# TYPE mxtpu_engine_ops_completed counter",
                 "# TYPE mxtpu_engine_workers gauge"):
        assert line in text and line in ref_text, line


def test_batch_span_is_a_child_of_its_request_span(mt, lm):
    js, params, _ = lm
    finished = []
    mt.telemetry.tracing.set_span_sink(finished.append)
    try:
        with mt.serving.ServingSession(js, params, {"data": (1, SEQ)},
                                       buckets=(1,),
                                       contexts=[mt.cpu()]) as sess:
            for i in range(2):
                sess.predict({"data": _tokens(1, 50 + i)[0]})
    finally:
        mt.telemetry.tracing.set_span_sink(None)
    requests = {s.span_id: s for s in finished
                if s.name == "serving.request"}
    batches = [s for s in finished if s.name == "batch[1]"]
    assert len(requests) == 2 and len(batches) == 2
    for b in batches:
        assert b.parent_id in requests
        assert b.trace_id == requests[b.parent_id].trace_id
        assert b.tags == {"n_valid": 1}


def test_replica_fault_points_fail_one_batch_and_keep_serving(mt, lm):
    """An injected fault at ``serving.replica.dispatch`` or ``collect``
    (mxtpu's pool points) fails that batch's request; the dispatcher
    lives on and the next request is answered."""
    js, params, ref = lm
    toks = _tokens(1, seed=60)[0]
    with mt.serving.ServingSession(js, params, {"data": (1, SEQ)},
                                   buckets=(1,),
                                   contexts=[mt.cpu()]) as sess:
        for point in ("serving.replica.dispatch", "serving.replica.collect"):
            try:
                with mt.faults.scope("%s:kind=raise,times=1" % point):
                    with pytest.raises(mt.faults.FaultInjected,
                                       match=point):
                        sess.predict({"data": toks})
                    got = sess.predict({"data": toks})[0]
            finally:
                mt.faults.reset()
            np.testing.assert_allclose(got, _mxtpu_probs(ref, toks),
                                       rtol=0, atol=ATOL)
        assert sess.stats()["requests_failed"] == 2
