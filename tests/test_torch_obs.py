"""The port's export layer (``mxtpu_torch.obs``: the span ring and its
Chrome-trace export, the exemplar sampler, the measurement corpus) held
to mxtpu's on the CPU:

* the same scripted spans (a parent, a child on another thread, tags)
  give mxtpu's Chrome trace-event schema: the same events by phase,
  name and category, the same keys and ``args`` keys, the flow pair of
  the cross-thread hop, the thread metadata;
* the sampler's decisions equal mxtpu's for every ordinal, rate and
  seed;
* corpus rows written by the port load with mxtpu's ``corpus.load`` and
  the reverse, every kind (build, service, calib, health), with the torn
  tail tolerated; ``summarize`` of one set of rows is mxtpu's; the
  port's program-build rows carry mxtpu's features and knob vector;
* ``compile.quant`` persists and replays its calibration through the
  corpus in both directions.
"""
import threading

import numpy as np
import pytest

import mxtpu as mx
from mxtpu.obs import corpus as mxc
from mxtpu.obs import sampler as mxs


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(2)
    import mxtpu_torch
    return mxtpu_torch


def _scripted_spans(pk):
    """One parent span, a child on another thread with a tag, a sibling;
    returns the exporter's events of them (the ring cleared first)."""
    tracing = pk.telemetry.tracing
    ring = pk.obs.trace.install()
    ring.clear()
    rec = pk.diagnostics.recorder()
    if rec is not None:
        rec.clear()
    with tracing.span("request", category="serving") as parent:
        def child():
            with tracing.span("batch[4]", category="serving", parent=parent,
                              tags={"n_valid": 3}):
                pass
        t = threading.Thread(target=child, name="worker-0")
        t.start()
        t.join()
        with tracing.span("pool.run", category="serving"):
            pass
    return pk.obs.trace_export.trace_events()


def _shape(events):
    out = []
    for e in events:
        if e["ph"] == "i":
            continue  # flight instants: each package's own breadcrumbs
        out.append((e["ph"], e.get("name"), e.get("cat"),
                    tuple(sorted(e)), tuple(sorted(e.get("args", {})))
                    if e["ph"] != "M" else None))
    return sorted(out, key=str)


def test_trace_export_schema_is_mxtpus(mt):
    mine = _scripted_spans(mt)
    theirs = _scripted_spans(mx)
    assert _shape(mine) == _shape(theirs)
    flows = [e for e in mine if e["ph"] in ("s", "f")]
    child = next(e for e in mine if e.get("name") == "batch[4]")
    assert len(flows) == 2 and all(f["id"] == child["args"]["span_id"]
                                   for f in flows)
    assert child["args"]["n_valid"] == 3
    body = mt.obs.trace_export.dumps()
    import json
    assert set(json.loads(body)) == {"traceEvents", "displayTimeUnit"}


@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.1, 0), (0.37, 5),
                                       (0.5, 123), (1.0, 9)])
def test_sampler_decisions_are_mxtpus(mt, rate, seed):
    mine = mt.obs.sampler.TraceSampler(rate, seed)
    theirs = mxs.TraceSampler(rate, seed)
    assert [mine.sampled(i) for i in range(2000)] == \
        [theirs.sampled(i) for i in range(2000)]
    assert repr(mine) == repr(theirs)


def _write_rows(corpus):
    assert corpus.record_service("serving", 1.5, bucket=4)
    assert corpus.record_service("serving", 2.5, bucket=8)
    assert corpus.record_service("fit_step", 9.25, rows=64)
    assert corpus.record_calibration({"fc1": {"count": 3, "absmax": 2.0,
                                              "pct": 1.5}}, percentile=99.9)
    assert corpus.record_health(2, {"fc1_weight": {
        "grad_norm": 0.5, "weight_norm": 2.0, "update_ratio": 0.01,
        "grad_max": 1.5, "nonfinite": 0}}, loss=1.25,
        anomalies=["loss_spike"])


@pytest.mark.parametrize("writer", ["port", "mxtpu"])
def test_corpus_rows_cross_the_packages(mt, tmp_path, monkeypatch, writer):
    """Rows one package writes load with the other's reader, the torn
    tail of a killed writer tolerated; summarize agrees."""
    w, r = (mt.obs.corpus, mxc) if writer == "port" else \
        (mxc, mt.obs.corpus)
    monkeypatch.setenv("MXTPU_CORPUS_DIR", str(tmp_path))
    w.reset()
    try:
        _write_rows(w)
        path = w.corpus_path()
    finally:
        w.reset()
    with open(path, "a", encoding="utf-8") as f:
        f.write('{"v":2,"row":"serv')
    rows = r.load(str(tmp_path))
    assert rows == w.load(str(tmp_path))
    assert [x["row"] for x in rows] == ["service"] * 3 + ["calib", "health"]
    assert all(x["v"] == 2 for x in rows)
    mine = mt.obs.corpus.summarize(rows)
    theirs = mxc.summarize(rows)
    assert mine == {k: v for k, v in theirs.items()}


def test_program_build_rows_carry_mxtpus_features(mt, tmp_path,
                                                  monkeypatch):
    """With the corpus on, a program build appends a build row with
    mxtpu's feature keys and the resolved knob vector under mxtpu's
    registry version."""
    monkeypatch.setenv("MXTPU_CORPUS_DIR", str(tmp_path))
    mt.obs.corpus.reset()
    try:
        sym = mt.models.get_mlp(10)
        ex = sym.simple_bind(mt.cpu(), data=(4, 784), softmax_label=(4,))
        ex.forward(is_train=False)
    finally:
        mt.obs.corpus.reset()
    rows = [r for r in mxc.load(str(tmp_path)) if r["row"] == "build"]
    assert rows
    want = set(mxc._BUILD_FEATURES) | {"v", "row", "t", "pipeline",
                                       "knobs"}
    assert set(rows[0]) == want
    assert rows[0]["knobs"]["registry_version"] == \
        mx.tune.registry_version()
    assert set(rows[0]["knobs"]["values"]) == \
        {k.name for k in mx.tune.knobs()}


def test_quant_calibration_through_the_corpus(mt, tmp_path, monkeypatch):
    """``persist_calibration`` writes a calib row through obs.corpus that
    mxtpu's ``load_calibration`` replays, and the reverse."""
    from mxtpu.compile import quant as mxq
    monkeypatch.setenv("MXTPU_CORPUS_DIR", str(tmp_path))
    stats = {"fc1_output": {"count": 2, "absmax": 3.0, "pct": 2.5}}
    for writer, reader in ((mt.compile.quant, mxq),
                           (mxq, mt.compile.quant)):
        rec = writer.CalibRecorder(percentile=99.0)
        rec.merge_stats(stats)
        mt.obs.corpus.reset()
        mxc.reset()
        assert writer.persist_calibration(rec)
        got, pct = reader.load_calibration(str(tmp_path))
        assert got["fc1_output"]["absmax"] == 3.0 and pct == 99.0
        np.testing.assert_array_equal(
            sorted(reader.replay_scales(str(tmp_path)).items()),
            sorted(writer.replay_scales(str(tmp_path)).items()))
    mt.obs.corpus.reset()
    mxc.reset()
