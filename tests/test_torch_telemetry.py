"""The port's telemetry (mxtpu_torch.telemetry) held to mxtpu's exactly:
one scripted sequence of counters, gauges and histograms renders the same
Prometheus text and JSON on a fresh registry of each package, a span tree
across a thread hop has the same shape, the mlp's fit emits the same
series with the same counts, and ``set_enabled(False)`` quiets every
helper. mxtpu's default registry is never reset (its engine and executor
series are module globals); the fit case compares deltas."""
import json
import logging
import threading

import numpy as np
import pytest


@pytest.fixture(scope="module")
def pkgs():
    import torch
    torch.set_num_threads(1)
    import mxtpu
    import mxtpu_torch
    return mxtpu, mxtpu_torch


def _script(tel):
    """One registry driven through every metric kind, labels and custom
    buckets included; returns it."""
    reg = tel.MetricsRegistry(namespace="mxtpu")
    reg.counter("requests", help="served").inc(3)
    reg.counter("requests", labels={"code": "500"}).inc()
    reg.counter("weird-name.x", labels={"a b": 'q"u\\ote'}).inc(2)
    reg.gauge("depth", help="queue depth").set(7)
    reg.gauge("ratio").set(0.125)
    reg.gauge("cb", fn=lambda: 42)
    g = reg.gauge("moved")
    g.inc(5)
    g.dec(2)
    h = reg.histogram("lat_ms", help="latency")
    for v in (0.01, 0.3, 0.3, 2.0, 7.5, 40.0, 900.0, 20000.0):
        h.observe(v)
    hb = reg.histogram("sizes", labels={"kind": "x"}, bounds=(1, 10, 100))
    for v in (0, 5, 50, 500, 5000):
        hb.observe(v)
    reg.histogram("empty")
    return reg


def _json_without_uptime(tel, reg):
    snap = tel.json_snapshot(reg)
    for body in snap.values():
        body.pop("uptime_sec")
    return json.dumps(snap, sort_keys=True)


def test_exposition_of_one_scripted_sequence_equals_mxtpu(pkgs):
    mx, mt = pkgs
    ref, got = _script(mx.telemetry), _script(mt.telemetry)
    assert mt.telemetry.prometheus_text(got) == \
        mx.telemetry.prometheus_text(ref)
    assert _json_without_uptime(mt.telemetry, got) == \
        _json_without_uptime(mx.telemetry, ref)
    # percentiles interpolate the same way
    for p in (0, 50, 90, 99, 100):
        assert got.histogram("lat_ms").percentile(p) == \
            ref.histogram("lat_ms").percentile(p)


def test_dump_writes_the_same_files(pkgs, tmp_path):
    mx, mt = pkgs
    for fmt in ("prometheus", "json"):
        a = mx.telemetry.dump(str(tmp_path / ("a." + fmt)),
                              _script(mx.telemetry), fmt=fmt)
        b = mt.telemetry.dump(str(tmp_path / ("b." + fmt)),
                              _script(mt.telemetry), fmt=fmt)
        ta, tb = open(a).read(), open(b).read()
        if fmt == "json":
            ta, tb = ([ln for ln in t.splitlines() if "uptime_sec" not in ln]
                      for t in (ta, tb))
        assert ta == tb


def _span_tree(tel):
    """root -> child -> (thread hop) grandchild, plus a sibling root:
    each span's (name, parent's name, root's name)."""
    seen = {}

    def keep(s):
        seen[s.span_id] = s
    tel.tracing.set_span_sink(keep)
    try:
        with tel.span("root"):
            with tel.span("child"):
                captured = tel.current_span()

                def far():
                    with tel.span("hop", parent=captured):
                        with tel.span("hop.inner"):
                            pass
                t = threading.Thread(target=far)
                t.start()
                t.join()
            assert tel.trace_id() == tel.current_span().trace_id
        with tel.span("other"):
            pass
        assert tel.current_span() is None and tel.trace_id() == 0
    finally:
        tel.tracing.set_span_sink(None)
    by_id = dict(seen)
    out = []
    for s in sorted(seen.values(), key=lambda s: s.span_id):
        parent = by_id[s.parent_id].name if s.parent_id else None
        out.append((s.name, parent, by_id[s.trace_id].name))
    return out


def test_span_tree_across_a_thread_hop_has_mxtpus_shape(pkgs):
    mx, mt = pkgs
    want = [("root", None, "root"), ("child", "root", "root"),
            ("hop", "child", "root"), ("hop.inner", "hop", "root"),
            ("other", None, "other")]
    assert _span_tree(mx.telemetry) == want
    assert _span_tree(mt.telemetry) == want


def _fit_deltas(pkg):
    """Run the mlp's fit on cpu() from fixed weights and return the
    change of every series of the default registry that the fit made or
    moved (counters by value, histograms by count): a series an earlier
    test registered and the fit left alone is not the fit's."""
    tel = pkg.telemetry

    def snap():
        out = {}
        for m in tel.registry().series():
            key = (m.name, tuple(sorted(m.labels.items())))
            out[key] = m.count if isinstance(m, tel.Histogram) else m.value
        return out

    sym = pkg.models.mlp.get_symbol(10)
    rng = np.random.RandomState(0)
    x = rng.rand(48, 784).astype(np.float32)
    y = rng.randint(0, 10, 48).astype(np.float32)
    shapes = dict(zip(sym.list_arguments(),
                      sym.infer_shape(data=(16, 784))[0]))
    w0 = {k: pkg.nd.array(rng.uniform(-0.05, 0.05, s).astype(np.float32),
                          ctx=pkg.cpu())
          for k, s in shapes.items() if k not in ("data", "softmax_label")}
    mod = pkg.mod.Module(sym, context=pkg.cpu(),
                         logger=logging.getLogger("quiet"))
    before = snap()
    mod.fit(pkg.io.NDArrayIter(x, y, batch_size=16), num_epoch=2,
            optimizer="sgd", arg_params=w0,
            eval_data=pkg.io.NDArrayIter(x, y, batch_size=16))
    after = snap()
    return {k: v - before.get(k, 0) for k, v in after.items()
            if k[0] != "fit_samples_per_sec"
            and (k not in before or v != before[k])}


def test_mlp_fit_emits_mxtpus_series_with_the_same_counts(pkgs):
    mx, mt = pkgs
    ref, got = _fit_deltas(mx), _fit_deltas(mt)

    def family(d):
        return {k for k in d if k[0].startswith(("fit_", "io_"))}
    assert family(got) == family(ref)
    for key in [("fit_samples", ()), ("fit_epochs", ()),
                ("io_batches", (("iter", "NDArrayIter"),)),
                ("fit_step_ms", ()), ("fit_dispatch_ms", ()),
                ("fit_metric_sync_ms", ()), ("fit_eval_ms", ()),
                ("io_batch_assemble_ms", ()),
                ("span_ms", (("span", "fit.step"),)),
                ("span_ms", (("span", "fit.eval"),))]:
        assert got[key] == ref[key], key
    assert got[("fit_samples", ())] == 96 and got[("fit_epochs", ())] == 2
    # the port's steps go through its executor: every step is one forward
    # and one backward span under its fit.step
    steps = got[("fit_step_ms", ())]
    assert got[("span_ms", (("span", "executor.backward"),))] == steps


def test_disabled_telemetry_makes_every_helper_the_null_metric(pkgs):
    mx, mt = pkgs
    for tel in (mx.telemetry, mt.telemetry):
        was = tel.enabled()
        tel.set_enabled(False)
        try:
            for m in (tel.counter("never_registered_c"),
                      tel.gauge("never_registered_g"),
                      tel.histogram("never_registered_h")):
                assert type(m).__name__ == "_NullMetric"
                m.inc()
                m.observe(1.0)
            with tel.span("quiet") as s:
                assert s.span_id == 0
            names = {m.name for m in tel.registry().series()}
            assert not names & {"never_registered_c", "never_registered_g",
                                "never_registered_h"}
        finally:
            tel.set_enabled(was)


def test_a_raising_gauge_callback_fails_the_scrape(pkgs):
    """The port never shows a broken reading as 0 (mxtpu does)."""
    _mx, mt = pkgs
    reg = mt.telemetry.MetricsRegistry()

    def broken():
        raise RuntimeError("sensor gone")
    reg.gauge("g", fn=broken)
    with pytest.raises(RuntimeError, match="sensor gone"):
        mt.telemetry.prometheus_text(reg)
