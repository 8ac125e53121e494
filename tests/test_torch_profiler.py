"""The port's profiler (mxtpu_torch.profiler) through mxtpu's profiler
cases by one body for both packages: per-layer spans of a training step
in the chrome trace (the same event keys and span names), the aggregate
stats table, and no per-op recording when the profiler is off. The port's
torch.profiler session is exported beside the chrome trace."""
import json
import os

import numpy as np
import pytest


@pytest.fixture(scope="module")
def pkgs():
    import torch
    torch.set_num_threads(1)
    import mxtpu
    import mxtpu_torch
    return {"mxtpu": mxtpu, "mxtpu_torch": mxtpu_torch}


@pytest.fixture(params=["mxtpu", "mxtpu_torch"])
def pkg(request, pkgs):
    p = pkgs[request.param]
    p.profiler.clear()
    yield p
    p.profiler.set_state("stop")
    p.profiler.set_config(mode="symbolic", filename="profile.json",
                          aggregate_stats=False)
    p.profiler.clear()


def _block(sym, data, prefix, nf):
    c = sym.Convolution(data, kernel=(3, 3), pad=(1, 1), num_filter=nf,
                        no_bias=True, name="%s_conv" % prefix)
    b = sym.BatchNorm(c, fix_gamma=False, name="%s_bn" % prefix)
    return sym.Activation(b, act_type="relu", name="%s_relu" % prefix)


def _profiled_step(p, fname):
    sym = p.sym
    net = sym.Variable("data")
    for i in range(3):
        net = _block(sym, net, "stage%d" % i, 8)
    net = sym.FullyConnected(sym.Flatten(net, name="flatten"), num_hidden=4,
                             name="fc")
    net = sym.SoftmaxOutput(net, name="softmax")
    p.profiler.set_config(mode="symbolic", filename=fname)
    p.profiler.set_state("run")
    try:
        exe = net.simple_bind(ctx=p.cpu(), data=(2, 3, 16, 16),
                              softmax_label=(2,))
        exe.arg_dict["data"][:] = p.nd.array(
            np.random.RandomState(0).rand(2, 3, 16, 16).astype("float32"),
            ctx=p.cpu())
        exe.forward(is_train=True)
        exe.backward()
    finally:
        p.profiler.set_state("stop")
    path = p.profiler.dump_profile()
    assert path == fname and os.path.exists(fname)
    with open(fname) as f:
        return json.load(f)


def test_per_layer_spans_and_dump(pkg, tmp_path):
    trace = _profiled_step(pkg, str(tmp_path / "trace.json"))
    names = {ev["name"] for ev in trace["traceEvents"]}
    for expect in ("stage0_conv", "stage1_bn", "stage2_relu", "fc",
                   "softmax", "backward"):
        assert expect in names, (expect, sorted(names)[:20])
    begins = {}
    for ev in trace["traceEvents"]:
        key = (ev["name"], ev["tid"])
        if ev["ph"] == "B":
            begins[key] = ev["ts"]
        elif ev["ph"] == "E":
            assert ev["ts"] >= begins[key]
    table = pkg.profiler.dumps()
    assert "stage0_conv" in table and "Count" in table


def test_chrome_trace_keys_and_span_names_equal_mxtpus(pkgs, tmp_path):
    traces = {}
    for name, p in pkgs.items():
        p.profiler.clear()
        try:
            traces[name] = _profiled_step(p, str(tmp_path / (name + ".json")))
        finally:
            p.profiler.clear()
    ref, got = traces["mxtpu"], traces["mxtpu_torch"]
    assert set(got) == set(ref)

    def events(tr):
        """(span name, category, event keys) of every event: a layer's
        category is its op's name, a telemetry span's its subsystem."""
        return {(ev["name"], ev["cat"], tuple(sorted(ev)))
                for ev in tr["traceEvents"]}
    assert events(got) == events(ref)
    assert ("stage0_conv", "Convolution") in {
        (ev["name"], ev["cat"]) for ev in got["traceEvents"]}
    spans = {ev["name"] for ev in got["traceEvents"]
             if ev["cat"] == "executor"}
    assert spans == {"executor.forward", "executor.backward"}
    for ev in got["traceEvents"]:
        if ev["cat"] == "executor" and ev["ph"] == "B":
            assert set(ev["args"]) >= {"trace_id", "span_id", "parent_id"}


def test_aggregate_stats_mode(pkg):
    pkg.profiler.set_config(mode="symbolic", filename="unused_agg.json",
                            aggregate_stats=True)
    pkg.profiler.set_state("run")
    try:
        for _ in range(5):
            with pkg.profiler.scope("agg_layer"):
                pass
    finally:
        pkg.profiler.set_state("stop")
    table = pkg.profiler.dumps()
    assert "agg_layer" in table and "P50(ms)" in table
    row = next(ln for ln in table.splitlines()
               if ln.startswith("agg_layer"))
    assert int(row.split()[1]) == 5
    with pkg.profiler._lock:
        pkg.profiler._events.clear()
    assert "agg_layer" in pkg.profiler.dumps()
    assert pkg.profiler.aggregate_stats_snapshot()["agg_layer"].count == 5
    pkg.profiler.dumps(reset=True)
    assert "agg_layer" not in pkg.profiler.dumps()
    pkg.profiler.set_config(mode="symbolic", filename="unused_agg.json",
                            aggregate_stats=False)
    pkg.profiler.set_state("run")
    try:
        with pkg.profiler.scope("raw_layer"):
            pass
    finally:
        pkg.profiler.set_state("stop")
    table = pkg.profiler.dumps()
    assert "raw_layer" in table and "P99(ms)" not in table


def test_profiler_off_records_nothing(pkg):
    assert not pkg.profiler.ops_enabled()
    net = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=4,
                                 name="fc")
    exe = net.simple_bind(ctx=pkg.cpu(), data=(2, 8))
    exe.forward(is_train=False)
    assert pkg.profiler.dumps().count("\n") == 0  # header only


def test_torch_session_is_exported_beside_the_chrome_trace(pkgs, tmp_path):
    mt = pkgs["mxtpu_torch"]
    mt.profiler.clear()
    fname = str(tmp_path / "run.json")
    try:
        _profiled_step(mt, fname)
        prof = mt.profiler.torch_profile()
        assert prof is not None
        assert mt.profiler.torch_trace_path() == str(tmp_path /
                                                     "run.torch.json")
        with open(mt.profiler.torch_trace_path()) as f:
            events = json.load(f)["traceEvents"]
        assert any("conv" in str(ev.get("name", "")) for ev in events)
        mt.profiler.clear()
        assert mt.profiler.torch_profile() is None
    finally:
        mt.profiler.set_config()
        mt.profiler.clear()
