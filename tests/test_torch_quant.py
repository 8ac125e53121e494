"""int8 post-training quantization in the port (``compile.quant``, the
``quant`` rewrite and the executor's ``__q8`` weight streams) held to
mxtpu's: scale math and int8 copies bit for bit, a calibration mxtpu
persisted replays in the port, live calibration observes what mxtpu's
observes, the calibrated quantized forward within twice mxtpu's own
quantized-vs-f32 distance, the ``quant.calibration_load`` fault point's
weight-only fallback, training kinds never touched, and a weight written
in place re-quantized."""
import json
import logging

import numpy as np
import pytest

from compile_cases import build, seeded_params, values_for


@pytest.fixture(scope="module")
def pkgs():
    import torch
    torch.set_num_threads(2)
    import mxtpu
    import mxtpu_torch
    return mxtpu, mxtpu_torch


@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("shape", [(16, 8), (8, 3, 3, 3), (5,), (3, 1)])
def test_scales_and_int8_copies_bit_for_bit(pkgs, shape, per_channel):
    mx, mt = pkgs
    rng = np.random.RandomState(sum(shape) + per_channel)
    w = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    if w.size:
        w.flat[0] = 0.0
    if len(shape) > 1 and shape[0]:
        w[-1] = 0.0   # an all-zero channel takes the scale floor
    want = mx.compile.quant.weight_scales(w, axis=0,
                                          per_channel=per_channel)
    got = mt.compile.quant.weight_scales(values_for(mt, {"w": w})["w"],
                                         axis=0, per_channel=per_channel)
    assert got == want
    scales, axis = want
    q_want = np.asarray(mx.compile.quant.quantize_array(w, scales, axis))
    q_got = mt.compile.quant.quantize_array(
        values_for(mt, {"w": w})["w"], scales, axis).numpy()
    assert q_got.dtype == np.int8 and np.array_equal(q_got, q_want)


def _eval(pkg, sym, args, x, names):
    nd = pkg.nd
    ex = sym.bind(pkg.cpu(), dict({k: nd.array(v, ctx=pkg.cpu())
                                   for k, v in args.items()},
                                  data=nd.array(x, ctx=pkg.cpu()),
                                  softmax_label=nd.zeros((len(x),),
                                                         ctx=pkg.cpu())),
                  args_grad=None, grad_req="null")
    with pkg.compile.pipeline_scope(names):
        return ex, ex.forward(is_train=False)[0].asnumpy()


def _fixture(pkg):
    sym, shapes = build(pkg, "mlp")
    args, _ = seeded_params(sym, {"data": (64, 784)}, seed=5)
    x = np.random.RandomState(6).rand(64, 784).astype(np.float32)
    return sym, args, x


def test_mxtpus_calibration_replays_in_the_port(pkgs, tmp_path,
                                                monkeypatch):
    """mxtpu calibrates and persists into the measurement corpus; the
    port loads the row (stats and percentile) and replays mxtpu's live
    scales bit for bit. The port's own live capture of the same batch
    observes the same entries and counts, its statistics within f32
    reduction-order error of mxtpu's."""
    mx, mt = pkgs
    monkeypatch.setenv("MXTPU_CORPUS_DIR", str(tmp_path))
    from mxtpu.obs import corpus
    corpus.reset()
    sym, args, x = _fixture(mx)
    with mx.compile.quant.calibration_scope() as rec:
        _eval(mx, sym, args, x, [])
        live = mx.compile.quant.scales_from_stats(rec.stats())
        mx.compile.quant.persist_calibration(rec)
    corpus.reset()
    assert live
    stats, pct = mt.compile.quant.load_calibration(str(tmp_path))
    assert stats == rec.stats() and pct == rec.percentile
    assert mt.compile.quant.replay_scales(str(tmp_path)) == live
    sym_t, _a, _x = _fixture(mt)
    with mt.compile.quant.calibration_scope() as mine:
        _eval(mt, sym_t, args, x, [])
    got = mine.stats()
    assert sorted(got) == sorted(rec.stats())
    for name, s in rec.stats().items():
        assert got[name]["count"] == s["count"]
        for k in ("absmax", "pct"):
            assert abs(got[name][k] - s[k]) <= 1e-5 * max(1.0, s[k])


def test_calibrated_quantized_forward_like_mxtpus(pkgs):
    """Armed calibration, then the quant rewrite: weight streams and the
    activation quantize/dequantize pairs land in the port's graph as in
    mxtpu's, and the forward is within twice mxtpu's own distance from
    its f32 forward."""
    mx, mt = pkgs
    outs, graphs = [], []
    for pkg in (mx, mt):
        sym, args, x = _fixture(pkg)
        _ex, ref = _eval(pkg, sym, args, x, [])
        with pkg.compile.quant.calibration_scope():
            _eval(pkg, sym, args, x, [])
            ex, out = _eval(pkg, sym, args, x, ["quant"])
        assert "quant" in ex.pipeline_report.applied
        outs.append((ref, out))
        graphs.append(json.loads(
            ex._xform[(("quant",), True)][0].tojson()))
    # the same nodes, inputs and attrs; an activation's calibrated scale
    # is each package's own f32 statistic (within its rounding)
    assert len(graphs[1]["nodes"]) == len(graphs[0]["nodes"])
    for got, want in zip(graphs[1]["nodes"], graphs[0]["nodes"]):
        ga, wa = dict(got.get("attrs", {})), dict(want.get("attrs", {}))
        gs, ws = ga.pop("scale", None), wa.pop("scale", None)
        assert (got["op"], got["name"], got["inputs"], ga) == \
            (want["op"], want["name"], want["inputs"], wa)
        if ws is not None:
            g, w = (np.array([float(v) for v in t.strip("()").split(",")
                              if v.strip()]) for t in (gs, ws))
            assert np.allclose(g, w, rtol=1e-6, atol=0), got["name"]
    assert any(n["name"].endswith("__q8") and n["op"] == "quantize_int8"
               for n in graphs[1]["nodes"])
    (f32, want), (_f, got) = outs
    own = float(np.abs(want - f32).max())
    assert own > 0 and float(np.abs(got - want).max()) <= 2 * own


def test_calibration_load_fault_falls_back_to_weight_only(pkgs,
                                                          tmp_path,
                                                          monkeypatch):
    """The ``quant.calibration_load`` fault point guards the corpus read:
    a failing read degrades to the weight-only rewrite, counted under
    ``quant_rejections{reason=calibration_load}``, as in mxtpu."""
    _mx, mt = pkgs
    monkeypatch.setenv("MXTPU_CORPUS_DIR", str(tmp_path))
    sym, args, x = _fixture(mt)
    c = mt.telemetry.registry().counter(
        "quant_rejections", labels={"reason": "calibration_load"})
    before = c.value
    with mt.faults.scope("quant.calibration_load:kind=raise,times=1"):
        ex, out = _eval(mt, sym, args, x, ["quant"])
    assert "quant" in ex.pipeline_report.applied
    assert c.value == before + 1
    assert np.isfinite(out).all()
    assert not any(n.name.endswith("__q8") and not n.is_variable
                   for n in ex._xform[(("quant",), True)][0]._topo())


def test_training_kinds_are_never_quantized(pkgs):
    _mx, mt = pkgs
    sym, _ = build(mt, "mlp")
    rng = np.random.RandomState(0)
    x = rng.rand(16, 784).astype(np.float32)
    y = rng.randint(0, 10, 16).astype(np.float32)
    mod = mt.mod.Module(sym, context=mt.cpu(),
                        logger=logging.getLogger("quiet"))
    with mt.compile.pipeline_scope(["quant"]):
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=8), num_epoch=1,
                optimizer="sgd")
    rep = mod._fused.pipeline_report
    assert rep.applied == [] and not rep.symbol_changed
    assert any("inference-only pass" in f.message for f in rep.findings())


def test_a_weight_written_in_place_is_requantized(pkgs):
    """A parameter copied into in place (``copy_params_from``) moves its
    tensor's version: the quantized plan re-derives its scales and int8
    copy from the new weights, equal to a fresh executor's forward."""
    _mx, mt = pkgs
    sym, args, x = _fixture(mt)
    ex, before = _eval(mt, sym, args, x, ["quant"])
    new = {k: v * 1.5 for k, v in args.items()}
    ex.copy_params_from({k: mt.nd.array(v, ctx=mt.cpu())
                         for k, v in new.items()})
    with mt.compile.pipeline_scope(["quant"]):
        after = ex.forward(is_train=False)[0].asnumpy()
    _fresh, want = _eval(mt, sym, new, x, ["quant"])
    assert np.array_equal(after, want)
    assert not np.array_equal(after, before)
