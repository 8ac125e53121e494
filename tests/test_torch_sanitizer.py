"""The port's numerics sanitizer (``analysis.sanitizer``): under each
``MXTPU_SANITIZE`` mode a NaN or an Inf in a built program's outputs
trips ``NumericsError`` at that program, after a postmortem through the
flight recorder (``source="sanitizer"``); the modes split NaN from Inf
as mxtpu's do; bf16 outputs are checked as f32; and unset, no check runs
at all (``torch.isnan`` is never called)."""
import json
import logging

import numpy as np
import pytest


@pytest.fixture(scope="module")
def pkgs():
    import torch
    torch.set_num_threads(2)
    import mxtpu
    import mxtpu_torch
    return mxtpu, mxtpu_torch


@pytest.fixture
def armed(pkgs):
    _mx, mt = pkgs
    san = mt.analysis.sanitizer
    prev = san.mode()
    yield san
    if prev is None:
        san.disable()
    else:
        san.enable(prev)


def _sym(pkg, graph):
    """The mlp (softmax head: an Inf input comes out NaN), or a scale of
    the input (an Inf comes out Inf)."""
    if graph == "mlp":
        return pkg.models.mlp.get_symbol(10)
    return pkg.sym.Variable("data") * 2.0


def _forward(mt, bad, graph="mlp"):
    """An eval forward whose input holds ``bad`` (nan/inf/None)."""
    ex = _sym(mt, graph).simple_bind(mt.cpu(), grad_req="null",
                                     data=(4, 784))
    rng = np.random.RandomState(0)
    for n, a in ex.arg_dict.items():
        a[:] = rng.uniform(-0.1, 0.1, a.shape).astype(np.float32)
    x = np.ones((4, 784), np.float32)
    if bad is not None:
        x[1, 3] = float(bad)
    ex.arg_dict["data"][:] = x
    return ex.forward()


@pytest.mark.parametrize("mode,bad,graph,trips", [
    ("nan", "nan", "mlp", True), ("nan", "inf", "mlp", True),
    ("inf", "inf", "mlp", False), ("inf", "inf", "scale", True),
    ("nan", "inf", "scale", False), ("all", "nan", "mlp", True),
    ("all", "inf", "scale", True), ("all", None, "mlp", False)])
def test_modes_trip_like_mxtpus(pkgs, armed, tmp_path, monkeypatch, mode,
                                bad, graph, trips):
    """The port trips exactly where mxtpu's sanitizer trips (an Inf input
    comes out of the softmax head as NaN, of a scale as Inf), with a
    postmortem naming the program kind."""
    mx, mt = pkgs
    monkeypatch.setenv("MXTPU_DIAG_DUMP_DIR", str(tmp_path))
    armed.enable(mode)
    n0 = armed.trip_count()
    if trips:
        with pytest.raises(mt.base.NumericsError) as ei:
            _forward(mt, bad, graph)
        assert "program kind 'fwd_eval'" in str(ei.value)
        assert armed.trip_count() == n0 + 1
        pm = mt.diagnostics.last_postmortem()
        assert pm["source"] == "sanitizer" and "fwd_eval" in pm["reason"]
        assert any(e["kind"] == "sanitizer" for e in pm["flight"])
        files = list(tmp_path.iterdir())
        assert files and json.loads(files[0].read_text())["source"] == \
            "sanitizer"
    else:
        _forward(mt, bad, graph)
        assert armed.trip_count() == n0
    ref = mx.analysis.sanitizer
    prev = ref.mode()
    ref.enable(mode)
    try:
        ex = _sym(mx, graph).simple_bind(mx.cpu(), grad_req="null",
                                         data=(4, 784))
        x = np.ones((4, 784), np.float32)
        if bad is not None:
            x[1, 3] = float(bad)
        ex.arg_dict["data"][:] = x
        tripped = False
        try:
            ex.forward()
        except mx.base.NumericsError:
            tripped = True
    finally:
        if prev is None:
            ref.disable()
        else:
            ref.enable(prev)
    assert tripped == trips


def test_bf16_outputs_are_upcast_before_the_check(pkgs, armed):
    _mx, mt = pkgs
    import torch
    armed.enable("inf")
    out = [torch.tensor([1.0, float("inf")], dtype=torch.bfloat16)]
    with pytest.raises(mt.base.NumericsError, match="bfloat16"):
        armed.sanitize_tree("fwd_eval", (out, {}), precision="mixed_bf16")
    armed.sanitize_tree("fwd_eval", ([out[0][:1]], {}))


def test_a_fit_trips_at_its_training_step(pkgs, armed):
    _mx, mt = pkgs
    armed.enable("nan")
    x = np.random.RandomState(0).rand(32, 784).astype(np.float32)
    x[5] = np.nan
    mod = mt.mod.Module(mt.models.mlp.get_symbol(10), context=mt.cpu(),
                        logger=logging.getLogger("quiet"))
    with pytest.raises(mt.base.NumericsError, match="fused_step"):
        mod.fit(mt.io.NDArrayIter(x, np.zeros(32, np.float32),
                                  batch_size=16), num_epoch=1,
                optimizer="sgd")


def test_unset_it_never_checks(pkgs, armed, monkeypatch):
    """Disarmed, a forward and a fit call no ``torch.isnan`` (the one
    None check in the build seam is all it costs)."""
    _mx, mt = pkgs
    import torch
    armed.disable()
    calls = []
    real = torch.isnan

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(torch, "isnan", spy)
    _forward(mt, None)
    mod = mt.mod.Module(mt.models.mlp.get_symbol(10), context=mt.cpu(),
                        logger=logging.getLogger("quiet"))
    x = np.random.RandomState(0).rand(16, 784).astype(np.float32)
    mod.fit(mt.io.NDArrayIter(x, np.zeros(16, np.float32), batch_size=8),
            num_epoch=1, optimizer="sgd")
    assert calls == []
    assert mt.compile.pipeline._OUTPUT_SANITIZER is None
    armed.enable("nan")
    _forward(mt, None)
    assert calls
