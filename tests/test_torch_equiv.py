"""Translation validation and fuzzing in the port (``analysis.equiv``,
``analysis.graphgen``) held to mxtpu's: the same canonical keys and
certificates for every catalog rewrite; the gate armed by default, a
refused certificate rejecting its pass as the error budget does; and the
seeded fuzzer drawing mxtpu's graphs and reaching mxtpu's verdicts."""
import logging

import numpy as np
import pytest

from compile_cases import build


@pytest.fixture(scope="module")
def pkgs():
    import torch
    torch.set_num_threads(2)
    import mxtpu
    import mxtpu_torch
    return mxtpu, mxtpu_torch


def test_the_gate_is_armed_by_default(pkgs):
    mx, mt = pkgs
    assert mt.compile.pipeline.certification_enabled() is True
    assert mt.compile.pipeline.certification_enabled() == \
        mx.compile.pipeline.certification_enabled()
    assert sorted(mt.analysis.equiv.ALGEBRAS) == \
        sorted(mx.analysis.equiv.ALGEBRAS)
    assert {n: t.algebra for n, t in mt.analysis.rewrite._TRANSFORMS.items()
            } == {n: t.algebra for n, t in
                  mx.analysis.rewrite._TRANSFORMS.items()}


@pytest.mark.parametrize("name", ["mlp", "resnet8", "lm2"])
def test_entry_keys_and_certificates_equal_mxtpus(pkgs, name):
    """Canonical keys of the graph, and each applied pass's certificate
    (algebra, verdict, counts, digest) under the full composition."""
    mx, mt = pkgs
    out = []
    for pkg in (mx, mt):
        sym, shapes = build(pkg, name)
        _sym2, rep = pkg.compile.transform_graph(
            sym, kind="fused_step", shapes=shapes,
            passes=["layout", "bf16", "fuse_opt", "remat_reuse"])
        out.append((pkg.analysis.entry_key(sym),
                    pkg.analysis.equiv.canonical_digest(sym),
                    {n: c.to_dict() for n, c in
                     rep.certificates().items()}, rep.cert))
    assert out[1] == out[0]
    assert out[1][3] == "ok"


def _miscompile(pkg):
    """A verifier-clean rewrite that changes the graph (relu1 spliced out
    of fc2's input) under a claimed annotation-only algebra: only the
    certificate can see it."""
    S = pkg.sym

    class Miscompile(pkg.analysis.rewrite.TransformPass):
        name = "_test_miscompile"
        algebra = "annotation_only"

        def run(self, tctx):
            with pkg.name.NameManager():
                d = S.Flatten(S.Variable("data"))
                fc1 = S.FullyConnected(d, num_hidden=128, name="fc1")
                fc2 = S.FullyConnected(fc1, num_hidden=64, name="fc2")
                act2 = S.Activation(fc2, act_type="relu", name="relu2")
                fc3 = S.FullyConnected(act2, num_hidden=10, name="fc3")
                self.action(tctx, "spliced relu1 out of fc2's input edge")
                return S.SoftmaxOutput(fc3, name="softmax")
    return Miscompile()


def test_a_refused_certificate_rejects_the_pass(pkgs):
    """Refused by the certificate, not the error budget: the pass is
    rejected with the certificate's finding, the rest of the catalog
    applies certified, and the report reads as mxtpu's."""
    mx, mt = pkgs
    got = []
    for pkg in (mx, mt):
        reg = pkg.analysis.rewrite._TRANSFORMS
        reg["_test_miscompile"] = _miscompile(pkg)
        try:
            sym, shapes = build(pkg, "mlp")
            c = pkg.telemetry.registry().counter(
                "transform_cert_refused",
                labels={"pass": "_test_miscompile"})
            before = c.value
            _s, rep = pkg.compile.transform_graph(
                sym, kind="fused_step", shapes=shapes,
                passes=["_test_miscompile", "bf16"])
            assert c.value == before + 1
        finally:
            reg.pop("_test_miscompile", None)
        entry = rep.entries[0]
        assert entry["cert_refused"] and entry["rejected"]
        got.append(([(f.pass_name, f.severity, f.message)
                     for f in rep.findings()], rep.applied, rep.cert))
    assert got[1] == got[0]
    assert got[1][1] == ["bf16"] and got[1][2] == "ok"


def test_a_refused_pass_trains_the_unrewritten_graph(pkgs):
    """With only the miscompiling pass configured nothing is rewritten:
    the fit equals the fit with no pipeline, bit for bit."""
    _mx, mt = pkgs
    mt.analysis.rewrite._TRANSFORMS["_test_miscompile"] = _miscompile(mt)
    rng = np.random.RandomState(0)
    x = rng.rand(32, 784).astype(np.float32)
    y = rng.randint(0, 10, 32).astype(np.float32)
    out = []
    try:
        for cfg in ((), ("_test_miscompile",)):
            sym, _ = build(mt, "mlp")
            mod = mt.mod.Module(sym, context=mt.cpu(),
                                logger=logging.getLogger("quiet"))
            np.random.seed(3)
            with mt.compile.pipeline_scope(cfg):
                mod.fit(mt.io.NDArrayIter(x, y, batch_size=16),
                        num_epoch=1, optimizer="sgd")
            out.append({k: v.asnumpy()
                        for k, v in mod.get_params()[0].items()})
            if cfg:
                rep = mod._fused.pipeline_report
                assert rep.applied == [] and not rep.symbol_changed
    finally:
        mt.analysis.rewrite._TRANSFORMS.pop("_test_miscompile", None)
    for k in out[0]:
        assert np.array_equal(out[0][k], out[1][k]), k


def test_disarmed_gate_tags_off_like_mxtpu(pkgs):
    mx, mt = pkgs
    got = []
    for pkg in (mx, mt):
        pipe = pkg.compile.pipeline
        prev = pipe.set_certification(False)
        try:
            sym, shapes = build(pkg, "mlp")
            _s, rep = pipe.transform_graph(sym, kind="fused_step",
                                           shapes=shapes, passes=["bf16"])
        finally:
            pipe.set_certification(prev)
        got.append((rep.applied, rep.cert, rep.certificates()))
    assert got[1] == got[0] == (["bf16"], "off", {})


@pytest.mark.parametrize("seed", range(16))
def test_random_graph_is_mxtpus(pkgs, seed):
    mx, mt = pkgs
    with mx.name.NameManager():
        want, wshapes = mx.analysis.random_graph(seed)
    with mt.name.NameManager():
        got, gshapes = mt.analysis.random_graph(seed)
    assert got.tojson() == want.tojson() and gshapes == wshapes


@pytest.mark.parametrize("seed", [20260808, 7])
def test_fuzz_round_reaches_mxtpus_verdicts(pkgs, seed):
    """Eight graphs, each with its sampled config and knob vector:
    applied passes, certificates and the numeric differential of the
    semantics-preserving ones give mxtpu's verdict lines, and none is
    refuted."""
    mx, mt = pkgs
    with mx.name.NameManager():
        want = mx.analysis.fuzz_round(seed, n_graphs=8)
    with mt.name.NameManager():
        got = mt.analysis.fuzz_round(seed, n_graphs=8)
    assert got["verdicts"] == want["verdicts"]
    assert got["refutations"] == [] == want["refutations"]
