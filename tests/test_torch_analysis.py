"""The port's verifier passes (``mxtpu_torch.analysis.passes``) held to
mxtpu's on mxtpu's own fixtures (``tests/test_analysis.py``): each bad
graph's findings match as (pass, severity, node) and, where no exception
text is quoted, by message too; ``Symbol.lint`` (with a dry-run
pipeline), ``Module.check`` after a fit and with an aliased host array,
and the CLI, in process and as ``python -m``."""
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

from compile_cases import findings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pkgs():
    import torch
    torch.set_num_threads(2)
    import mxtpu
    import mxtpu_torch
    return mxtpu, mxtpu_torch


def _both(pkgs, make):
    """``make`` run in each package, its auto-names from a fresh counter
    (the same node names in both, whatever ran before in the process)."""
    out = []
    for pkg in pkgs:
        with pkg.name.NameManager():
            out.append(make(pkg))
    return tuple(out)


def _same(ref, got, messages=True):
    want = findings(ref) if messages else \
        [f[:3] for f in findings(ref)]
    have = findings(got) if messages else \
        [f[:3] for f in findings(got)]
    assert have == want
    assert got.passes_run == ref.passes_run


def test_pass_catalog_is_mxtpus(pkgs):
    """The same passes and transforms in the same order; each one-line
    description is mxtpu's but the donation audit's, which says what the
    port's step does (it updates in place and donates nothing)."""
    mx, mt = pkgs
    got, want = mt.analysis.list_passes(), mx.analysis.list_passes()
    assert [n for n, _ in got] == [n for n, _ in want]
    assert [d for n, d in got if n != "donation"] == \
        [d for n, d in want if n != "donation"]
    assert mt.analysis.list_transforms() == mx.analysis.list_transforms()


def test_missing_input_provenance(pkgs):
    ref, got = _both(pkgs, lambda p: p.models.mlp.get_symbol(10).lint())
    _same(ref, got)
    for a, b in zip(ref.findings, got.findings):
        assert (b.provenance, b.fix_hint, b.details) == \
            (a.provenance, a.fix_hint, a.details)


@pytest.mark.parametrize("model,shape", [("mlp", (64, 784)),
                                         ("lenet", (8, 1, 28, 28))])
def test_healthy_fixtures_are_clean(pkgs, model, shape):
    ref, got = _both(pkgs, lambda p: getattr(p.models, model).get_symbol(
        10).lint(data=shape))
    assert got.ok and ref.ok
    _same(ref, got)


def test_op_failure(pkgs):
    def make(p):
        a = p.sym.Variable("a", shape=(2, 3))
        b = p.sym.Variable("b", shape=(4, 5))
        return p.sym.broadcast_add(a, b).lint()
    ref, got = _both(pkgs, make)
    # the message quotes each package's own shape error
    _same(ref, got, messages=False)
    assert "inference failed" in got.by_pass("shape_infer")[0].message


def _dead_json(p):
    g = json.loads(p.models.mlp.get_symbol(10).tojson())
    g["nodes"].append({"op": "relu", "name": "dead1",
                       "inputs": [[0, 0, 0]]})
    g["nodes"].append({"op": "null", "name": "dead_var", "inputs": []})
    return json.dumps(g)


def test_dead_nodes_in_json(pkgs):
    ref, got = _both(pkgs, lambda p: p.analysis.analyze_json(
        _dead_json(p), shapes={"data": (4, 784)}))
    _same(ref, got)
    assert {f.node for f in got.by_pass("dead_code")} == {"dead1",
                                                          "dead_var"}


def test_binding_arg_mismatch(pkgs):
    args = {"data", "softmax_label", "fc1_weight", "fc1_bias",
            "fc2_weight", "fc2_bias", "fc3_weight", "stale_extra_weight"}
    ref, got = _both(pkgs, lambda p: p.analysis.analyze(
        p.models.mlp.get_symbol(10), shapes={"data": (4, 784)},
        args=args))
    _same(ref, got)


def test_unconsumed_multi_output_head(pkgs):
    def make(p):
        data = p.sym.Variable("data", shape=(4, 8))
        split = p.sym.SliceChannel(data, num_outputs=2, name="split")
        return split[0].lint(data=(4, 8))
    _same(*_both(pkgs, make))


def test_name_collision(pkgs):
    def make(p):
        return (p.sym.Variable("w") + p.sym.Variable("w")).lint(w=(2, 2))
    ref, got = _both(pkgs, make)
    _same(ref, got)
    assert got.by_pass("name_collision")


@pytest.mark.parametrize("groups", [{"stage2": 0}, {"stage1": 0}, None])
def test_ctx_groups(pkgs, groups):
    def make(p):
        with p.AttrScope(ctx_group="stage1"):
            x = p.sym.FullyConnected(p.sym.Variable("data"), num_hidden=4,
                                     name="fca")
        g2c = None if groups is None else \
            {k: p.cpu(v) for k, v in groups.items()}
        return x.lint(data=(2, 8), group2ctx=g2c)
    _same(*_both(pkgs, make))


@pytest.mark.parametrize("case", ["softmax", "eps_free", "guarded",
                                  "log", "log_guarded", "exp_clipped"])
def test_numerics(pkgs, case):
    def make(p):
        S = p.sym
        x = S.Variable("x")
        if case == "softmax":
            e = S.exp(x)
            return (e / S.sum(e)).lint(x=(4, 8))
        if case == "eps_free":
            return (x / S.sum(x)).lint(x=(4,))
        if case == "guarded":
            return (x / (S.sum(x) + 1e-6)).lint(x=(4,))
        if case == "log":
            return S.log(x).lint(x=(4,))
        if case == "log_guarded":
            return S.log(x + 1e-6).lint(x=(4,))
        return S.exp(S.clip(x, -10, 10)).lint(x=(4,))
    _same(*_both(pkgs, make))


def test_lint_with_a_dry_run_pipeline(pkgs):
    ref, got = _both(pkgs, lambda p: p.models.lenet.get_symbol(10).lint(
        data=(4, 1, 28, 28), pipeline="layout,bf16"))
    _same(ref, got)


def _fit(pkg):
    rng = np.random.RandomState(0)
    x = rng.rand(64, 784).astype(np.float32)
    y = np.zeros(64, np.float32)
    mod = pkg.mod.Module(pkg.models.mlp.get_symbol(10), context=pkg.cpu(),
                         logger=logging.getLogger("quiet"))
    mod.fit(pkg.io.NDArrayIter(x, y, batch_size=32), num_epoch=1,
            optimizer="sgd", optimizer_params={"learning_rate": 0.05})
    return mod


def test_module_check_after_fit(pkgs):
    """Clean after a fit (no error or warning), with mxtpu's passes run;
    with the pipeline dry-run merged in, mxtpu's findings."""
    ref, got = _both(pkgs, lambda p: _fit(p).check())
    assert not got.errors and not got.warnings, got.render()
    assert got.passes_run == ref.passes_run
    assert [f[:3] for f in findings(got) if f[1] != "info"] == \
        [f[:3] for f in findings(ref) if f[1] != "info"]
    ref, got = _both(pkgs, lambda p: _fit(p).check(pipeline="bf16"))
    assert [f for f in findings(got) if f[0] == "pipeline" or
            f[0] == "bf16"] == [f for f in findings(ref) if
                                f[0] == "pipeline" or f[0] == "bf16"]


def test_donation_audit_flags_a_host_alias(pkgs):
    """A host ``_arg_params`` array sharing storage with a tensor the
    fused step updates in place is an error at that parameter, as
    mxtpu's donation alias is."""
    mx, mt = pkgs
    mod = _fit(mt)
    mod._arg_params = {k: v.copy() for k, v in mod.get_params()[0].items()}
    assert not mod.check().by_pass("donation")
    mod._arg_params["fc1_weight"]._data = mod._fused.params[0][
        "fc1_weight"]
    errs = mod.check().by_pass("donation")
    ref = _fit(mx)
    ref._arg_params["fc1_weight"]._data = ref._fused.params["fc1_weight"]
    want = ref.check().by_pass("donation")
    assert [(f.severity, f.node) for f in errs] == \
        [(f.severity, f.node) for f in want] == [("error", "fc1_weight")]
    assert "updates in place" in errs[0].message


def test_cli_in_process_matches_mxtpu(pkgs, tmp_path, capsys):
    mx, mt = pkgs
    from mxtpu.analysis import __main__ as mx_cli
    from mxtpu_torch.analysis import __main__ as mt_cli
    path = tmp_path / "model.json"
    path.write_text(_dead_json(mx))
    outs = []
    for cli in (mx_cli, mt_cli):
        rc = cli.main([str(path), "--shape", "data=64,784", "--json",
                       "--pipeline", "bf16"])
        outs.append((rc, json.loads(capsys.readouterr().out)))
    assert outs[1] == outs[0]
    assert outs[1][0] == 0
    for cli, name in ((mx_cli, "mxtpu"), (mt_cli, "mxtpu_torch")):
        assert cli.main([]) == 0
        outs.append([ln.replace(name + ".analysis", "PKG.analysis")
                     for ln in capsys.readouterr().out.splitlines()
                     if not ln.lstrip().startswith("donation ")])
    assert outs[3] == outs[2]


def test_cli_runs_as_a_module(tmp_path):
    """``python -m mxtpu_torch.analysis model.json`` exits 1 on an error
    finding and prints it."""
    path = tmp_path / "bad.json"
    import mxtpu_torch as mt
    a = mt.sym.Variable("a", shape=(2, 3))
    b = mt.sym.Variable("b", shape=(4, 5))
    path.write_text(mt.sym.broadcast_add(a, b).tojson())
    proc = subprocess.run([sys.executable, "-m", "mxtpu_torch.analysis",
                           str(path)], capture_output=True, text=True,
                          cwd=REPO, timeout=120,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "ERROR   shape_infer [broadcast_add" in proc.stdout
