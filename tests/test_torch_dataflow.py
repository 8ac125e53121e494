"""The port's dataflow analyses (``mxtpu_torch.analysis.dataflow``) held
to mxtpu's: every fact table of ``precision_flow``, ``quant_plan``,
``liveness``, ``conv_layout``, ``remat_reuse_plan`` and
``update_fusion_plan`` equals mxtpu's on each fixture graph, node ids
read as node names and dtypes by name. ``liveness_ledger_check`` holds
the liveness estimate to the device-memory ledger's ``executor_outputs``
slot, as mxtpu's does."""
import numpy as np
import pytest

from compile_cases import build

GRAPHS = ["mlp", "lenet", "resnet8", "resnet50", "lm2"]


@pytest.fixture(scope="module")
def pkgs():
    import torch
    torch.set_num_threads(2)
    import mxtpu
    import mxtpu_torch
    return mxtpu, mxtpu_torch


def _canon(x, names):
    """``x`` with node ids and nodes read as names, dtypes by name, sets
    sorted: comparable across the packages."""
    if isinstance(x, dict):
        return {_key(k, names): _canon(v, names) for k, v in x.items()}
    if isinstance(x, (set, frozenset)):
        return sorted(_canon(v, names) for v in x)
    if isinstance(x, (list, tuple)):
        return [_canon(v, names) for v in x]
    if isinstance(x, int) and not isinstance(x, bool) and x in names:
        return names[x]
    if hasattr(x, "is_variable") and hasattr(x, "name"):
        return x.name
    if isinstance(x, np.dtype) or type(x).__name__ == "dtype":
        return "bfloat16" if "bfloat16" in str(x) else np.dtype(x).name
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    return x


def _key(k, names):
    c = _canon(k, names)
    return tuple(c) if isinstance(c, list) else c


FIELDS = {
    "precision_flow": ("classes", "var_class", "reasons"),
    "quant_plan": ("sites", "weights", "skipped", "observe",
                   "min_layer_elems", "weight_bytes_saved"),
    "liveness": ("last_use", "entry_bytes", "live_bytes",
                 "peak_live_bytes", "peak_node", "head_bytes", "complete"),
    "conv_layout": ("runs", "node_run", "data_slots"),
    "remat_reuse_plan": ("remat", "remat_names", "remat_bytes",
                         "remat_flops", "reuse_pairs", "reuse_bytes",
                         "residual_peak_before", "residual_peak_after",
                         "complete", "threshold"),
    "update_fusion_plan": ("classes", "n_params"),
}


def _facts(pkg, name, analysis):
    sym, shapes = build(pkg, name)
    df = pkg.analysis.dataflow
    kw = {}
    if analysis == "quant_plan":
        kw["min_layer_elems"] = 64
    if analysis == "update_fusion_plan":
        kw["trainable"] = [n for n in sym.list_arguments()
                           if n not in shapes and n != "softmax_label"]
    plan = getattr(df, analysis)(sym, shapes=shapes, **kw)
    names = {id(n): n.name for n in sym._topo()}
    out = {f: _canon(getattr(plan, f), names) for f in FIELDS[analysis]}
    if hasattr(plan, "summary"):
        out["summary"] = plan.summary()
    if hasattr(plan, "to_findings"):
        out["findings"] = [(f.pass_name, f.severity, f.node, f.message)
                           for f in plan.to_findings()]
    return out


@pytest.mark.parametrize("analysis", sorted(FIELDS))
@pytest.mark.parametrize("name", GRAPHS)
def test_fact_tables_equal_mxtpus(pkgs, name, analysis):
    mx, mt = pkgs
    want = _facts(mx, name, analysis)
    got = _facts(mt, name, analysis)
    for field in want:
        assert got[field] == want[field], field


def test_the_walk_types_like_mxtpus_on_a_bf16_graph(pkgs):
    """After the bf16 rewrite the walk types each entry as mxtpu's does:
    the rewritten convolutions' outputs are bfloat16."""
    mx, mt = pkgs
    out = []
    for pkg in (mx, mt):
        sym, shapes = build(pkg, "lenet")
        sym2, _ = pkg.compile.transform_graph(sym, shapes=shapes,
                                              passes=["bf16"])
        _shp, dt, events = pkg.analysis.provenance.infer_walk(sym2, shapes)
        names = {id(n): n.name for n in sym2._topo()}
        out.append(({_key(k, names): _canon(v, names)
                     for k, v in dt.items() if isinstance(k, tuple)},
                    events))
    assert out[1] == out[0]
    assert "bfloat16" in out[1][0].values()


def test_liveness_ledger_check_names_its_slice(pkgs):
    """Before a forward there is no slot to check ([] in both packages);
    after one the estimate and the slot agree in both; a slot that
    drifts is named."""
    mx, mt = pkgs
    for pkg in (mt, mx):
        sym, shapes = build(pkg, "mlp")
        ex = sym.simple_bind(pkg.cpu(), **shapes)
        check = pkg.analysis.dataflow.liveness_ledger_check
        assert check(ex) == []
        ex.forward(is_train=False)
        assert ex._out_slot._nbytes > 0
        assert check(ex) == []
    ex._out_slot._nbytes += 4   # mxtpu's slot, drifted by hand
    found = mx.analysis.dataflow.liveness_ledger_check(ex)
    sym, shapes = build(mt, "mlp")
    ex = sym.simple_bind(mt.cpu(), **shapes)
    ex.forward(is_train=False)
    ex._out_slot._nbytes += 4
    got = mt.analysis.dataflow.liveness_ledger_check(ex)
    assert [f.message for f in got] == [f.message for f in found]
    assert "executor_outputs slot accounts" in got[0].message
