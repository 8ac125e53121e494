"""Dataflow-analysis engine over the Symbol IR: lattice walks that *license*

Counterpart of ``mxtpu/analysis/dataflow.py``: the same analyses, fact
tables and findings over the port's Symbol. dtypes are the walk's
numpy dtypes, named through ``provenance.dtype_name`` (bfloat16 is the
port's ``BFLOAT16`` stand-in, not ml_dtypes').
graph transforms.

The verifier passes answer yes/no questions about a graph; the
transform passes (:mod:`~mxtpu_torch.analysis.rewrite`) need richer facts —
*which* nodes may compute in bf16, *when* is each intermediate dead.
This module computes those facts the TVM way (PAPERS.md: "TVM: An
Automated End-to-End Optimizing Compiler"): an analysis runs first and
produces a per-node fact table; a rewrite may only do what the table
licenses; the verifier suite re-proves the result afterwards
(:func:`mxtpu_torch.compile.pipeline.transform_graph`).

Shapes and dtypes come from the ONE inference walker the whole framework
shares — :func:`provenance.infer_walk` driving
``symbol._infer_graph(events=)`` — so an analysis can never disagree
with what a real bind would have inferred.

Concrete analyses:

* :func:`precision_flow` — forward classification of every node as
  **bf16-safe** (matmul-heavy compute + elementwise followers),
  **f32-island** (dtype-sensitive: reductions, ``exp``/``log``/softmax,
  loss heads, normalization statistics — the same pattern knowledge the
  ``numerics`` verifier pass encodes), or — for parameter variables
  feeding bf16 compute — **master-weight-required** (the value is cast
  to bf16 at its use sites while the stored parameter, and the
  optimizer state derived from it, stays f32).
* :func:`liveness` — backward last-use analysis + a forward sweep that
  tracks the live set per node and estimates **peak live bytes**; the
  graph-level analogue of the diagnostics ledger's slot model, and
  cross-checkable against it (:func:`liveness_ledger_check`).
* :func:`conv_layout` — run discovery over conv/pool/BN stacks for the
  ``layout`` transform: which maximal regions could compute NHWC, and
  whether the modeled interior savings beat the boundary conversions
  (the TVM layout-transform cost decision, made per graph).
* :func:`remat_reuse_plan` — spends :func:`liveness`: which residual
  entries are cheap enough (recompute-flops per byte) to re-derive in
  backward instead of holding, and which dead entries alias a later
  same-shape/dtype allocation (buffer-reuse hints).
* :func:`update_fusion_plan` — groups trainable parameters into
  dtype/shape classes so the fused train step can collapse per-parameter
  optimizer-update chains into one batched region per class.
"""
from __future__ import annotations

import numpy as _np

from .findings import INFO, WARNING, Finding
from . import provenance as _prov

__all__ = ["DataflowAnalysis", "run_analysis", "precision_flow",
           "PrecisionPlan", "liveness", "LivenessInfo",
           "liveness_ledger_check",
           "conv_layout", "LayoutPlan",
           "remat_reuse_plan", "RematReusePlan", "recompute_flops",
           "update_fusion_plan", "UpdateFusionPlan",
           "quant_plan", "QuantPlan", "QUANT_COMPUTE",
           "BF16_SAFE", "F32_ISLAND", "MASTER_WEIGHT"]


# ------------------------------------------------------------- generic walker
class DataflowAnalysis:
    """One lattice walk over the Symbol DAG.

    Subclasses set ``direction`` ('forward' walks producers before
    consumers, 'backward' the reverse) and implement
    ``transfer(node, in_facts, ctx)`` returning the node's fact. The
    walk (:func:`run_analysis`) hands each op node the facts of its
    input *entries* (one per ``(producer, out_idx)`` edge) — for a DAG a
    single pass in (reverse) topological order IS the fixpoint, so there
    is no worklist iteration to get wrong.

    ``ctx`` carries the shared inference state: ``ctx.shapes`` /
    ``ctx.dtypes`` keyed exactly like ``_infer_graph``'s output
    (variable names and ``(id(node), out_idx)`` pairs), plus
    ``ctx.topo`` and ``ctx.index``.
    """

    name = None
    direction = "forward"

    def init_variable(self, node, ctx):
        """Fact for a variable node (leaves of the forward walk)."""
        return None

    def transfer(self, node, in_facts, ctx):
        raise NotImplementedError


class _WalkContext:
    def __init__(self, symbol, shapes, dtypes, topo):
        self.symbol = symbol
        self.shapes = shapes
        self.dtypes = dtypes
        self.topo = topo
        self.index = {id(n): i for i, n in enumerate(topo)}


def run_analysis(symbol, analysis, shapes=None, types=None):
    """Drive ``analysis`` over ``symbol``; returns ``(facts, ctx)`` where
    ``facts`` maps ``id(node)`` to the analysis' per-node fact.

    The shape/dtype substrate is the single shared walker
    (``provenance.infer_walk`` → ``_infer_graph(events=)``) — partially
    known graphs degrade to None entries, they never raise."""
    shp, dt, _events = _prov.infer_walk(symbol, shapes, types)
    topo = symbol._topo()
    ctx = _WalkContext(symbol, shp, dt, topo)
    facts = {}
    forward = analysis.direction == "forward"
    consumers = None
    if not forward:
        # consumers map built ONCE: the per-node scan would be
        # O(nodes² × fan-in) on large graphs
        consumers = {}
        for n in topo:
            for s, _ in n.inputs:
                consumers.setdefault(id(s), []).append(n)
    order = topo if forward else list(reversed(topo))
    for node in order:
        if node.is_variable:
            facts[id(node)] = analysis.init_variable(node, ctx)
            continue
        if forward:
            in_facts = [(src, idx, facts.get(id(src)))
                        for src, idx in node.inputs]
        else:
            # backward: "inputs" are the node's consumers (their facts
            # are already computed — reverse topo order)
            in_facts = [(n, 0, facts.get(id(n)))
                        for n in consumers.get(id(node), ())]
        facts[id(node)] = analysis.transfer(node, in_facts, ctx)
    return facts, ctx


# ---------------------------------------------------------- precision flow
#: node classifications
BF16_SAFE = "bf16"
F32_ISLAND = "f32"
MASTER_WEIGHT = "master"

#: matmul/conv-heavy compute where bf16 inputs engage the tensor cores
#: (the MXU of mxtpu's TPU; the reason strings keep mxtpu's words) — the
#: nodes the rewrite exists for
_BF16_COMPUTE = {"Convolution", "Deconvolution", "FullyConnected", "dot",
                 "batch_dot", "Correlation"}

#: dtype-sensitive ops that must stay f32 islands. Built from the same
#: pattern knowledge the ``numerics`` verifier pass encodes (its
#: reduction/division tables are imported, not re-declared) plus the
#: op registry's own loss_like flag: softmax/exp/log overflow or lose
#: mass in 8-bit-mantissa bf16, reductions accumulate rounding error
#: linearly in the reduced extent, and normalization STATISTICS
#: (mean/var of BatchNorm & friends) feed a rsqrt whose argument must
#: not quantize.
_F32_EXPLOG = {"exp", "expm1", "log", "log1p", "log2", "log10",
               "log_softmax", "softmax", "Softmax", "SoftmaxActivation",
               "softmax_cross_entropy", "erf", "gamma", "gammaln"}
_F32_NORMS = {"BatchNorm", "BatchNorm_v1", "InstanceNorm", "LayerNorm",
              "L2Normalization", "LRN", "norm"}
_F32_MISC = {"sqrt", "rsqrt", "_power", "_power_scalar", "_rpower_scalar",
             "_square_sum", "linalg_sumlogdiag", "_linalg_sumlogdiag"}


def _sensitive_tables():
    from .passes import _DIV_OPS, _REDUCTIONS
    return _F32_EXPLOG | _F32_NORMS | _F32_MISC | _REDUCTIONS | _DIV_OPS


def _is_float_dtype(dt):
    """True for every float dtype INCLUDING bfloat16 (the port's
    ``BFLOAT16`` stand-in is a record type, but a post-bf16 graph is
    full of it and the quant pass must still see its compute as
    float-valued)."""
    try:
        return "float" in _prov.dtype_name(dt)
    except Exception:
        return False


class PrecisionPlan:
    """Result of :func:`precision_flow`.

    ``classes`` maps ``id(node)`` → BF16_SAFE / F32_ISLAND for op nodes;
    ``var_class`` maps variable NAME → MASTER_WEIGHT (the variable feeds
    bf16 compute: keep an f32 master copy, cast at use) or F32_ISLAND;
    ``reasons`` maps ``id(node)`` → a short why-string the rewrite
    carries into its per-node provenance."""

    def __init__(self, symbol):
        self.symbol = symbol
        self.classes = {}
        self.var_class = {}
        self.reasons = {}

    @property
    def n_bf16(self):
        return sum(1 for c in self.classes.values() if c == BF16_SAFE)

    @property
    def n_f32(self):
        return sum(1 for c in self.classes.values() if c == F32_ISLAND)

    @property
    def n_master(self):
        return sum(1 for c in self.var_class.values()
                   if c == MASTER_WEIGHT)

    def class_of(self, node):
        if node.is_variable:
            return self.var_class.get(node.name, F32_ISLAND)
        return self.classes.get(id(node), F32_ISLAND)

    def to_findings(self, pass_name="precision_flow"):
        """Per-node classification as INFO findings (the ``--pipeline``
        report surface; same Finding schema as the verifier passes)."""
        out = []
        for node in self.symbol._topo():
            if node.is_variable:
                cls = self.var_class.get(node.name)
                if cls == MASTER_WEIGHT:
                    out.append(Finding(
                        pass_name, INFO,
                        "parameter '%s': master-weight-required (feeds "
                        "bf16 compute; stored f32, cast at use)"
                        % node.name, node=node.name))
                continue
            cls = self.classes.get(id(node), F32_ISLAND)
            out.append(Finding(
                pass_name, INFO,
                "node '%s' (op %s): %s — %s"
                % (node.name, node.op.name,
                   "bf16-safe" if cls == BF16_SAFE else "f32-island",
                   self.reasons.get(id(node), "default")),
                node=node.name))
        return out

    def summary(self):
        return ("precision_flow: %d bf16-safe, %d f32-island node(s), "
                "%d master-weight parameter(s)"
                % (self.n_bf16, self.n_f32, self.n_master))


class _PrecisionFlow(DataflowAnalysis):
    """Forward walk: sensitivity seeds at the sensitive ops and follows
    data edges; bf16 seeds at the matmul compute and follows through
    insensitive elementwise/shape ops."""

    name = "precision_flow"
    direction = "forward"

    def __init__(self):
        self.sensitive = _sensitive_tables()
        self.reasons = {}

    def init_variable(self, node, ctx):
        return None  # variables are neutral; classified in a second pass

    def transfer(self, node, in_facts, ctx):
        op = node.op.name
        if op in self.sensitive or node.op.loss_like:
            self.reasons[id(node)] = (
                "loss head (gradient source must not quantize)"
                if node.op.loss_like else
                "dtype-sensitive op '%s' (reduction / exp-log / "
                "normalization family)" % op)
            return F32_ISLAND
        # integer/bool outputs gain nothing and must not be cast
        out_dt = ctx.dtypes.get((id(node), 0))
        if out_dt is not None and not _is_float_dtype(out_dt):
            self.reasons[id(node)] = "non-float output (%s)" % out_dt
            return F32_ISLAND
        if op in _BF16_COMPUTE:
            self.reasons[id(node)] = \
                "matmul-class compute (MXU-eligible in bf16)"
            return BF16_SAFE
        votes = [f for _, _, f in in_facts if f is not None]
        if votes and all(f == BF16_SAFE for f in votes):
            srcs = [s.name for s, _, f in in_facts if f == BF16_SAFE]
            self.reasons[id(node)] = \
                "follows bf16 producer(s) %s" % ", ".join(srcs[:3])
            return BF16_SAFE
        if any(f == F32_ISLAND for f in votes):
            self.reasons[id(node)] = "an input is an f32 island"
        else:
            self.reasons[id(node)] = \
                "fed only by variables (no bf16 producer to follow)"
        return F32_ISLAND


def precision_flow(symbol, shapes=None, types=None):
    """Classify every node of ``symbol`` for the bf16 mixed-precision
    rewrite; returns a :class:`PrecisionPlan`."""
    ana = _PrecisionFlow()
    facts, ctx = run_analysis(symbol, ana, shapes=shapes, types=types)
    plan = PrecisionPlan(symbol)
    plan.reasons = ana.reasons
    for node in ctx.topo:
        if node.is_variable:
            continue
        plan.classes[id(node)] = facts.get(id(node)) or F32_ISLAND
    # variable classification: a parameter whose value is consumed by at
    # least one bf16 node needs a master-weight discipline (f32 storage,
    # bf16 cast at use — the fused step's optimizer state then derives
    # from the f32 master, never the quantized copy)
    aux = symbol._aux_node_set()
    for node in ctx.topo:
        if node.is_variable:
            continue
        if plan.classes.get(id(node)) != BF16_SAFE:
            continue
        for src, _idx in node.inputs:
            if src.is_variable and id(src) not in aux:
                plan.var_class[src.name] = MASTER_WEIGHT
    for node in ctx.topo:
        if node.is_variable and node.name not in plan.var_class:
            plan.var_class[node.name] = F32_ISLAND
    return plan


# ------------------------------------------------------------ int8 quant plan
#: matmul-class compute the int8 post-training-quantization rewrite
#: targets: the weight stores int8 with per-output-channel scales (axis
#: 0 in BOTH layouts — FullyConnected (num_hidden, input_dim),
#: Convolution (O, I, kH, kW)) and the data input gains a per-tensor
#: quantize/dequantize pair where calibration stats exist.
#: Deconvolution stays out of scope: its (I, O, kH, kW) weight layout
#: would make axis-0 scales quantize per INPUT channel.
QUANT_COMPUTE = {"FullyConnected", "Convolution"}


def _through_casts(src, idx=0, limit=8):
    """Follow a pure Cast chain to its ultimate producer entry
    ``(node, out_idx)`` — the bf16 rewrite interposes ``*_amp`` casts,
    and both calibration naming and weight resolution must see through
    them so ``quant`` composes with ``bf16``."""
    hops = 0
    while (not src.is_variable and src.op.name == "Cast"
           and len(src.inputs) == 1 and hops < limit):
        src, idx = src.inputs[0]
        hops += 1
    return src, idx


def entry_name(node, idx):
    """Canonical name of a graph entry ``(node, out_idx)`` — the key
    calibration stats are recorded and replayed under."""
    return node.name if idx == 0 else "%s_o%d" % (node.name, idx)


class QuantPlan:
    """Result of :func:`quant_plan` — what the ``quant`` rewrite is
    licensed to do.

    ``sites`` maps ``id(node)`` → ``{node, weight, weight_slot,
    act_slots, active}`` for every matmul-class node whose weight
    resolves (through casts) to a non-aux variable; ``weights`` maps a
    qualified weight variable's NAME → ``{axis, elems, shape, sites}``
    (a site is ``active`` iff its weight qualified); ``skipped``
    records (name, reason) for weights the plan declined; ``observe``
    lists the activation entries calibration should watch, named by
    :func:`entry_name` of their through-cast producer so the keys are
    stable across bf16 composition."""

    def __init__(self, symbol):
        self.symbol = symbol
        self.sites = {}
        self.weights = {}
        self.skipped = []
        self.observe = []       # (entry_name, node, out_idx)
        self.n_f32_islands = 0
        self.min_layer_elems = 0
        self._shp = None
        self._dt = None

    @property
    def n_sites(self):
        return sum(1 for s in self.sites.values() if s["active"])

    @property
    def n_weights(self):
        return len(self.weights)

    @property
    def weight_bytes_saved(self):
        """Exact bytes the int8 weight storage removes: f32 (4 B) →
        int8 (1 B) per element of every qualified weight."""
        return sum(3 * w["elems"] for w in self.weights.values())

    def summary(self):
        return ("quant_plan: %d quantizable site(s), %d int8 weight(s) "
                "(%.1f KB saved), %d activation entr%s to calibrate, "
                "%d f32 island(s), %d weight(s) skipped"
                % (self.n_sites, self.n_weights,
                   self.weight_bytes_saved / 1024.0, len(self.observe),
                   "y" if len(self.observe) == 1 else "ies",
                   self.n_f32_islands, len(self.skipped)))

    def to_findings(self, pass_name="quant_plan"):
        out = []
        for name, w in sorted(self.weights.items()):
            out.append(Finding(
                pass_name, INFO,
                "weight '%s' %s quantizes to per-channel int8 (axis %d, "
                "%d elems, saves %.1f KB) at site(s) %s"
                % (name, w["shape"], w["axis"], w["elems"],
                   3 * w["elems"] / 1024.0, ", ".join(w["sites"])),
                node=name, provenance=tuple(w["sites"])))
        for name, reason in self.skipped:
            out.append(Finding(
                pass_name, INFO,
                "weight '%s' stays f32: %s" % (name, reason), node=name))
        return out


def quant_plan(symbol, shapes=None, types=None, min_layer_elems=0):
    """License the int8 PTQ rewrite over ``symbol``; returns a
    :class:`QuantPlan`. Reuses :func:`precision_flow`'s classification
    — a node the bf16 rewrite would not touch (f32 island, non-float
    output) is never quantized either — then qualifies each
    matmul-class site's weight: it must resolve through casts to a
    non-aux variable ALL of whose consumer edges are quantizable
    weight slots (otherwise the f32 master would still stream
    alongside the int8 copy) and meet the ``min_layer_elems`` floor."""
    plan = QuantPlan(symbol)
    plan.min_layer_elems = int(min_layer_elems)
    pplan = precision_flow(symbol, shapes=shapes, types=types)
    plan.n_f32_islands = pplan.n_f32
    shp, dt, _ev = _prov.infer_walk(symbol, shapes, types)
    plan._shp, plan._dt = shp, dt
    topo = symbol._topo()
    aux = symbol._aux_node_set()
    consumers = {}
    nodes_by_id = {}
    for n in topo:
        nodes_by_id[id(n)] = n
        if n.is_variable:
            continue
        for i, (s, _idx) in enumerate(n.inputs):
            consumers.setdefault(id(s), []).append((n, i))
    # pass 1: the candidate sites and their weight variables
    weight_sites = {}
    for node in topo:
        if node.is_variable or node.op.name not in QUANT_COMPUTE:
            continue
        if pplan.classes.get(id(node)) != BF16_SAFE:
            continue
        names = node.op.input_names(node.parsed_attrs(),
                                    n=len(node.inputs))
        if "weight" not in names:
            continue
        w_slot = names.index("weight")
        act_slots = [i for i, nm in enumerate(names) if nm == "data"]
        var, _vidx = _through_casts(*node.inputs[w_slot])
        if not var.is_variable or id(var) in aux:
            continue
        plan.sites[id(node)] = {"node": node.name, "weight": var.name,
                                "weight_slot": w_slot,
                                "act_slots": act_slots, "active": False}
        weight_sites.setdefault(id(var), []).append(node)
    # pass 2: weight candidacy over ALL consumer edges of the variable
    for vid, sites in weight_sites.items():
        var = nodes_by_id[vid]
        ok = True
        stack = list(consumers.get(vid, ()))
        while stack and ok:
            c, i = stack.pop()
            if not c.is_variable and c.op.name == "Cast":
                nxt = consumers.get(id(c), ())
                if not nxt:
                    ok = False  # cast feeding a head: value escapes
                stack.extend(nxt)
                continue
            site = plan.sites.get(id(c))
            if site is None or site["weight_slot"] != i \
                    or site["weight"] != var.name:
                ok = False
        if not ok:
            plan.skipped.append(
                (var.name, "consumed beyond quantizable weight slots "
                           "(the f32 master would still have to stream)"))
            continue
        s = plan._shp.get(var.name)
        if s is None:
            plan.skipped.append((var.name, "shape unresolved — the "
                                           "per-channel scale count is "
                                           "unknowable"))
            continue
        elems = 1
        for d in s:
            elems *= int(d)
        if elems < plan.min_layer_elems:
            plan.skipped.append(
                (var.name, "under quant.min_layer_elems (%d < %d) — "
                           "dequant overhead beats the byte savings"
                 % (elems, plan.min_layer_elems)))
            continue
        plan.weights[var.name] = {"axis": 0, "elems": elems,
                                  "shape": tuple(s),
                                  "sites": [n.name for n in sites]}
        for n in sites:
            plan.sites[id(n)]["active"] = True
    # pass 3: the activation entries calibration observes — data-slot
    # inputs of ACTIVE sites, through casts, float-valued, non-variable
    seen = set()
    for node in topo:
        site = plan.sites.get(id(node))
        if site is None or not site["active"]:
            continue
        for i in site["act_slots"]:
            src, idx = _through_casts(*node.inputs[i])
            if src.is_variable:
                continue
            d = plan._dt.get((id(src), idx))
            if d is not None and not _is_float_dtype(d):
                continue
            name = entry_name(src, idx)
            if name in seen:
                continue
            seen.add(name)
            plan.observe.append((name, src, idx))
    return plan


# --------------------------------------------------------------- liveness
class LivenessInfo:
    """Result of :func:`liveness`.

    ``last_use`` maps an entry ``(id(node), out_idx)`` to the topo index
    of its final consumer (heads count as consumed at the end);
    ``live_bytes[i]`` is the estimated bytes of all entries live after
    executing topo node ``i``; ``peak_live_bytes``/``peak_node`` locate
    the high-water mark. Bytes come from the shared inference walk —
    entries whose shape did not resolve contribute 0 and flip
    ``complete`` to False (the estimate is then a lower bound)."""

    def __init__(self):
        self.last_use = {}
        self.entry_bytes = {}
        self.live_bytes = []
        self.peak_live_bytes = 0
        self.peak_node = None
        self.head_bytes = 0
        self.complete = True

    def live_set_at(self, i):
        """Entries live after topo step ``i`` (ids, for tests)."""
        return {e for e, last in self.last_use.items()
                if self._born[e] <= i < last}

    def to_findings(self, pass_name="liveness"):
        return [Finding(
            pass_name, INFO,
            "peak live %.1f KB at node '%s'%s; graph outputs hold "
            "%.1f KB" % (self.peak_live_bytes / 1024.0,
                         self.peak_node or "?",
                         "" if self.complete
                         else " (lower bound: some shapes unresolved)",
                         self.head_bytes / 1024.0),
            node=self.peak_node)]


def liveness(symbol, shapes=None, types=None):
    """Backward last-use + forward live-set sweep; returns
    :class:`LivenessInfo`. This is the analysis a future
    rematerialization/scheduling transform is licensed by; today it
    feeds the ``--pipeline`` report and cross-checks the diagnostics
    ledger's executor-output slot model."""
    shp, dt, _ev = _prov.infer_walk(symbol, shapes, types)
    topo = symbol._topo()
    index = {id(n): i for i, n in enumerate(topo)}
    info = LivenessInfo()
    # stash the walk maps so consumers that need shapes on top of
    # liveness (remat_reuse_plan runs on every pipeline build) don't
    # pay a second full-graph inference walk
    info._shp, info._dt = shp, dt
    n = len(topo)

    def nbytes(entry):
        s = shp.get(entry)
        if s is None:
            info.complete = False
            return 0
        d = dt.get(entry) or _np.dtype("float32")
        total = int(_prov.np_dtype(d).itemsize)
        for dim in s:
            total *= int(dim)
        return total

    born = {}
    for i, node in enumerate(topo):
        outs = 1 if node.is_variable else node.num_outputs()
        for k in range(outs):
            born[(id(node), k)] = i
            info.entry_bytes[(id(node), k)] = nbytes((id(node), k))
    info._born = born
    # backward: last consumer per entry; heads live to the end
    for i, node in enumerate(topo):
        for src, idx in node.inputs:
            e = (id(src), idx)
            info.last_use[e] = max(info.last_use.get(e, -1), i)
    for node, idx in symbol._outputs:
        info.last_use[(id(node), idx)] = n
        info.head_bytes += info.entry_bytes.get((id(node), idx), 0)
    # entries never consumed die at birth
    for e in born:
        info.last_use.setdefault(e, born[e])
    # forward sweep: running live-byte total, peak and its node
    live = 0
    expiring = {}
    for e, last in info.last_use.items():
        expiring.setdefault(last, []).append(e)
    for i, node in enumerate(topo):
        outs = 1 if node.is_variable else node.num_outputs()
        for k in range(outs):
            live += info.entry_bytes[(id(node), k)]
        if live > info.peak_live_bytes:
            info.peak_live_bytes = live
            info.peak_node = node.name
        for e in expiring.get(i, ()):
            live -= info.entry_bytes[e]
        info.live_bytes.append(live)
    return info


# ------------------------------------------------------------- conv layout
#: windowed spatial ops the NHWC retarget pays off for: the modeled
#: native-layout wrap (input+output transpose per op when fed NCHW) is
#: what the rewrite saves on the run interior
_LAYOUT_CORE = {"Convolution", "Pooling"}
#: layout-aware ops the rewrite retargets via an axis attribute (no wrap
#: benefit of their own; they ride the run)
_LAYOUT_AWARE = {"BatchNorm", "BatchNorm_v1"}
#: shape-polymorphic elementwise ops that compute identically in either
#: layout as long as every tensor input shares it (no channel-indexed
#: broadcast: broadcast_* / per-channel prelu are deliberately absent)
_LAYOUT_FLEX = {"Activation", "Dropout", "Cast", "negative", "_copy",
                "relu", "sigmoid", "tanh", "abs",
                "_plus", "elemwise_add", "_minus", "elemwise_sub",
                "_mul", "elemwise_mul", "_div", "elemwise_div",
                "_maximum", "_minimum",
                "_plus_scalar", "_minus_scalar", "_rminus_scalar",
                "_mul_scalar", "_div_scalar", "_rdiv_scalar",
                "_maximum_scalar", "_minimum_scalar", "clip"}


class LayoutPlan:
    """Result of :func:`conv_layout`.

    ``runs`` is a list of dicts, one per discovered conv/pool region:
    ``nodes`` (member ids), ``core`` (conv/pool member names),
    ``benefit_bytes`` (modeled native-layout wrap movement the interior
    saves), ``boundary_bytes`` (movement of the converts the rewrite
    would interpose at the region boundary), ``applied`` (benefit beats
    boundary AND every boundary shape resolved), plus informational
    ``entry_edges`` (``(consumer id, slot)`` pairs) / ``exit_entries``
    (``(producer id, out_idx, bytes)``) recording which boundary edges
    the cost model charged — the rewrite derives the actual convert
    sites from membership + ``data_slots``, these lists are for
    reports/tests. ``node_run`` maps member ``id(node)`` → run index;
    ``data_slots`` maps member id → the input slots that carry the
    feature map (the only edges converted)."""

    def __init__(self, symbol):
        self.symbol = symbol
        self.runs = []
        self.node_run = {}
        self.data_slots = {}
        self._shp = None   # inference-walk shapes, stashed by conv_layout

    @property
    def n_applied(self):
        return sum(1 for r in self.runs if r["applied"])

    def applied_members(self):
        """id(node) → run dict, for members of APPLIED runs only."""
        out = {}
        for r in self.runs:
            if r["applied"]:
                for nid in r["nodes"]:
                    out[nid] = r
        return out

    def summary(self):
        return ("conv_layout: %d run(s), %d applied; benefit %d KB vs "
                "boundary %d KB over applied runs"
                % (len(self.runs), self.n_applied,
                   sum(r["benefit_bytes"] for r in self.runs
                       if r["applied"]) // 1024,
                   sum(r["boundary_bytes"] for r in self.runs
                       if r["applied"]) // 1024))

    def to_findings(self, pass_name="conv_layout"):
        out = []
        for i, r in enumerate(self.runs):
            out.append(Finding(
                pass_name, INFO,
                "run %d (%d node(s), core: %s): interior wrap savings "
                "%.1f KB vs boundary converts %.1f KB — %s"
                % (i, len(r["nodes"]), ", ".join(r["core"]),
                   r["benefit_bytes"] / 1024.0,
                   r["boundary_bytes"] / 1024.0,
                   "NHWC applied" if r["applied"] else
                   "kept NCHW (%s)" % r["reason"]),
                node=r["core"][0] if r["core"] else None))
        return out


def _shape_bytes(shape, dtype):
    if shape is None:
        return 0
    total = int(_prov.np_dtype(dtype or _np.dtype("float32")).itemsize)
    for d in shape:
        total *= int(d)
    return total


def conv_layout(symbol, shapes=None, types=None):
    """Discover maximal conv/pool/BN regions that could compute NHWC and
    decide, per region, whether the modeled interior savings beat the
    boundary conversions (TVM's layout-transform rewrite, decided per
    graph). Returns a :class:`LayoutPlan` the ``layout`` transform is
    licensed by.

    Cost model (deterministic, platform-independent): a windowed spatial
    op fed its non-native layout pays an input and an output transpose
    in the backend (movement ``2*(in+out)`` bytes, read+write); ops
    inside a common-layout region pay only the region-boundary converts
    (``2*bytes`` per converted edge). A region applies when the summed
    interior wrap movement strictly beats the boundary movement."""
    shp, dt, _ev = _prov.infer_walk(symbol, shapes, types)
    topo = symbol._topo()
    plan = LayoutPlan(symbol)
    # stash the walk so apply_layout_plan (always run right after, on
    # every pipeline build) doesn't pay a second full-graph inference
    plan._shp = shp

    def eshape(node, idx=0):
        return shp.get((id(node), idx))

    def ebytes(node, idx=0):
        return _shape_bytes(shp.get((id(node), idx)),
                            dt.get((id(node), idx)))

    def rank4(node, idx=0):
        s = eshape(node, idx)
        return s is not None and len(s) == 4

    # -------------------------------------------------- eligibility
    kind = {}
    for node in topo:
        if node.is_variable:
            continue
        op = node.op.name
        try:
            a = node.parsed_attrs()
        except Exception:
            # allow-swallow(a node whose attrs do not parse is
            # simply ineligible for the layout run — the verifier's
            # shape_infer pass owns reporting the real error)
            continue
        if op in ("Convolution", "Convolution_v1"):
            if (len(tuple(a.kernel)) == 2 and int(a.num_group) == 1
                    and (a.get("layout") in (None, "NCHW"))
                    and rank4(node) and node.inputs
                    and rank4(*node.inputs[0])):
                kind[id(node)] = "core"
                plan.data_slots[id(node)] = (0,)
        elif op in ("Pooling", "Pooling_v1"):
            if ((a.get("layout") in (None, "NCHW"))
                    and rank4(node) and node.inputs
                    and rank4(*node.inputs[0])):
                kind[id(node)] = "core"
                plan.data_slots[id(node)] = (0,)
        elif op in _LAYOUT_AWARE:
            if (int(a.get("axis", 1)) == 1 and not a.output_mean_var
                    and rank4(node) and node.inputs
                    and rank4(*node.inputs[0])):
                kind[id(node)] = "aware"
                plan.data_slots[id(node)] = (0,)
        elif op in _LAYOUT_FLEX:
            out_s = eshape(node)
            if out_s is None or len(out_s) != 4:
                continue
            ok = all(eshape(s, i) == out_s for s, i in node.inputs)
            if ok:
                kind[id(node)] = "flex"
                plan.data_slots[id(node)] = tuple(
                    range(len(node.inputs)))

    # -------------------------------------------------- union runs
    parent = {nid: nid for nid in kind}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for node in topo:
        if id(node) not in kind:
            continue
        for slot in plan.data_slots[id(node)]:
            src, _idx = node.inputs[slot]
            if id(src) in kind:
                ra, rb = find(id(node)), find(id(src))
                if ra != rb:
                    parent[ra] = rb
    comps = {}
    node_of = {id(n): n for n in topo}
    for nid in kind:
        comps.setdefault(find(nid), set()).add(nid)

    # consumers per entry, for exit detection
    consumers = {}
    for n in topo:
        for i, (s, idx) in enumerate(n.inputs):
            consumers.setdefault((id(s), idx), []).append((n, i))
    head_entries = {(id(n), i) for n, i in symbol._outputs}

    order = {id(n): i for i, n in enumerate(topo)}
    for members in sorted(comps.values(),
                          key=lambda ms: min(order[m] for m in ms)):
        members = sorted(members, key=order.get)
        core = [node_of[nid].name for nid in members
                if kind[nid] == "core"]
        if not core:
            continue
        mset = set(members)
        entry_edges = []     # (consumer id, slot) — informational
        entry_cost_seen = set()
        exit_entries = []    # (producer id, out_idx, bytes)
        benefit = 0
        boundary = 0
        complete = True
        for nid in members:
            node = node_of[nid]
            if kind[nid] == "core":
                b_in = ebytes(*node.inputs[0])
                b_out = ebytes(node)
                if not b_in or not b_out:
                    complete = False
                benefit += 2 * (b_in + b_out)
            for slot in plan.data_slots[nid]:
                src, idx = node.inputs[slot]
                if id(src) in mset:
                    continue
                entry_edges.append((nid, slot))
                if (id(src), idx) not in entry_cost_seen:
                    entry_cost_seen.add((id(src), idx))
                    b = _shape_bytes(shp.get((id(src), idx)),
                                     dt.get((id(src), idx)))
                    if not b:
                        complete = False
                    boundary += 2 * b
            outs = node.num_outputs()
            for k in range(outs):
                if not rank4(node, k):
                    continue   # per-channel outputs are layout-free
                escapes = (id(node), k) in head_entries or any(
                    id(c) not in mset
                    for c, _ in consumers.get((id(node), k), ()))
                if escapes:
                    b = ebytes(node, k)
                    if not b:
                        complete = False
                    exit_entries.append((nid, k, b))
                    boundary += 2 * b
        applied = complete and benefit > boundary
        reason = ("boundary cost >= interior savings" if complete
                  else "unresolved boundary shape")
        run = {"nodes": mset, "core": core,
               "benefit_bytes": benefit, "boundary_bytes": boundary,
               "entry_edges": entry_edges, "exit_entries": exit_entries,
               "applied": applied, "reason": None if applied else reason}
        for nid in members:
            plan.node_run[nid] = len(plan.runs)
        plan.runs.append(run)
    return plan


# ------------------------------------------------------- recompute / remat
def _prod(xs):
    p = 1
    for x in xs:
        p *= int(x)
    return p


def recompute_flops(node, shp):
    """Static flop estimate for recomputing ``node``'s visible outputs
    (backward-remat cost ranking — relative order matters, absolute
    truth does not). Returns None when the shapes did not resolve."""
    out_s = shp.get((id(node), 0))
    if out_s is None or node.is_variable:
        return None
    n = _prod(out_s)
    op = node.op.name
    try:
        a = node.parsed_attrs()
    except Exception:
        # allow-swallow(an unparseable node simply has no flop
        # estimate — the analysis degrades to "not a remat candidate",
        # exactly like an unresolved shape)
        return None
    if op in ("Convolution", "Convolution_v1", "Deconvolution"):
        in_s = shp.get((id(node.inputs[0][0]), node.inputs[0][1]))
        if in_s is None or len(in_s) < 3:
            return None
        cin = in_s[3] if a.get("layout") == "NHWC" else in_s[1]
        return 2.0 * n * _prod(a.kernel) * cin / max(int(a.num_group), 1)
    if op == "FullyConnected":
        in_s = shp.get((id(node.inputs[0][0]), node.inputs[0][1]))
        if in_s is None:
            return None
        k = in_s[-1] if not a.get("flatten", True) else _prod(in_s[1:])
        return 2.0 * n * k
    if op in ("dot", "batch_dot"):
        in_s = shp.get((id(node.inputs[0][0]), node.inputs[0][1]))
        return 2.0 * n * (in_s[-1] if in_s else 1)
    if op in ("Pooling", "Pooling_v1"):
        kernel = tuple(a.kernel) if a.kernel else ()
        return float(n) * (_prod(kernel) if kernel else 1)
    if op in _F32_NORMS | {"softmax", "Softmax", "log_softmax",
                           "SoftmaxActivation", "LayerNorm"}:
        return 8.0 * n
    if op in _F32_EXPLOG | _F32_MISC:
        return 4.0 * n
    # elementwise / shape ops: about one flop (or less) per element
    return float(n)


class RematReusePlan:
    """Result of :func:`remat_reuse_plan`.

    ``remat`` — node ids whose visible outputs the backward should
    RECOMPUTE instead of holding as residuals (recompute-flops per byte
    at or under ``threshold``); ``reuse_pairs`` — ``(dead, newborn)``
    entry pairs where the dead entry's storage can serve the newborn
    same-shape/dtype allocation (buffer-reuse/aliasing hints);
    ``residual_peak_before/after`` — peak live bytes of the liveness
    walk under the training-residency model (op entries persist to the
    end of the forward as backward residuals; remat-annotated entries
    die at their forward last use instead)."""

    def __init__(self, symbol, threshold):
        self.symbol = symbol
        self.threshold = float(threshold)
        self.remat = set()          # node ids
        self.remat_names = []
        self.remat_bytes = 0
        self.remat_flops = 0.0
        self.reuse_pairs = []       # (dead_name, newborn_name, bytes)
        self.reuse_bytes = 0
        self.residual_peak_before = 0
        self.residual_peak_after = 0
        self.complete = True

    @property
    def peak_cut_pct(self):
        if not self.residual_peak_before:
            return 0.0
        return round(100.0 * (self.residual_peak_before
                              - self.residual_peak_after)
                     / self.residual_peak_before, 2)

    def summary(self):
        return ("remat_reuse: %d node(s) annotated for recompute "
                "(%.1f KB residuals dropped for %.0f flop/byte <= %.2f), "
                "%d reuse pair(s) (%.1f KB); residual peak %.1f -> %.1f "
                "KB (-%.1f%%)"
                % (len(self.remat), self.remat_bytes / 1024.0,
                   self.remat_flops / max(self.remat_bytes, 1),
                   self.threshold, len(self.reuse_pairs),
                   self.reuse_bytes / 1024.0,
                   self.residual_peak_before / 1024.0,
                   self.residual_peak_after / 1024.0,
                   self.peak_cut_pct))


def remat_reuse_plan(symbol, shapes=None, types=None, threshold=4.0):
    """Spend the liveness analysis: rank every op node's residual by
    recompute-flops per byte and annotate the cheap ones for backward
    recompute; pair dead entries with later same-shape/dtype births as
    buffer-reuse hints. Returns a :class:`RematReusePlan` the
    ``remat_reuse`` transform is licensed by."""
    info = liveness(symbol, shapes=shapes, types=types)
    shp, dt = info._shp, info._dt   # liveness already ran the walk
    topo = symbol._topo()
    n = len(topo)
    plan = RematReusePlan(symbol, threshold)
    plan.complete = info.complete
    head_nodes = {id(node) for node, _ in symbol._outputs}

    vis_entries = {}   # id(node) -> [(entry, bytes)] visible outputs
    for node in topo:
        if node.is_variable:
            continue
        n_vis = node.op.n_out(node.parsed_attrs())
        vis_entries[id(node)] = [
            ((id(node), k), info.entry_bytes.get((id(node), k), 0))
            for k in range(n_vis)]

    # ---- remat candidates: cheap-to-recompute residuals
    for node in topo:
        if node.is_variable or id(node) in head_nodes:
            continue
        ebs = vis_entries[id(node)]
        total = sum(b for _, b in ebs)
        if total <= 0:
            continue
        fl = recompute_flops(node, shp)
        if fl is None:
            continue
        if fl / total <= plan.threshold:
            plan.remat.add(id(node))
            plan.remat_names.append(node.name)
            plan.remat_bytes += total
            plan.remat_flops += fl

    # ---- residual-model peak: op entries persist to end-of-forward
    # (they are backward's residuals) unless remat-annotated
    node_by_id = {id(t): t for t in topo}

    def residual_peak(remat):
        live = 0
        peak = 0
        expiring = {}
        for e, last in info.last_use.items():
            nid = e[0]
            node = node_by_id.get(nid)
            horizon = last
            if node is not None and not node.is_variable \
                    and nid not in remat:
                horizon = n
            expiring.setdefault(horizon, []).append(e)
        for i, node in enumerate(topo):
            outs = 1 if node.is_variable else node.num_outputs()
            for k in range(outs):
                live += info.entry_bytes.get((id(node), k), 0)
            if live > peak:
                peak = live
            for e in expiring.get(i, ()):
                live -= info.entry_bytes.get(e, 0)
        return peak

    plan.residual_peak_before = residual_peak(set())
    plan.residual_peak_after = residual_peak(plan.remat)

    # ---- buffer-reuse hints: dead entry -> later same-shape/dtype birth
    born = info._born
    pool = {}   # (shape, dtype) -> [(death_index, entry)]
    names = {}
    for node in topo:
        outs = 1 if node.is_variable else node.num_outputs()
        for k in range(outs):
            names[(id(node), k)] = node.name if k == 0 \
                else "%s[%d]" % (node.name, k)
    for i, node in enumerate(topo):
        if node.is_variable:
            continue
        for e, b in vis_entries[id(node)]:
            if b <= 0:
                continue
            key = (shp.get(e), str(dt.get(e)))
            # claim an already-dead same-class buffer for this birth
            cands = pool.get(key)
            claimed = None
            if cands:
                for j, (death, dead_e) in enumerate(cands):
                    if death < born[e]:
                        claimed = cands.pop(j)
                        break
            if claimed is not None:
                plan.reuse_pairs.append(
                    (names[claimed[1]], names[e], b))
                plan.reuse_bytes += b
            last = info.last_use.get(e, born[e])
            if last < n:   # heads never die; they can't donate
                pool.setdefault(key, []).append((last, e))
    return plan


# -------------------------------------------------- optimizer update fusion
class UpdateFusionPlan:
    """Result of :func:`update_fusion_plan`: trainable parameters grouped
    into (dtype, shape) classes with at least two members — the classes
    whose per-parameter optimizer-update chains the fused train step can
    collapse into one batched region each."""

    def __init__(self, symbol):
        self.symbol = symbol
        self.classes = {}    # "f32:128x128" -> [param names]
        self.n_params = 0

    @property
    def n_fused(self):
        return sum(len(v) for v in self.classes.values())

    def summary(self):
        return ("update_fusion: %d of %d parameter(s) in %d batched "
                "class(es): %s"
                % (self.n_fused, self.n_params, len(self.classes),
                   "; ".join("%s×%d" % (k, len(v))
                             for k, v in self.classes.items()) or "-"))


def class_key(shape, dtype):
    """Canonical dtype/shape class label (the ``__update_class__``
    annotation value): e.g. ``"float32:128x64"``."""
    return "%s:%s" % (_prov.dtype_name(dtype or "float32"),
                      "x".join(str(int(d)) for d in shape))


def update_fusion_plan(symbol, shapes=None, types=None, trainable=None,
                       max_member_bytes=32768):
    """Group parameter variables by (dtype, shape) class; classes with
    ≥2 members are batchable by the fused step's optimizer update.
    ``trainable`` (names) restricts the grouping; without it every
    non-aux variable with a resolved shape is considered — consumers
    intersect with their own trainable set before acting.

    ``max_member_bytes`` bounds the class to SMALL parameters (biases,
    BN scales, per-channel vectors): their per-parameter update chains
    are launch-overhead-bound — each is a tiny kernel whose fixed cost
    dominates — so batching k of them into one region is a pure win,
    while the stack/unstack a batched region needs is real data
    movement that a bandwidth-bound weight-matrix chain would only pay
    for (measured: stacking the 128×128 weight class GREW bytes-accessed
    44% on the host AOT row). The threshold is a declared knob
    (``compile.fuse_opt_max_kb``) so the tune search can move it."""
    shp, dt, _ev = _prov.infer_walk(symbol, shapes, types)
    aux = symbol._aux_node_set()
    plan = UpdateFusionPlan(symbol)
    tset = set(trainable) if trainable is not None else None
    groups = {}
    for node in symbol._topo():
        if not node.is_variable or id(node) in aux:
            continue
        if tset is not None and node.name not in tset:
            continue
        s = shp.get(node.name)
        if s is None or not len(s):
            continue
        plan.n_params += 1
        if max_member_bytes is not None \
                and _shape_bytes(s, dt.get(node.name)) > max_member_bytes:
            continue
        groups.setdefault(class_key(s, dt.get(node.name)),
                          []).append(node.name)
    plan.classes = {k: v for k, v in groups.items() if len(v) >= 2}
    return plan


def liveness_ledger_check(executor):
    """Cross-check the liveness estimate against the diagnostics
    ledger's slot model for a live executor (mxtpu :1154-1177): the
    entries still live at the end of the walk are exactly the graph
    outputs, and the ledger's ``executor_outputs`` slot accounts those
    same tensors. Returns a list of findings (empty = consistent); []
    when the ledger is disabled or the executor has not run yet."""
    from .. import diagnostics as _diag
    slot = getattr(executor, "_out_slot", None)
    if not _diag.mem_enabled() or slot is None:
        return []
    shapes = {n: tuple(v.shape) for n, v in executor.arg_dict.items()}
    types = {n: v.dtype for n, v in executor.arg_dict.items()}
    info = liveness(executor._symbol, shapes=shapes, types=types)
    actual = slot._nbytes
    if info.complete and info.head_bytes != actual:
        return [Finding(
            "liveness", WARNING,
            "liveness says the graph outputs hold %d bytes but the "
            "ledger's executor_outputs slot accounts %d — the estimate "
            "and the slot model drifted" % (info.head_bytes, actual),
            fix_hint="check dtype handling in liveness() vs the "
                     "executor's _account_outputs slot accounting")]
    return []
