"""Transform passes over the Symbol IR: analysis-licensed graph rewrites.

Counterpart of ``mxtpu/analysis/rewrite.py``: the same catalog, the same
rewritten graphs (``tojson()`` byte for byte) and the same actions. The
port's executor honours the annotations: NHWC convolution, pooling and
``axis=3`` BatchNorm run channels-last, ``__q8`` weights stream int8
through ``dequantize_int8``, the fused step updates each
``__update_class__`` with one foreach call, and it checkpoints the
``__remat__`` nodes (``torch.utils.checkpoint``).

The verifier passes (:mod:`~mxtpu_torch.analysis.passes`) *check* graphs; a
:class:`TransformPass` *changes* one — and the discipline that makes the
combination safe is enforced one level up, in
:func:`mxtpu_torch.compile.pipeline.transform_graph`: every rewrite must be
licensed by a dataflow fact computed beforehand
(:mod:`~mxtpu_torch.analysis.dataflow`) and is re-proven by the full verifier
suite afterwards; a transform whose output graph fails a verifier pass
is REJECTED with the offending Finding and the build falls back to the
unrewritten graph. A transform can therefore never ship a graph the
checker would refuse.

The registered catalog (canonical composition order —
:data:`CANONICAL_ORDER` — is how the pipeline sequences them however
the operator lists them):

* ``layout`` — data-layout selection for conv stacks: the
  :func:`~mxtpu_torch.analysis.dataflow.conv_layout` analysis finds maximal
  conv/pool/BN regions and the rewrite retargets a region to NHWC
  (conv/pool ``layout`` attr, BatchNorm ``axis``) with transpose nodes
  interposed at the region boundary — only where the modeled interior
  savings beat the boundary conversions (TVM's layout-transform
  rewrite, decided per graph). Weights keep their OIHW storage.
* ``bf16`` — the mixed-precision rewrite. Matmul-class compute and its
  elementwise followers run in bf16 (Cast nodes inserted at the class
  boundaries the precision-flow analysis computed); dtype-sensitive
  islands stay f32; parameters keep f32 master storage and are cast at
  their use sites; graph outputs are cast back to their original dtype.
* ``fuse_opt`` — optimizer-update fusion: the
  :func:`~mxtpu_torch.analysis.dataflow.update_fusion_plan` analysis groups
  trainable parameters into dtype/shape classes and the rewrite stamps
  ``__update_class__`` on each groupable parameter; the fused train
  step collapses every annotated class's per-parameter
  grad→update→assign chains into ONE batched update region.
* ``remat_reuse`` — spends the liveness analysis: stamps ``__remat__``
  on nodes whose residuals are cheap to recompute
  (:func:`~mxtpu_torch.analysis.dataflow.remat_reuse_plan`), which the fused
  step recomputes in the backward (a selective checkpoint policy), and
  records buffer-reuse (aliasing) hints for dead-before-birth
  same-shape/dtype entry pairs.
"""
from __future__ import annotations

from ..base import MXNetError
from .findings import INFO, Finding
from . import dataflow as _df
from . import provenance as _prov

__all__ = ["TransformPass", "TransformContext", "register_transform",
           "get_transform", "list_transforms", "Bf16MixedPrecisionPass",
           "ConvLayoutPass", "OptimizerUpdateFusionPass",
           "RematReusePass", "QuantizePass", "apply_precision_plan",
           "apply_layout_plan", "apply_quant_plan", "CANONICAL_ORDER"]

#: The canonical composition order. ``layout`` must see the conv runs
#: before bf16's Casts could split them; ``bf16`` classifies the
#: layout-retargeted graph (transposes follow their producers);
#: ``quant`` runs after bf16 so its weight resolution sees (and
#: replaces) the ``*_amp`` casts and its dequant nodes emit the bf16
#: the rewritten consumers expect; ``fuse_opt`` and ``remat_reuse``
#: only annotate, but ``remat_reuse`` runs last so its liveness walk
#: sees the final node set.
CANONICAL_ORDER = ("layout", "bf16", "quant", "fuse_opt", "remat_reuse")

_TRANSFORMS = {}


def register_transform(cls):
    """Class decorator: register a TransformPass subclass under
    ``cls.name`` (same shape as the verifier-pass registry)."""
    inst = cls()
    if not inst.name:
        raise MXNetError("TransformPass must define a name")
    _TRANSFORMS[inst.name] = inst
    return cls


def get_transform(name):
    if name not in _TRANSFORMS:
        raise MXNetError(
            "transform pass '%s' is not registered (have: %s)"
            % (name, ", ".join(sorted(_TRANSFORMS)) or "none"))
    return _TRANSFORMS[name]


def list_transforms():
    """Registered transforms in registration order: [(name, doc)]."""
    return [(name, t.describe()) for name, t in _TRANSFORMS.items()]


class TransformContext:
    """Everything a transform may read, plus where it records what it
    did. ``actions`` collects INFO findings (per-node provenance — the
    ``--pipeline`` report surface); a transform appends there and
    returns the rewritten Symbol (or None for "no change").

    ``values`` (executor builds only) maps bound parameter names to
    their live arrays — a weight-materializing pass (``quant``) reads
    scales off them and NEVER mutates them. :meth:`add_hint` declares
    a variable the transform INTRODUCED (a new argument the original
    graph cannot infer); the pipeline folds the hints into the
    shape/dtype maps the post-rewrite verifier suite runs with.
    ``prepared_args`` is the pass's contract with the executor: each
    entry names a new argument the executor must materialize from an
    existing one (``{new: {"src", "scale", "axis"}}`` — computed once
    per weight version, streamed to the program in place of the f32
    master)."""

    def __init__(self, symbol, kind=None, shapes=None, types=None,
                 module=None, values=None):
        self.symbol = symbol
        self.kind = kind
        self.shapes = dict(shapes or {})
        self.types = dict(types or {})
        self.module = module
        self.values = dict(values or {})
        self.actions = []
        self.hint_shapes = {}
        self.hint_types = {}
        self.prepared_args = {}

    def add_hint(self, name, shape=None, dtype=None):
        """Pin an introduced variable's shape/dtype for the verifier
        re-run (and for every later pass in the composition)."""
        if shape is not None:
            self.hint_shapes[name] = tuple(shape)
            self.shapes[name] = tuple(shape)
        if dtype is not None:
            self.hint_types[name] = dtype
            self.types[name] = dtype


class TransformPass:
    """Base class: subclass, set ``name``, implement ``run(tctx)``
    returning a NEW Symbol (the input graph must not be mutated — the
    pipeline needs the original for fallback) or None for no change.

    Every registered pass must also declare its **rewrite algebra** —
    the name of the closed edit set its rewrite stays inside, checked
    per-build by :mod:`mxtpu_torch.analysis.equiv` when the pipeline's
    certification gate is armed (``MXTPU_PIPELINE_CERT``).  A pass
    without a declared algebra is refused by the gate and flagged by
    ``tools/mxtpu_lint.py``.  ``license`` names the dataflow analysis
    that licenses the rewrite and ``knobs`` the tune-registry knobs it
    resolves — both pinned against docs/compile.md's catalog table by
    the docs-rot guard."""

    name = None
    #: rewrite-algebra name from mxtpu.analysis.equiv.ALGEBRAS
    algebra = None
    #: licensing dataflow analysis (docs/compile.md catalog column)
    license = None
    #: tune-registry knob names the pass resolves
    knobs = ()

    def describe(self):
        return (self.__doc__ or "").strip().split("\n")[0]

    def run(self, tctx):
        raise NotImplementedError

    def action(self, tctx, message, **kw):
        f = Finding(self.name, INFO, message, **kw)
        tctx.actions.append(f)
        return f


# ----------------------------------------------------------- bf16 rewrite
def apply_precision_plan(symbol, plan, dtypes, actions=None,
                         pass_name="bf16"):
    """Clone ``symbol`` with Cast nodes realizing ``plan`` (a
    :class:`~mxtpu_torch.analysis.dataflow.PrecisionPlan`): every f32 value
    entering a bf16-safe node is cast down, every bf16 value entering an
    f32 island is cast back up, and heads keep their original dtype.
    Variables are SHARED with the original graph (the rewrite adds no
    arguments, so bind dicts/checkpoints are unchanged); op nodes are
    cloned. Aux-slot inputs (BatchNorm moving stats) are never cast —
    the executor's aux-update writeback requires the variable wired
    directly."""
    from ..ops.registry import get_op
    from ..symbol.symbol import _Node, Symbol
    cast_op = get_op("Cast")
    topo = symbol._topo()
    mapping = {}
    casts = {}
    if actions is None:
        actions = []

    def rewritten_dtype(src, idx):
        """What arrives on this edge AFTER the rewrite: 'bf16' when the
        producer is a bf16-class op whose original f32 output now
        computes in bf16; 'f32' for castable f32 values; 'other' for
        non-f32 dtypes (ints, bools, already-bf16) the rewrite leaves
        alone."""
        dt = dtypes.get((id(src), idx))
        if dt is not None and _prov.dtype_name(dt) != "float32":
            return "other"
        if not src.is_variable \
                and plan.classes.get(id(src)) == _df.BF16_SAFE:
            return "bf16"
        # unknown dtype: treat as f32 only for op outputs (variables
        # without hints default f32 in _infer_graph anyway)
        return "f32"

    def cast_of(entry_node, idx, to):
        key = (id(entry_node), idx, to)
        hit = casts.get(key)
        if hit is not None:
            return hit
        base = entry_node.name if idx == 0 \
            else "%s_o%d" % (entry_node.name, idx)
        node = _Node(cast_op, "%s_%s_amp" % (base, to),
                     {"dtype": "bfloat16" if to == "bf16" else "float32"},
                     [(entry_node, idx)])
        casts[key] = node
        return node

    for node in topo:
        if node.is_variable:
            mapping[id(node)] = node
            continue
        cls = plan.classes.get(id(node), _df.F32_ISLAND)
        aux_slots = set()
        if node.op.aux_names:
            names = node.op.input_names(node.parsed_attrs(),
                                        n=len(node.inputs))
            aux_slots = {i for i, nm in enumerate(names)
                         if nm in node.op.aux_names}
        new_inputs = []
        cast_in = []
        for i, (src, idx) in enumerate(node.inputs):
            nsrc = mapping[id(src)]
            rdt = rewritten_dtype(src, idx)
            if i in aux_slots:
                new_inputs.append((nsrc, idx))
            elif cls == _df.BF16_SAFE and rdt == "f32":
                new_inputs.append((cast_of(nsrc, idx, "bf16"), 0))
                cast_in.append(src.name)
            elif cls == _df.F32_ISLAND and rdt == "bf16":
                new_inputs.append((cast_of(nsrc, idx, "f32"), 0))
                cast_in.append(src.name)
            else:
                new_inputs.append((nsrc, idx))
        clone = _Node(node.op, node.name, dict(node.attrs), new_inputs)
        clone._extra_attrs = dict(node._extra_attrs)
        mapping[id(node)] = clone
        if cls == _df.BF16_SAFE:
            actions.append(Finding(
                pass_name, INFO,
                "node '%s' (op %s) computes in bf16%s — licensed by "
                "precision_flow: %s"
                % (node.name, node.op.name,
                   "; cast-at-use: %s" % ", ".join(cast_in)
                   if cast_in else "",
                   plan.reasons.get(id(node), "bf16-safe")),
                node=node.name,
                provenance=tuple(cast_in)))
        elif cast_in:
            actions.append(Finding(
                pass_name, INFO,
                "node '%s' (op %s) stays an f32 island; bf16 inputs "
                "cast back up: %s — %s"
                % (node.name, node.op.name, ", ".join(cast_in),
                   plan.reasons.get(id(node), "dtype-sensitive")),
                node=node.name,
                provenance=tuple(cast_in)))
    heads = []
    for node, idx in symbol._outputs:
        nnode = mapping[id(node)]
        if not node.is_variable and rewritten_dtype(node, idx) == "bf16":
            actions.append(Finding(
                pass_name, INFO,
                "graph output '%s'[%d] cast back to f32 (output dtype "
                "contract preserved for metrics/serving/sanitizer)"
                % (node.name, idx), node=node.name))
            heads.append((cast_of(nnode, idx, "f32"), 0))
        else:
            heads.append((nnode, idx))
    return Symbol(heads)


@register_transform
class Bf16MixedPrecisionPass(TransformPass):
    """bf16 mixed-precision rewrite: MXU-class compute and its
    elementwise followers in bf16, f32 islands where precision-flow
    demands, f32 master weights cast at use, outputs cast back."""

    name = "bf16"
    algebra = "cast_boundaries"
    license = "precision_flow"
    knobs = ()

    def run(self, tctx):
        plan = _df.precision_flow(tctx.symbol, shapes=tctx.shapes,
                                  types=tctx.types)
        if plan.n_bf16 == 0:
            self.action(tctx, "no bf16-safe nodes in this graph "
                        "(%s) — rewrite skipped" % plan.summary())
            return None
        _shapes, dtypes, _ev = _prov.infer_walk(
            tctx.symbol, tctx.shapes, tctx.types)
        new_sym = apply_precision_plan(tctx.symbol, plan, dtypes,
                                       actions=tctx.actions,
                                       pass_name=self.name)
        self.action(
            tctx, "%s; %d master-weight parameter(s) stay f32 in the "
            "fused state" % (plan.summary(), plan.n_master))
        return new_sym


# ----------------------------------------------------------- quant rewrite
def apply_quant_plan(symbol, plan, weight_scales, act_scales=None,
                     actions=None, pass_name="quant"):
    """Clone ``symbol`` realizing ``plan`` (a
    :class:`~mxtpu_torch.analysis.dataflow.QuantPlan`): every qualified
    weight's use edge is replaced by ``dequantize_int8`` over a NEW int8
    variable (``<weight>__q8`` — the f32 master drops out of the
    program's arguments; the executor streams the prepared int8 copy
    instead), and every calibrated activation edge into an active site
    gains a per-tensor ``quantize_int8``/``dequantize_int8`` pair.
    ``weight_scales`` maps weight name → ``(scales_tuple, axis)``;
    ``act_scales`` maps observed entry name → per-tensor scale. Dequant
    outputs keep the dtype the replaced edge carried (bf16 under a
    composed ``bf16`` pass), so consumers are byte-compatible.

    Returns ``(new_symbol, prepared, counts)`` — ``prepared`` is the
    executor contract ``{new_arg: {"src", "scale", "axis"}}``;
    ``counts`` has exact ``dequant`` / ``act_qdq`` node tallies (the
    bench basis)."""
    from ..ops.registry import get_op
    from ..symbol.symbol import _Node, Symbol
    q_op = get_op("quantize_int8")
    dq_op = get_op("dequantize_int8")
    act_scales = act_scales or {}
    if actions is None:
        actions = []
    mapping = {}
    w_dq = {}       # (weight name, out dtype) -> shared dequant node
    q_vars = {}     # weight name -> the int8 variable node
    a_qdq = {}      # (id(orig src), idx, out dtype) -> shared QDQ tail
    prepared = {}
    counts = {"dequant": 0, "act_qdq": 0}

    def edge_dtype(src, idx):
        d = plan._dt.get((id(src), idx)) if plan._dt else None
        return _prov.dtype_name(d) if d is not None else "float32"

    def weight_dq(wname, out_dt):
        key = (wname, out_dt)
        hit = w_dq.get(key)
        if hit is not None:
            return hit
        scales, axis = weight_scales[wname]
        qv = q_vars.get(wname)
        if qv is None:
            qv = _Node(None, wname + "__q8", {}, [])
            q_vars[wname] = qv
            prepared[wname + "__q8"] = {"src": wname,
                                        "scale": tuple(scales),
                                        "axis": int(axis)}
        node = _Node(dq_op, "%s__dq" % wname if out_dt == "float32"
                     else "%s__dq_%s" % (wname, out_dt),
                     {"scale": tuple(scales), "axis": int(axis),
                      "out_dtype": out_dt}, [(qv, 0)])
        w_dq[key] = node
        counts["dequant"] += 1
        return node

    def act_qdq_of(nsrc, src, idx, sname, out_dt, consumer):
        key = (id(src), idx, out_dt)
        hit = a_qdq.get(key)
        if hit is not None:
            return hit
        s = (float(act_scales[sname]),)
        base = _df.entry_name(src, idx)
        q = _Node(q_op, "%s__q8" % base, {"scale": s, "axis": -1},
                  [(nsrc, idx)])
        dq = _Node(dq_op, "%s__dq" % base,
                   {"scale": s, "axis": -1, "out_dtype": out_dt},
                   [(q, 0)])
        a_qdq[key] = dq
        counts["dequant"] += 1
        counts["act_qdq"] += 1
        actions.append(Finding(
            pass_name, INFO,
            "activation '%s' into '%s' quantizes per-tensor to int8 "
            "(calibrated scale %.6g) and dequantizes to %s at the "
            "consumer" % (sname, consumer, s[0], out_dt),
            node=consumer, provenance=(sname,)))
        return dq

    for node in symbol._topo():
        if node.is_variable:
            mapping[id(node)] = node
            continue
        site = plan.sites.get(id(node))
        active = site is not None and site["active"] \
            and site["weight"] in weight_scales
        new_inputs = []
        for i, (src, idx) in enumerate(node.inputs):
            nsrc = mapping[id(src)]
            if active and i == site["weight_slot"]:
                new_inputs.append(
                    (weight_dq(site["weight"], edge_dtype(src, idx)), 0))
            elif active and i in site["act_slots"]:
                base_node, bidx = _df._through_casts(src, idx)
                sname = _df.entry_name(base_node, bidx)
                if base_node.is_variable or sname not in act_scales:
                    new_inputs.append((nsrc, idx))
                else:
                    new_inputs.append(
                        (act_qdq_of(nsrc, src, idx, sname,
                                    edge_dtype(src, idx), node.name), 0))
            else:
                new_inputs.append((nsrc, idx))
        clone = _Node(node.op, node.name, dict(node.attrs), new_inputs)
        clone._extra_attrs = dict(node._extra_attrs)
        mapping[id(node)] = clone
    heads = [(mapping[id(n)], i) for n, i in symbol._outputs]
    return Symbol(heads), prepared, counts


@register_transform
class QuantizePass(TransformPass):
    """int8 post-training quantization for inference programs: weights
    stream per-channel int8 (dequantized at use), calibrated activations
    gain per-tensor quantize/dequantize pairs, f32 islands and training
    kinds are never touched."""

    name = "quant"
    algebra = "qdq_streams"
    license = "quant_plan"
    knobs = ("quant.calibration_percentile", "quant.per_channel",
             "quant.min_layer_elems")

    #: build kinds the rewrite may touch. Training kinds must keep f32
    #: master weights wired for the optimizer update; the executor tags
    #: its eval-graph builds ``executor_infer`` (the serving pool's
    #: bucketed programs and the decode step both build through it).
    INFERENCE_KINDS = frozenset({"executor_infer", "fwd_eval", "infer",
                                 "serving", "decode"})

    def _decline(self, tctx, reason, message):
        from .. import telemetry as _tel
        _tel.counter(
            "quant_rejections", labels={"reason": reason},
            help="quant rewrite declines, by reason (the graph keeps "
                 "serving unquantized)").inc()
        self.action(tctx, message)
        return None

    def run(self, tctx):
        from .. import telemetry as _tel
        from ..compile import quant as _quant
        from ..tune import registry as _knobs
        if tctx.kind not in self.INFERENCE_KINDS:
            return self._decline(
                tctx, "not_inference",
                "inference-only pass: build kind %r trains or updates "
                "state, so parameters must keep their f32 masters — "
                "rewrite skipped" % (tctx.kind,))
        if not tctx.values:
            return self._decline(
                tctx, "no_values",
                "no bound parameter values in this build context — "
                "weight scales are unknowable offline; rewrite skipped")
        per_channel = bool(_knobs.resolve("quant.per_channel"))
        min_elems = int(_knobs.resolve("quant.min_layer_elems"))
        plan = _df.quant_plan(tctx.symbol, shapes=tctx.shapes,
                              types=tctx.types,
                              min_layer_elems=min_elems)
        # a planned weight with no bound value cannot be scaled — its
        # sites stay f32 (hot-swap bind dicts name every parameter, so
        # this only fires for exotic manual binds)
        for wname in [w for w in list(plan.weights)
                      if w not in tctx.values]:
            del plan.weights[wname]
            plan.skipped.append((wname, "no bound value to scale"))
            for site in plan.sites.values():
                if site["weight"] == wname:
                    site["active"] = False
        tctx.actions.extend(plan.to_findings(pass_name=self.name))
        if not plan.weights:
            return self._decline(
                tctx, "no_sites",
                "%s — rewrite skipped" % plan.summary())
        wscales = {}
        for wname, w in plan.weights.items():
            scales, axis = _quant.weight_scales(
                tctx.values[wname], axis=w["axis"],
                per_channel=per_channel)
            wscales[wname] = (scales, axis)
        # activation scales: the armed live recorder wins; otherwise
        # replay the persisted corpus capture (fault-pointed load —
        # a broken corpus degrades to weight-only, never a crash)
        act_scales = {}
        src_label = None
        rec = _quant.recorder()
        if rec is not None and rec.n_samples:
            act_scales = rec.scales()
            src_label = ("live calibration recorder (%d samples)"
                         % rec.n_samples)
        else:
            try:
                replay = _quant.replay_scales()
            except Exception as exc:
                _tel.counter(
                    "quant_rejections",
                    labels={"reason": "calibration_load"},
                    help="quant rewrite declines, by reason (the graph "
                         "keeps serving unquantized)").inc()
                self.action(
                    tctx, "calibration load failed (%s: %s) — "
                    "activations stay float (weight-only int8)"
                    % (type(exc).__name__, exc))
                replay = {}
            if replay:
                act_scales = replay
                src_label = "measurement-corpus replay"
        wanted = {name for name, _n, _i in plan.observe}
        act_scales = {k: v for k, v in act_scales.items() if k in wanted}
        new_sym, prepared, counts = apply_quant_plan(
            tctx.symbol, plan, wscales, act_scales,
            actions=tctx.actions, pass_name=self.name)
        for new, spec in prepared.items():
            w = plan.weights[spec["src"]]
            tctx.add_hint(new, shape=w["shape"], dtype="int8")
            tctx.prepared_args[new] = spec
        if act_scales:
            self.action(
                tctx, "%d/%d activation entr%s quantized with per-"
                "tensor scales from %s"
                % (counts["act_qdq"], len(plan.observe),
                   "y" if counts["act_qdq"] == 1 else "ies", src_label))
        elif plan.observe:
            self.action(
                tctx, "no calibration stats for the %d activation "
                "entr%s — weight-only int8 (arm MXTPU_QUANT_CALIB or "
                "quant.calibration_scope() during representative "
                "traffic, or persist a corpus capture to replay)"
                % (len(plan.observe),
                   "y" if len(plan.observe) == 1 else "ies"))
        _tel.gauge(
            "quant_bytes_saved",
            help="weight bytes removed from the program's argument "
                 "stream by the last applied quant rewrite").set(
            plan.weight_bytes_saved)
        self.action(
            tctx, "%s; %d dequantize node(s) interposed (%d weight, %d "
            "activation); %s per-channel weight scales"
            % (plan.summary(), counts["dequant"],
               counts["dequant"] - counts["act_qdq"], counts["act_qdq"],
               "axis-0" if per_channel else "per-tensor (knob off)"))
        return new_sym


# ------------------------------------------------------ annotation clones
def _annotate_clone(symbol, node_extra=None, var_extra=None):
    """Clone ``symbol`` with extra attrs stamped on selected nodes.
    ``node_extra``/``var_extra`` map ``id(original node)`` → attr dict.
    Un-annotated variables stay SHARED with the original graph (same
    contract as the bf16 rewrite: no new arguments, bind dicts and
    checkpoints unchanged); annotated variables and all op nodes are
    cloned, so the original graph — the pipeline's fallback — is never
    mutated."""
    from ..symbol.symbol import Symbol, _Node
    node_extra = node_extra or {}
    var_extra = var_extra or {}
    mapping = {}
    for node in symbol._topo():
        if node.is_variable:
            extra = var_extra.get(id(node))
            if extra:
                clone = _Node(None, node.name, {}, [])
                clone._extra_attrs = dict(node._extra_attrs)
                clone._extra_attrs.update(extra)
                mapping[id(node)] = clone
            else:
                mapping[id(node)] = node
            continue
        new_inputs = [(mapping[id(s)], i) for s, i in node.inputs]
        clone = _Node(node.op, node.name, dict(node.attrs), new_inputs)
        clone._extra_attrs = dict(node._extra_attrs)
        extra = node_extra.get(id(node))
        if extra:
            clone._extra_attrs.update(extra)
        mapping[id(node)] = clone
    return Symbol([(mapping[id(n)], i) for n, i in symbol._outputs])


# --------------------------------------------------------- layout rewrite
def apply_layout_plan(symbol, plan, shapes=None, types=None):
    """Clone ``symbol`` realizing ``plan`` (a
    :class:`~mxtpu_torch.analysis.dataflow.LayoutPlan`): every member of an
    APPLIED run is retargeted to channels-last (conv/pool ``layout``
    attr, BatchNorm ``axis=3``) and transpose nodes are interposed at
    exactly the run-boundary edges the plan costed. Parameters are
    untouched — conv weights keep OIHW storage and per-channel vectors
    are layout-free — so the rewrite adds no arguments and changes no
    parameter shapes."""
    from ..ops.registry import get_op
    from ..symbol.symbol import Symbol, _Node
    t_op = get_op("transpose")
    members = plan.applied_members()
    # conv_layout stashed its inference walk on the plan — reuse it
    # (the rewrite runs right after the analysis on every pipeline
    # build; a second full-graph walk here doubled the pass cost)
    shp = plan._shp if getattr(plan, "_shp", None) is not None \
        else _prov.infer_walk(symbol, shapes, types)[0]
    mapping = {}
    converts = {}

    def convert(entry_new, orig, idx, to):
        key = (id(orig), idx, to)
        hit = converts.get(key)
        if hit is not None:
            return hit
        base = orig.name if idx == 0 else "%s_o%d" % (orig.name, idx)
        axes = (0, 2, 3, 1) if to == "nhwc" else (0, 3, 1, 2)
        node = _Node(t_op, "%s_%s" % (base, to), {"axes": axes},
                     [(entry_new, idx)])
        converts[key] = node
        return node

    def produces_nhwc(src, idx):
        if src.is_variable or id(src) not in members:
            return False
        s = shp.get((id(src), idx))
        return s is not None and len(s) == 4

    for node in symbol._topo():
        if node.is_variable:
            mapping[id(node)] = node
            continue
        member = id(node) in members
        data_slots = set(plan.data_slots.get(id(node), ())) \
            if member else ()
        new_inputs = []
        for i, (src, idx) in enumerate(node.inputs):
            nsrc = mapping[id(src)]
            if member and i in data_slots and not produces_nhwc(src, idx):
                new_inputs.append((convert(nsrc, src, idx, "nhwc"), 0))
            elif not (member and i in data_slots) \
                    and produces_nhwc(src, idx):
                new_inputs.append((convert(nsrc, src, idx, "nchw"), 0))
            else:
                new_inputs.append((nsrc, idx))
        attrs = dict(node.attrs)
        if member:
            op = node.op.name
            if op in ("Convolution", "Convolution_v1",
                      "Pooling", "Pooling_v1"):
                attrs["layout"] = "NHWC"
            elif op in ("BatchNorm", "BatchNorm_v1"):
                attrs["axis"] = 3
        clone = _Node(node.op, node.name, attrs, new_inputs)
        clone._extra_attrs = dict(node._extra_attrs)
        mapping[id(node)] = clone
    heads = []
    for node, idx in symbol._outputs:
        nnode = mapping[id(node)]
        if produces_nhwc(node, idx):
            heads.append((convert(nnode, node, idx, "nchw"), 0))
        else:
            heads.append((nnode, idx))
    return Symbol(heads)


@register_transform
class ConvLayoutPass(TransformPass):
    """Data-layout selection for conv stacks: retarget conv/pool/BN runs
    to NHWC with boundary transposes, only where the conv_layout cost
    model says the interior savings beat the conversions."""

    name = "layout"
    algebra = "layout_runs"
    license = "conv_layout"
    knobs = ()

    def run(self, tctx):
        plan = _df.conv_layout(tctx.symbol, shapes=tctx.shapes,
                               types=tctx.types)
        tctx.actions.extend(plan.to_findings(pass_name=self.name))
        if plan.n_applied == 0:
            self.action(tctx, "%s — rewrite skipped" % plan.summary())
            return None
        new_sym = apply_layout_plan(tctx.symbol, plan,
                                    shapes=tctx.shapes, types=tctx.types)
        self.action(tctx, plan.summary())
        return new_sym


# ------------------------------------------------- optimizer-update fusion
@register_transform
class OptimizerUpdateFusionPass(TransformPass):
    """Optimizer-update fusion: stamp ``__update_class__`` on trainable
    parameters groupable by dtype/shape so the fused train step lowers
    one batched update region per class instead of a chain per
    parameter."""

    name = "fuse_opt"
    algebra = "annotation_only"
    license = "update_fusion_plan"
    knobs = ("compile.fuse_opt_max_kb",)

    def run(self, tctx):
        from ..tune import registry as _knobs
        trainable = None
        mod = tctx.module
        if mod is not None:
            params = getattr(mod, "_param_names", None)
            fixed = set(getattr(mod, "_fixed_param_names", ()) or ())
            if params:
                trainable = [p for p in params if p not in fixed]
        max_bytes = _knobs.resolve("compile.fuse_opt_max_kb") * 1024.0
        plan = _df.update_fusion_plan(tctx.symbol, shapes=tctx.shapes,
                                      types=tctx.types,
                                      trainable=trainable,
                                      max_member_bytes=max_bytes)
        if not plan.classes:
            self.action(tctx, "%s — no class with two or more same-"
                        "shape/dtype parameters; rewrite skipped"
                        % plan.summary())
            return None
        grouped = {}
        for key, names in plan.classes.items():
            for nm in names:
                grouped[nm] = key
        var_extra = {}
        for node in tctx.symbol._topo():
            if node.is_variable and node.name in grouped:
                var_extra[id(node)] = {
                    "__update_class__": grouped[node.name]}
        for key, names in plan.classes.items():
            self.action(
                tctx, "parameters %s fuse into one batched %s optimizer-"
                "update region — licensed by update_fusion (uniform "
                "dtype/shape class)" % (", ".join(names), key),
                provenance=tuple(names))
        self.action(tctx, plan.summary())
        return _annotate_clone(tctx.symbol, var_extra=var_extra)


# --------------------------------------------------------- remat + reuse
@register_transform
class RematReusePass(TransformPass):
    """Liveness-driven rematerialization + buffer-reuse hints: annotate
    cheap-to-recompute residuals with ``__remat__`` (the fused step
    drops them from the saved set) and record dead-entry→new-allocation
    aliasing pairs."""

    name = "remat_reuse"
    algebra = "annotation_only"
    license = "remat_reuse_plan"
    knobs = ("compile.remat_threshold",)

    def run(self, tctx):
        from ..tune import registry as _knobs
        threshold = _knobs.resolve("compile.remat_threshold")
        plan = _df.remat_reuse_plan(tctx.symbol, shapes=tctx.shapes,
                                    types=tctx.types,
                                    threshold=threshold)
        if not plan.remat and not plan.reuse_pairs:
            self.action(tctx, "%s — nothing annotated; rewrite skipped"
                        % plan.summary())
            return None
        node_extra = {nid: {"__remat__": "1"} for nid in plan.remat}
        # reuse hints stamp the REBORN entry's producer with its donor —
        # the annotation surface tools and the ledger cross-check read
        reborn = {}
        for dead, new, nbytes in plan.reuse_pairs:
            if "[" not in new:   # secondary outputs stay hint-only
                reborn[new] = dead
        for node in tctx.symbol._topo():
            if not node.is_variable and node.name in reborn:
                node_extra.setdefault(id(node), {})["__reuse__"] = \
                    reborn[node.name]
        for nm in plan.remat_names:
            self.action(
                tctx, "node '%s' residual recomputed in backward "
                "(recompute-flops/byte under %.2f at the residual peak) "
                "— licensed by remat_reuse over the liveness walk" %
                (nm, plan.threshold), node=nm)
        for dead, new, nbytes in plan.reuse_pairs:
            self.action(
                tctx, "entry '%s' dies before '%s' is born (same "
                "shape/dtype, %.1f KB) — buffer-reuse/aliasing hint"
                % (dead, new, nbytes / 1024.0), node=new,
                provenance=(dead,))
        self.action(tctx, plan.summary())
        from .. import telemetry as _tel
        _tel.gauge("transform_remat_bytes").set(plan.remat_bytes)
        _tel.gauge("transform_reuse_bytes").set(plan.reuse_bytes)
        return _annotate_clone(tctx.symbol, node_extra=node_extra)
