"""Graph-verifier pass framework over the Symbol IR.

Counterpart of ``mxtpu/analysis/passes.py``: the same seven passes, the
same findings, messages and severities. Two passes read live state that
is JAX's in mxtpu and torch's here: ``donation`` audits the port's fused
step, which updates the executors' bound tensors in place (no buffer is
donated or deleted, so mxtpu's deleted-buffer checks have no
counterpart; a host array that shares storage with an updated tensor is
the in-place form of mxtpu's donation alias), and
``sharding_consistency`` holds each replica's tensors to the blocks the
plan's ``ReplicaLayout`` gives it (mxtpu's ``NamedSharding`` check).
``donation`` also cross-checks the diagnostics ledger's ``fused_step``
slot against the live optimizer state and health scratch it accounts.

TVM demonstrates that a pass framework over the graph IR is where
correctness checks and diagnostics belong (PAPERS.md: "TVM: An Automated
End-to-End Optimizing Compiler"); mxtpu's L5 layer ran graphs without
ever *checking* them, so binding errors surfaced as late, low-context
failures. This module is the checking half: a registry of
:class:`GraphPass` objects driven by :func:`analyze`, each returning
structured :class:`~mxtpu_torch.analysis.Finding`\\ s (severity, node,
provenance, fix hint) instead of a bare exception string.

Surfaces: ``Symbol.lint()``, ``Module.check()``, and
``python -m mxtpu_torch.analysis model.json``.

Registered passes (see each class docstring):

* ``shape_infer``    — full shape/dtype inference walk with per-node
                       provenance (the verifier behind the sharpened
                       ``infer_shape`` errors)
* ``dead_code``      — dead JSON nodes, unconsumed multi-head outputs,
                       provided-but-unused / missing bind arguments
* ``name_collision`` — duplicate node names (bind dicts are name-keyed:
                       a collision silently drops one binding)
* ``ctx_groups``     — ``__ctx_group__`` tags vs the bind's group2ctx
                       map (an unmapped group is SILENTLY unplaced)
* ``donation``       — fused-step donation-safety audit: no buffer in
                       the donated (params, aux, opt_state) lists may be
                       read after donation; cross-checked against the
                       diagnostics ledger's slot model
* ``sharding_consistency`` — SPMD plan audit: spec-override axis typos
                       and rank mismatches, live state whose device
                       sharding drifted from the plan, mesh-active-but-
                       plan-declined, group2ctx/mesh placement overlap
* ``numerics``       — NaN-prone patterns: unclamped exp, unguarded log,
                       hand-rolled softmax, eps-free division by a
                       reduction
"""
from __future__ import annotations

from ..base import MXNetError
from .findings import ERROR, INFO, WARNING, Finding, Report
from . import provenance as _prov

__all__ = ["GraphPass", "PassContext", "register_pass", "get_pass",
           "list_passes", "analyze", "analyze_json", "check_module"]

_PASSES = {}


def register_pass(cls):
    """Class decorator: register a GraphPass subclass under ``cls.name``."""
    inst = cls()
    if not inst.name:
        raise MXNetError("GraphPass must define a name")
    _PASSES[inst.name] = inst
    return cls


def get_pass(name):
    if name not in _PASSES:
        raise MXNetError("analysis pass '%s' is not registered "
                         "(have: %s)" % (name, ", ".join(sorted(_PASSES))))
    return _PASSES[name]


def list_passes():
    """Registered passes in registration order: [(name, one_line_doc)]."""
    return [(name, p.describe()) for name, p in _PASSES.items()]


class PassContext:
    """Everything a pass may inspect. All fields except ``symbol`` are
    optional — a pass that needs an absent field returns no findings
    (static-analysis passes must degrade, not crash)."""

    def __init__(self, symbol, shapes=None, types=None, group2ctx=None,
                 module=None, args=None, aux=None, json_nodes=None,
                 json_heads=None):
        self.symbol = symbol
        self.shapes = dict(shapes or {})
        self.types = dict(types or {})
        self.group2ctx = group2ctx
        self.module = module
        self.args = args          # provided binding arg names (set/dict)
        self.aux = aux
        self.json_nodes = json_nodes  # raw node list of a loaded JSON graph
        self.json_heads = json_heads
        self._cache = {}

    def infer(self):
        """Memoized provenance walk (several passes read it)."""
        if "infer" not in self._cache:
            self._cache["infer"] = _prov.infer_walk(
                self.symbol, self.shapes, self.types)
        return self._cache["infer"]


def _node_by_name(symbol, name):
    for node in symbol._topo():
        if node.name == name:
            return node
    return None


class GraphPass:
    """Base class: subclass, set ``name``, implement ``run(ctx)``."""

    name = None

    def describe(self):
        return (self.__doc__ or "").strip().split("\n")[0]

    def run(self, ctx):
        raise NotImplementedError

    def finding(self, severity, message, **kw):
        return Finding(self.name, severity, message, **kw)


# --------------------------------------------------------------- shape/dtype
@register_pass
class ShapeInferPass(GraphPass):
    """Full shape/dtype inference walk; reports every node that cannot
    resolve, with the arg→node provenance path and the partially-
    inferred shape dict (the structured form of the sharpened
    ``infer_shape`` error)."""

    name = "shape_infer"

    def run(self, ctx):
        shapes, dtypes, events = ctx.infer()
        out = []
        summary = _prov.known_shape_summary(ctx.symbol, shapes)
        for ev in events:
            if ev["missing_inputs"]:
                # cascade suppression: a node whose ONLY unknown inputs
                # are other ops' outputs is downstream fallout of a root
                # failure already reported (variables render bare, op
                # entries as name[idx] — see provenance._entry_name)
                if not any("[" not in m for m in ev["missing_inputs"]):
                    continue
                node = _node_by_name(ctx.symbol, ev["node"])
                paths = _prov.unknown_root_paths(ctx.symbol, shapes, node) \
                    if node is not None else []
                roots = sorted({p[0] for p in paths})
                out.append(self.finding(
                    ERROR,
                    "cannot infer shapes at node '%s' (op %s): inputs %s "
                    "unknown" % (ev["node"], ev["op"],
                                 ", ".join(ev["missing_inputs"])),
                    node=ev["node"],
                    provenance=paths[0] if paths else (),
                    fix_hint="provide shapes for argument(s): %s"
                             % ", ".join(roots) if roots else None,
                    details={"partial_shapes": summary["inferred"],
                             "unknown_args": summary["unknown_args"]}))
            elif ev["exception"]:
                out.append(self.finding(
                    ERROR,
                    "shape/dtype inference failed at node '%s' (op %s): %s"
                    % (ev["node"], ev["op"], ev["exception"]),
                    node=ev["node"],
                    fix_hint="check the input shapes and op attributes at "
                             "this node",
                    details={"partial_shapes": summary["inferred"]}))
        return out


# ----------------------------------------------------------------- dead code
@register_pass
class DeadCodePass(GraphPass):
    """Dead-node and unused-arg detection: JSON nodes unreachable from
    the heads (checkpoint surgery leftovers), visible op outputs nothing
    consumes, and — when binding args are provided — names that are
    supplied but never used, or used but never supplied."""

    name = "dead_code"

    def run(self, ctx):
        out = []
        out.extend(self._dead_json_nodes(ctx))
        out.extend(self._unconsumed_outputs(ctx))
        out.extend(self._binding_args(ctx))
        return out

    def _dead_json_nodes(self, ctx):
        if not ctx.json_nodes:
            return []
        heads = {h[0] for h in (ctx.json_heads or [])}
        reachable = set()
        stack = list(heads)
        while stack:
            nid = stack.pop()
            if nid in reachable:
                continue
            reachable.add(nid)
            for inp in ctx.json_nodes[nid].get("inputs", []):
                stack.append(inp[0])
        out = []
        for nid, meta in enumerate(ctx.json_nodes):
            if nid in reachable:
                continue
            sev = INFO if meta.get("op") == "null" else WARNING
            kind = "variable" if meta.get("op") == "null" else \
                "node (op %s)" % meta.get("op")
            out.append(self.finding(
                sev, "dead %s '%s': unreachable from the graph heads"
                % (kind, meta.get("name")), node=meta.get("name"),
                fix_hint="drop it from the JSON, or add it to the heads "
                         "if it was meant as an output"))
        return out

    def _unconsumed_outputs(self, ctx):
        sym = ctx.symbol
        consumed = set()
        for node in sym._topo():
            for inode, idx in node.inputs:
                consumed.add((id(inode), idx))
        for node, idx in sym._outputs:
            consumed.add((id(node), idx))
        out = []
        for node in sym._topo():
            if node.is_variable:
                continue
            n_vis = node.op.n_out(node.parsed_attrs())
            if n_vis <= 1:
                continue  # single-output intermediates are just the chain
            for i in range(n_vis):
                if (id(node), i) not in consumed:
                    out.append(self.finding(
                        INFO, "output %d of node '%s' (op %s) is never "
                        "consumed" % (i, node.name, node.op.name),
                        node=node.name,
                        fix_hint="slice the symbol (sym[i]) or drop the "
                                 "unused head"))
        return out

    def _binding_args(self, ctx):
        if ctx.args is None:
            return []
        provided = set(ctx.args) | set(ctx.aux or ())
        sym = ctx.symbol
        wanted = set(sym.list_arguments()) | set(sym.list_auxiliary_states())
        out = []
        for name in sorted(provided - wanted):
            out.append(self.finding(
                WARNING, "binding provides '%s' but the graph has no such "
                "argument or aux state" % name, node=name,
                fix_hint="stale checkpoint entry or a renamed layer — "
                         "drop it or load with allow_extra"))
        for name in sorted(wanted - provided):
            out.append(self.finding(
                WARNING, "graph argument '%s' has no provided binding"
                % name, node=name,
                fix_hint="initialize it or pass it in the bind dicts"))
        return out


# ------------------------------------------------------------ name collision
@register_pass
class NameCollisionPass(GraphPass):
    """Duplicate node names. Executor bind dicts, checkpoints and the
    JSON format are all name-keyed: two nodes sharing a name means one
    binding silently wins and save/load cannot round-trip."""

    name = "name_collision"

    def run(self, ctx):
        seen = {}
        out = []
        for node in ctx.symbol._topo():
            kind = "variable" if node.is_variable else node.op.name
            if node.name in seen and seen[node.name] is not node:
                out.append(self.finding(
                    ERROR, "duplicate node name '%s' (%s): bind dicts and "
                    "checkpoints are name-keyed — one of the two bindings "
                    "is silently dropped" % (node.name, kind),
                    node=node.name,
                    fix_hint="rename one of the nodes (name= or a fresh "
                             "Variable name)"))
            seen.setdefault(node.name, node)
        return out


# ---------------------------------------------------------------- ctx groups
@register_pass
class CtxGroupPass(GraphPass):
    """Bind-time context/group2ctx mismatch checks. The executor places a
    tagged node only ``if grp in placements`` — a typo'd or missing
    group is SILENTLY ignored, so the model-parallel placement the graph
    asked for never happens."""

    name = "ctx_groups"

    def run(self, ctx):
        tagged = {}
        for node in ctx.symbol._topo():
            grp = node._extra_attrs.get("__ctx_group__")
            if grp is not None:
                tagged.setdefault(str(grp), []).append(node.name)
        out = []
        if ctx.group2ctx is None:
            if len(tagged) > 1:
                out.append(self.finding(
                    INFO, "graph tags %d ctx groups (%s) but no group2ctx "
                    "was provided; all nodes stay on the default context"
                    % (len(tagged), ", ".join(sorted(tagged))),
                    fix_hint="bind with group2ctx={...} to honor the "
                             "placement tags"))
            return out
        provided = {str(k) for k in ctx.group2ctx}
        for grp in sorted(set(tagged) - provided):
            out.append(self.finding(
                WARNING, "ctx group '%s' (nodes: %s) is not in group2ctx — "
                "its placement tag is silently ignored at bind"
                % (grp, ", ".join(tagged[grp][:5])),
                node=tagged[grp][0],
                fix_hint="add '%s' to group2ctx or remove the tag" % grp))
        for grp in sorted(provided - set(tagged)):
            out.append(self.finding(
                INFO, "group2ctx maps '%s' but no node carries that tag"
                % grp,
                fix_hint="stale mapping — drop it or fix the AttrScope "
                         "group name"))
        return out


# ------------------------------------------------------------------ donation
def _storage(t):
    """The storage address of a tensor (views of one buffer share it)."""
    try:
        return t.untyped_storage().data_ptr()
    except Exception:
        return None


def _state_tensors(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [t for s in state for t in _state_tensors(s)]
    return [state]


@register_pass
class DonationSafetyPass(GraphPass):
    """Donation-safety audit for the fused train step. mxtpu's step
    donates (params, aux, opt_state); the port's updates the executors'
    bound parameters and its optimizer state in place, so every tensor
    in those sets changes under anyone who holds it. The audit checks,
    on a live module:

    * no host-side NDArray (``_arg_params``/``_aux_params``) shares
      storage with a tensor the step updates in place (the next
      ``update()`` would change the caller's array under it);
    * every trainable parameter is covered by the step's optimizer
      state (a name missing there is never updated).
    """

    name = "donation"

    def run(self, ctx):
        mod = ctx.module
        fused = getattr(mod, "_fused", None) if mod is not None else None
        if fused is None:
            return []
        out = []
        updated = {}
        for r, params in enumerate(fused.params):
            for name, t in params.items():
                updated.setdefault(_storage(t), "params")
        for st in fused.opt_state:
            for name, s in st.items():
                for t in _state_tensors(s):
                    updated.setdefault(_storage(t), "opt_state")
        updated.pop(None, None)
        for attr, group in (("_arg_params", "params"),
                            ("_aux_params", "aux")):
            for name, v in (getattr(mod, attr, None) or {}).items():
                data = getattr(v, "_data", None)
                if data is None:
                    continue
                hit = updated.get(_storage(data))
                if hit is not None:
                    out.append(self.finding(
                        ERROR, "host %s['%s'] shares storage with a tensor "
                        "the fused step updates in place (%s): the next "
                        "update() changes it under the caller"
                        % (attr, name, hit), node=name,
                        provenance=(name, "FusedTrainStep.update",
                                    "in-place update"),
                        fix_hint="snapshot before staging (clone / "
                                 "export_params), never share the buffer"))
        states = fused.opt_state[0] if fused.opt_state else {}
        missing_opt = [n for n in fused.trainable if n not in states]
        if missing_opt:
            out.append(self.finding(
                ERROR, "optimizer state missing for trainable parameter(s) "
                "%s" % ", ".join(missing_opt[:5]),
                fix_hint="adopt_state initializes entries the symbol "
                         "introduces — call it after joining a shared state"))
        out.extend(self._ledger_slots(fused))
        return out

    def _ledger_slots(self, fused):
        """The ledger's ``fused_step`` slot against the bytes it accounts
        (mxtpu :445-467): the first replica's optimizer state and the
        health scratch."""
        from .. import diagnostics as _diag
        slot = getattr(fused, "_mem_slot", None)
        if not _diag.mem_enabled() or slot is None:
            return []
        expected = fused.opt_state_bytes()[0] + fused._health_bytes()
        if slot._nbytes != expected:
            return [self.finding(
                WARNING, "diagnostics ledger fused_step slots account %d "
                "bytes but the live state holds %d: the slot model drifted "
                "from the state's size" % (slot._nbytes, expected),
                fix_hint="call the step's _account_memory() after any "
                         "re-staging that changes state sizes")]
        return []


# ------------------------------------------------------------------ sharding
@register_pass
class ShardingConsistencyPass(GraphPass):
    """SPMD plan consistency: verify a live module against the active
    :class:`~mxtpu_torch.sharding.ShardingPlan` so plan bugs fail at
    ``Module.check()`` instead of deep inside a step. Checks:

    * **axis typos / rank mismatches** in user-supplied spec overrides
      (a typo'd axis name silently prunes to replication);
    * **unsharded-param-on-mesh**: a replica's parameter or optimizer
      state whose LIVE shape is not the block the plan's
      ``ReplicaLayout`` gives that replica (something re-staged state
      behind the plan's back);
    * **mesh-declined drift**: a mesh is active but the fused step runs
      without a plan;
    * **two placement systems**: ``group2ctx`` model-parallel placement
      combined with an active mesh plan.

    Dim-level fallbacks the plan itself decided report at info severity.
    """

    name = "sharding_consistency"

    _ISSUE_SEV = {"axis_typo": ERROR, "rank_mismatch": ERROR,
                  "axis_absent": None, "rank_pruned": None,
                  "replicated_fallback": INFO}

    def run(self, ctx):
        mod = ctx.module
        if mod is None:
            return []
        from .. import sharding as _sharding
        fused = getattr(mod, "_fused", None)
        plan = getattr(fused, "_plan", None) if fused is not None else None
        if plan is None:
            mctx = _sharding.current()
            if mctx is not None and len(mctx.devices) > 1 \
                    and fused is not None:
                return [self.finding(
                    WARNING, "a %d-device mesh is active but the fused "
                    "step runs WITHOUT a sharding plan — training is "
                    "single-replica despite the mesh"
                    % len(mctx.devices),
                    fix_hint="check the init_optimizer log: the mesh is "
                             "declined when the batch does not divide "
                             "over the data axis or the optimizer has no "
                             "fused rule")]
            return []
        out = []
        for issue in plan.validate():
            sev = self._ISSUE_SEV.get(issue["kind"], INFO)
            if sev is None:
                continue
            out.append(self.finding(
                sev, "sharding spec for '%s': %s (raw %s -> final %s)"
                % (issue["name"], issue["message"], issue["raw"],
                   issue["final"]),
                node=issue["name"],
                fix_hint="fix the override spec" if sev is ERROR else
                         "expected plan pruning — replicate is the safe "
                         "fallback"))
        out.extend(self._live_state(fused, plan))
        out.extend(self._placement_overlap(ctx, plan))
        return out

    def _live_state(self, fused, plan):
        """Each replica's tensors vs the blocks its layout gives it."""
        layout = fused._layout
        if layout is None:
            return []
        out = []
        rows = set(fused.sharded_names)
        n_rows = len(fused._data_groups[0])

        def block(name, full):
            shape = list(full)
            for d, axes in enumerate(layout.specs.get(name, ())):
                for a in axes:
                    shape[d] //= layout.sizes[a]
            return tuple(shape)

        for name, full in plan.param_shapes.items():
            want = block(name, full)
            for r, params in enumerate(fused.params):
                t = params.get(name)
                if t is not None and tuple(t.shape) != want:
                    out.append(self.finding(
                        ERROR, "parameter '%s' is staged with sharding %s "
                        "but the plan says %s — something re-staged it "
                        "behind the plan (every step pays a reshard, "
                        "and the ledger's per-chip accounting is wrong)"
                        % (name, tuple(t.shape), plan.param_spec(name)),
                        node=name,
                        fix_hint="stage through the executor group's "
                                 "set_params, which applies the plan's "
                                 "layout"))
                    break
            st_want = want if name not in rows \
                else (want[0] // n_rows,) + want[1:]
            for st in fused.opt_state:
                bad = [t for t in _state_tensors(st.get(name))
                       if tuple(t.shape) != st_want]
                if bad:
                    out.append(self.finding(
                        ERROR, "optimizer state for '%s' is staged with "
                        "sharding %s but the plan says %s — something "
                        "re-staged it behind the plan (every step pays a "
                        "reshard, and the ledger's per-chip accounting is "
                        "wrong)" % (name, tuple(bad[0].shape),
                                    plan.opt_spec(name)),
                        node=name,
                        fix_hint="stage through the executor group's "
                                 "set_params, which applies the plan's "
                                 "layout"))
                    break
        return out

    def _placement_overlap(self, ctx, plan):
        tagged = [n.name for n in ctx.symbol._topo()
                  if n._extra_attrs.get("__ctx_group__") is not None]
        if tagged and ctx.group2ctx:
            return [self.finding(
                WARNING, "graph uses group2ctx placement (%d tagged "
                "nodes) while an SPMD sharding plan is active: two "
                "placement systems will fight over the same arrays"
                % len(tagged),
                node=tagged[0],
                fix_hint="drop the ctx-group tags under a mesh, or "
                         "train without mesh= for model-parallel "
                         "group2ctx runs")]
        return []


# ------------------------------------------------------------------ numerics
#: ops that bound their input from above (make a following exp safe)
_CLAMP_OPS = {"clip", "broadcast_minimum", "_minimum_scalar", "minimum"}
#: ops whose output is safe to log (strictly positive or explicitly
#: guarded); _plus_scalar counts only with a positive scalar (checked)
_LOG_GUARDS = {"_maximum_scalar", "broadcast_maximum", "clip", "abs",
               "square", "exp", "softmax", "SoftmaxActivation", "sigmoid"}
_REDUCTIONS = {"sum", "mean", "nansum", "norm", "prod"}
_DIV_OPS = {"_div", "broadcast_div", "elemwise_div"}
#: denominator guards: an eps added / floor applied before dividing
_DIV_GUARDS = {"_plus_scalar", "_maximum_scalar", "broadcast_maximum",
               "clip"}


@register_pass
class NumericsPass(GraphPass):
    """NaN-prone pattern lint: unclamped ``exp`` (overflows to inf for
    inputs ≳ 88 in f32), ``log`` of an unguarded value (nan/-inf at
    ≤ 0), hand-rolled softmax (``exp(x)/sum(exp(x))`` without the
    max-subtraction the fused ``softmax`` op performs), and eps-free
    division by a reduction (a all-zero row makes the sum 0)."""

    name = "numerics"

    def _producer(self, node, i=0):
        if i < len(node.inputs):
            return node.inputs[i][0]
        return None

    def _positive_scalar(self, node):
        try:
            return float(node.attrs.get("scalar", 0)) > 0
        except (TypeError, ValueError):
            return False

    def run(self, ctx):
        out = []
        softmax_divs = set()
        for node in ctx.symbol._topo():
            if node.is_variable:
                continue
            op = node.op.name
            if op in _DIV_OPS:
                num = self._producer(node, 0)
                den = self._producer(node, 1)
                if num is not None and den is not None \
                        and not num.is_variable and not den.is_variable \
                        and num.op.name == "exp" \
                        and den.op.name in _REDUCTIONS:
                    den_src = self._producer(den, 0)
                    if den_src is num:
                        softmax_divs.add(id(node))
                        out.append(self.finding(
                            WARNING, "hand-rolled softmax at '%s': "
                            "exp(x)/sum(exp(x)) overflows for large logits "
                            "(no max-subtraction)" % node.name,
                            node=node.name,
                            provenance=(num.name, den.name, node.name),
                            fix_hint="use the softmax op (or SoftmaxOutput "
                                     "as a loss head): it is "
                                     "max-normalized and fused"))
                        continue
                if den is not None and not den.is_variable \
                        and den.op.name not in _DIV_GUARDS:
                    chain = den
                    if chain.op.name == "sqrt":
                        chain = self._producer(chain, 0) or chain
                    if not chain.is_variable \
                            and chain.op.name in (_REDUCTIONS | {"exp"}):
                        out.append(self.finding(
                            WARNING, "eps-free division at '%s': the "
                            "denominator is a raw %s — an all-zero input "
                            "divides by zero" % (node.name, chain.op.name),
                            node=node.name,
                            provenance=(chain.name, node.name),
                            fix_hint="add a floor before dividing: "
                                     "denom + eps or maximum(denom, eps)"))
            elif op == "exp":
                src = self._producer(node)
                if src is not None and (src.is_variable or
                                        src.op.name not in _CLAMP_OPS):
                    out.append(self.finding(
                        WARNING, "unclamped exp at '%s': f32 overflows to "
                        "inf for inputs above ~88" % node.name,
                        node=node.name,
                        provenance=((src.name, node.name)
                                    if src is not None else ()),
                        fix_hint="clip the input (clip / minimum) or use a "
                                 "normalized primitive (softmax, "
                                 "log_softmax)"))
            elif op == "log":
                src = self._producer(node)
                guarded = False
                if src is not None and not src.is_variable:
                    if src.op.name in _LOG_GUARDS:
                        guarded = True
                    elif src.op.name == "_plus_scalar" \
                            and self._positive_scalar(src):
                        guarded = True
                if not guarded:
                    out.append(self.finding(
                        WARNING, "unguarded log at '%s': nan for negative "
                        "inputs, -inf at zero" % node.name,
                        node=node.name,
                        provenance=((src.name, node.name)
                                    if src is not None else ()),
                        fix_hint="guard the input: log(x + eps) or "
                                 "log(maximum(x, eps))"))
        return out


# -------------------------------------------------------------- entry points
def analyze(symbol, shapes=None, types=None, group2ctx=None, module=None,
            args=None, aux=None, json_nodes=None, json_heads=None,
            passes=None):
    """Run the registered passes over ``symbol`` and return a
    :class:`~mxtpu_torch.analysis.Report`.

    ``shapes``/``types`` are the hints ``infer_shape`` would get;
    ``group2ctx`` the placement map a bind would use; ``module`` a live
    (bound) Module for the donation audit; ``args``/``aux`` provided
    binding names for the unused-arg check; ``json_nodes``/``json_heads``
    the raw node table of a loaded JSON graph for dead-node detection.
    ``passes`` restricts to a subset of pass names.
    """
    ctx = PassContext(symbol, shapes=shapes, types=types,
                      group2ctx=group2ctx, module=module, args=args,
                      aux=aux, json_nodes=json_nodes, json_heads=json_heads)
    selected = [(n, get_pass(n)) for n in passes] if passes \
        else list(_PASSES.items())
    findings = []
    for name, p in selected:
        try:
            findings.extend(p.run(ctx))
        except Exception as exc:  # a broken pass must not mask the others
            findings.append(Finding(
                name, WARNING, "pass crashed: %s: %s"
                % (type(exc).__name__, exc),
                fix_hint="report this — an analysis pass should never "
                         "raise"))
    return Report(findings, passes_run=[n for n, _ in selected])


def analyze_json(json_str, **kwargs):
    """``analyze`` over a serialized graph (the CLI path): dead-node
    detection sees the raw node table, including entries unreachable
    from the heads that ``load_json`` itself would skip."""
    import json as _json

    from ..symbol import load_json
    data = _json.loads(json_str)
    sym = load_json(json_str)
    return analyze(sym, json_nodes=data.get("nodes"),
                   json_heads=data.get("heads"), **kwargs)


def check_module(module, passes=None, pipeline=None):
    """``Module.check()``: analyze the module's symbol with everything
    the module knows — bound shapes, provided params, and the live fused
    step for the donation audit. ``pipeline`` dry-runs compile-pipeline
    transforms and merges their action/rejection findings (see
    ``Symbol.lint``)."""
    sym = module.symbol
    if sym is None:
        raise MXNetError("Module.check: module has no symbol")
    shapes = {}
    if getattr(module, "binded", False):
        for d in (module._data_shapes or []) + (module._label_shapes or []):
            name, shape = (d.name, d.shape) if hasattr(d, "name") else d
            shapes[name] = tuple(shape)
    args = aux = None
    if getattr(module, "_arg_params", None) is not None:
        args = set(module._arg_params) \
            | set(getattr(module, "_data_names", ()) or ()) \
            | set(getattr(module, "_label_names", ()) or ())\
            | set(getattr(module, "_state_names", ()) or ())
        aux = set(module._aux_params or {})
    report = analyze(sym, shapes=shapes, module=module, args=args, aux=aux,
                     passes=passes)
    from ..symbol.symbol import _merge_pipeline_report
    return _merge_pipeline_report(report, sym, shapes, pipeline,
                                  module=module)
