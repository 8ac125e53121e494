"""Translation validation for the transform catalog.

Counterpart of ``mxtpu/analysis/equiv.py``, unchanged in its algebras,
canonical keys and verdicts: a certificate the port issues for a rewrite
is the one mxtpu issues for the same rewrite.

Every pipeline rewrite so far has been *trusted*: the error budget
re-runs the verifier and rejects a pass that mints new error findings,
but a rewrite that silently changes semantics while staying
verifier-clean (a checkpoint policy that saves the wrong names) slides
straight through.  This module certifies ``transformed ≡ original``
statically, modulo each pass's **declared rewrite algebra** — the
closed set of edits the pass is licensed to make:

``annotation_only``
    fuse_opt / remat_reuse: structural identity; the only permitted
    delta is the ``__update_class__`` / ``__remat__`` / ``__reuse__``
    annotation attrs.
``cast_boundaries``
    bf16: Cast pairs interposed at ``precision_flow``-classified
    boundaries only — down-casts feed bf16-safe consumers, up-casts
    restore f32 at islands and heads.  Everything else is identical.
``qdq_streams``
    quant: matmul-class weight streams replaced by
    ``dequantize_int8`` over a new int8 variable, activation
    quantize/dequantize pairs on calibrated edges into active sites,
    inference kinds only.
``layout_runs``
    layout: conv/pool/BN attr retargets inside a costed applied run
    plus cancelling transpose pairs at the run's boundary edges.

The checker works on a *name-matched skeleton*: every rewrite in the
catalog preserves op-node names (clones keep ``node.name``) and only
ADDs adapter nodes, so each original op node must reappear under the
same name with equal op/attrs and with every input edge resolving —
through the algebra's erasable adapters — to the same producer.  On top
of the skeleton diff, :func:`entry_key` computes stable
name-independent topological node keys (commutative-input
normalization, annotation-attr stripping) and the certificate records
that the erased canonical keys of both graphs agree.

The pipeline arms this as a gate beside the verifier re-run
(``MXTPU_PIPELINE_CERT``); a refusal is a
:class:`~mxtpu_torch.analysis.findings.Finding` and the pass falls back
exactly like the error-budget path.
"""
from __future__ import annotations

import hashlib

from .findings import Finding, ERROR
from . import dataflow as _df

__all__ = [
    "ANNOTATION_ATTRS", "COMMUTATIVE_OPS", "ALGEBRAS",
    "Certificate", "certify", "entry_key", "canonical_digest",
]

#: extra attrs the annotation-only passes may stamp (stripped by keys)
ANNOTATION_ATTRS = frozenset(
    {"__update_class__", "__remat__", "__reuse__"})

#: ops whose inputs are order-insensitive — canonical keys sort them
COMMUTATIVE_OPS = frozenset({
    "elemwise_add", "_plus", "_add", "elemwise_mul", "_mul",
    "broadcast_add", "broadcast_plus", "broadcast_mul",
    "broadcast_maximum", "broadcast_minimum",
    "_maximum", "_minimum", "_hypot", "add_n", "_grad_add",
})

_BF16_CAST_SUFFIXES = ("_bf16_amp", "_f32_amp")
_LAYOUT_SUFFIXES = ("_nhwc", "_nchw")
_LAYOUT_AXES = {"_nhwc": (0, 2, 3, 1), "_nchw": (0, 3, 1, 2)}
_RESOLVE_LIMIT = 64


class _Refusal(Exception):
    """Internal: a non-certifiable delta, with the anchoring node."""

    def __init__(self, message, node=None):
        super(_Refusal, self).__init__(message)
        self.node = node


# ------------------------------------------------------------ erasers
class _Eraser:
    """What an algebra is allowed to ADD — and therefore what edge
    resolution may see through.  ``forward(node)`` returns the input
    slot an adapter splices through (None = not an adapter);
    ``var_alias(node)`` maps an adapter variable to the original
    argument name it stands in for (None = ordinary variable)."""

    def forward(self, node):
        return None

    def var_alias(self, node):
        return None

    def is_adapter(self, node):
        return (not node.is_variable and self.forward(node) is not None)

    def normalize_attrs(self, node, attrs):
        """Algebra-specific attr normalization for canonical keys
        (e.g. layout retarget keys).  Returns a possibly-edited dict."""
        return attrs


class _NullEraser(_Eraser):
    pass


def _is_amp_cast(node):
    return (not node.is_variable and node.op.name == "Cast"
            and node.name.endswith(_BF16_CAST_SUFFIXES))


class _CastEraser(_Eraser):
    def forward(self, node):
        return 0 if _is_amp_cast(node) else None


class _QdqEraser(_Eraser):
    """quant adapters: QDQ node pairs, the int8 stand-in variables,
    plus the ``_amp`` casts a composed bf16 pass put on the weight edge
    that the dequant replaces (erased symmetrically on both sides)."""

    def forward(self, node):
        if node.is_variable:
            return None
        if _is_amp_cast(node):
            return 0
        op = node.op.name
        if op in ("quantize_int8", "dequantize_int8") \
                and ("__q8" in node.name or "__dq" in node.name):
            return 0
        return None

    def var_alias(self, node):
        if node.is_variable and node.name.endswith("__q8"):
            return node.name[:-4]
        return None


def _is_layout_transpose(node):
    if node.is_variable or node.op.name != "transpose":
        return False
    for suf in _LAYOUT_SUFFIXES:
        if node.name.endswith(suf):
            axes = node.parsed_attrs().get("axes")
            return tuple(axes or ()) == _LAYOUT_AXES[suf]
    return False


class _LayoutEraser(_Eraser):
    def forward(self, node):
        return 0 if _is_layout_transpose(node) else None

    def normalize_attrs(self, node, attrs):
        op = node.op.name if not node.is_variable else None
        if op in ("Convolution", "Convolution_v1",
                  "Pooling", "Pooling_v1"):
            if str(attrs.get("layout")) in ("NCHW", "NHWC"):
                attrs = dict(attrs)
                attrs.pop("layout")
        elif op in ("BatchNorm", "BatchNorm_v1"):
            if str(attrs.get("axis")) in ("1", "3"):
                attrs = dict(attrs)
                attrs.pop("axis")
        return attrs


# ------------------------------------------------- resolution and keys
def _resolve(entry, eraser):
    """Follow an edge through the algebra's adapters to its terminal.
    Returns ``("var", alias_or_name)`` or ``("op", name, out_idx)``."""
    node, idx = entry
    for _ in range(_RESOLVE_LIMIT):
        if node.is_variable:
            alias = eraser.var_alias(node)
            return ("var", alias if alias is not None else node.name)
        slot = eraser.forward(node)
        if slot is None:
            return ("op", node.name, idx)
        node, idx = node.inputs[slot]
    raise _Refusal("adapter chain exceeds %d nodes resolving edge at "
                   "'%s'" % (_RESOLVE_LIMIT, entry[0].name),
                   node=entry[0].name)


def _norm_attrs(node, eraser):
    """Attrs that participate in equivalence: declared attrs normalized
    by the algebra, extra attrs minus the annotation set."""
    attrs = eraser.normalize_attrs(node, dict(node.attrs))
    for k, v in node._extra_attrs.items():
        if k not in ANNOTATION_ATTRS:
            attrs[k] = v
    return {str(k): str(v) for k, v in attrs.items()}


def _canonical_keys(symbol, eraser):
    """Stable name-independent keys for every head of ``symbol``:
    variables get first-appearance de Bruijn indices (appearance order
    over the erased graph is rename-invariant), op nodes hash
    ``(op, normalized attrs, input keys)`` with commutative-input
    sorting, and adapter/annotation deltas are erased — so two graphs
    are algebra-equivalent iff their head key tuples agree."""
    var_ix = {}
    memo = {}

    def var_key(name):
        if name not in var_ix:
            var_ix[name] = len(var_ix)
        return "v%d" % var_ix[name]

    def key_of(entry):
        term = _resolve(entry, eraser)
        if term[0] == "var":
            return var_key(term[1])
        node, idx = entry
        # re-walk to the terminal node object (cheap: adapters only)
        for _ in range(_RESOLVE_LIMIT):
            if eraser.forward(node) is None:
                break
            node, idx = node.inputs[eraser.forward(node)]
        hit = memo.get((id(node), idx))
        if hit is not None:
            return hit
        in_keys = [key_of(e) for e in node.inputs]
        if node.op.name in COMMUTATIVE_OPS:
            in_keys = sorted(in_keys)
        attrs = _norm_attrs(node, eraser)
        h = hashlib.sha1()
        h.update(node.op.name.encode())
        for k in sorted(attrs):
            h.update(("|%s=%s" % (k, attrs[k])).encode())
        for ik in in_keys:
            h.update(("|%s" % (ik,)).encode())
        key = "%s:%d" % (h.hexdigest()[:16], idx)
        memo[(id(node), idx)] = key
        return key

    return tuple(key_of(e) for e in symbol._outputs)


def entry_key(symbol):
    """Public canonicalizer: name-independent keys of the graph heads
    (no erasure — pure structural identity modulo names, commutative
    input order, and annotation attrs)."""
    return _canonical_keys(symbol, _NullEraser())


def canonical_digest(symbol, eraser=None):
    """One hex digest over :func:`entry_key` — the value a
    :class:`Certificate` records as its ``digest``."""
    return _digest_keys(_canonical_keys(symbol, eraser or _NullEraser()))


def _digest_keys(keys):
    h = hashlib.sha1()
    for k in keys:
        h.update(("%s|" % (k,)).encode())
    return h.hexdigest()[:16]


# ------------------------------------------------------ skeleton diff
def _op_nodes(symbol, eraser):
    out = {}
    for n in symbol._topo():
        if n.is_variable or eraser.is_adapter(n):
            continue
        out[n.name] = n
    return out


def _skeleton_diff(original, transformed, eraser, attr_delta_ok=None):
    """Name-matched structural comparison modulo the eraser.  Returns
    the list of (orig node, trans node) pairs whose declared attrs
    differ (each already vetted by ``attr_delta_ok``); raises
    :class:`_Refusal` on any non-certifiable delta.  The eraser is
    applied SYMMETRICALLY: an earlier pass's adapter on the original
    side (e.g. a bf16 weight cast the quant rewrite makes dead) erases
    the same way the new pass's adapters do."""
    orig = _op_nodes(original, eraser)
    trans = _op_nodes(transformed, eraser)
    missing = sorted(set(orig) - set(trans))
    if missing:
        raise _Refusal("node(s) dropped by the rewrite: %s"
                       % ", ".join(missing[:5]), node=missing[0])
    extra = sorted(set(trans) - set(orig))
    if extra:
        raise _Refusal("node(s) introduced beyond the declared "
                       "algebra: %s" % ", ".join(extra[:5]),
                       node=extra[0])
    retargeted = []
    for name in orig:
        o, t = orig[name], trans[name]
        if o.op.name != t.op.name:
            raise _Refusal("node '%s' changed op %s -> %s"
                           % (name, o.op.name, t.op.name), node=name)
        if dict(o.attrs) != dict(t.attrs):
            delta = {k for k in set(o.attrs) | set(t.attrs)
                     if o.attrs.get(k) != t.attrs.get(k)}
            if attr_delta_ok is None or not attr_delta_ok(o, t, delta):
                raise _Refusal(
                    "node '%s' attrs changed outside the algebra: %s"
                    % (name, ", ".join(sorted(str(d) for d in delta))),
                    node=name)
            retargeted.append((o, t))
        if len(o.inputs) != len(t.inputs):
            raise _Refusal("node '%s' arity changed %d -> %d"
                           % (name, len(o.inputs), len(t.inputs)),
                           node=name)
        for i in range(len(o.inputs)):
            ro = _resolve(o.inputs[i], eraser)
            rt = _resolve(t.inputs[i], eraser)
            if ro != rt:
                raise _Refusal(
                    "node '%s' input %d rewired: %s -> %s"
                    % (name, i, _fmt_term(ro), _fmt_term(rt)),
                    node=name)
    if len(original._outputs) != len(transformed._outputs):
        raise _Refusal("head count changed %d -> %d"
                       % (len(original._outputs),
                          len(transformed._outputs)))
    for hi, (oe, te) in enumerate(zip(original._outputs,
                                      transformed._outputs)):
        ro = _resolve(oe, eraser)
        rt = _resolve(te, eraser)
        if ro != rt:
            raise _Refusal("head %d rewired: %s -> %s"
                           % (hi, _fmt_term(ro), _fmt_term(rt)))
    return retargeted


def _fmt_term(term):
    if term[0] == "var":
        return "arg '%s'" % term[1]
    return "'%s'[%d]" % (term[1], term[2])


def _adapters(transformed, eraser):
    return [n for n in transformed._topo() if eraser.is_adapter(n)]


def _consumers(symbol):
    """name-keyed reverse map: id(node) -> [(consumer node, slot)]."""
    out = {}
    for n in symbol._topo():
        if n.is_variable:
            continue
        for i, (src, _) in enumerate(n.inputs):
            out.setdefault(id(src), []).append((n, i))
    return out

def _extra_delta(original, transformed):
    """Union of extra-attr keys the rewrite added or changed across all
    name-matched op nodes and shared/cloned variables."""
    def emap(sym):
        out = {}
        for n in sym._topo():
            out[n.name] = dict(n._extra_attrs)
        return out
    om, tm = emap(original), emap(transformed)
    delta = set()
    for name in set(om) & set(tm):
        o, t = om[name], tm[name]
        for k in set(o) | set(t):
            if o.get(k) != t.get(k):
                delta.add(k)
    return delta


# ------------------------------------------------------------ checkers
def _cert_annotation_only(ctx):
    eraser = _NullEraser()
    _skeleton_diff(ctx.original, ctx.transformed, eraser)
    delta = _extra_delta(ctx.original, ctx.transformed)
    illegal = delta - ANNOTATION_ATTRS
    if illegal:
        raise _Refusal("annotation-only pass touched non-annotation "
                       "attrs: %s" % ", ".join(sorted(illegal)))
    return eraser, {"annotated_attrs": sorted(delta)}


def _cert_cast_boundaries(ctx):
    eraser = _CastEraser()
    _skeleton_diff(ctx.original, ctx.transformed, eraser)
    casts = _adapters(ctx.transformed, eraser)
    plan = _df.precision_flow(ctx.original, ctx.shapes, ctx.types)
    orig_ops = {n.name: n for n in ctx.original._topo()
                if not n.is_variable}
    cons = _consumers(ctx.transformed)
    heads = {id(n) for n, _ in ctx.transformed._outputs}
    down = up = 0
    for c in casts:
        dt = str(c.parsed_attrs().get("dtype"))
        if c.name.endswith("_bf16_amp"):
            if dt != "bfloat16":
                raise _Refusal("down-cast '%s' targets %s, not bfloat16"
                               % (c.name, dt), node=c.name)
            for consumer, slot in cons.get(id(c), ()):
                if _is_amp_cast(consumer):
                    continue
                onode = orig_ops.get(consumer.name)
                if onode is None \
                        or plan.class_of(onode) != _df.BF16_SAFE:
                    raise _Refusal(
                        "down-cast '%s' feeds '%s', which "
                        "precision_flow does not classify bf16-safe"
                        % (c.name, consumer.name), node=consumer.name)
            down += 1
        elif c.name.endswith("_f32_amp"):
            if dt != "float32":
                raise _Refusal("up-cast '%s' targets %s, not float32"
                               % (c.name, dt), node=c.name)
            src, _ = c.inputs[0]
            osrc = orig_ops.get(src.name) if not src.is_variable \
                else None
            if osrc is not None \
                    and plan.class_of(osrc) != _df.BF16_SAFE:
                raise _Refusal(
                    "up-cast '%s' wraps '%s', which precision_flow "
                    "does not classify bf16 — nothing to restore"
                    % (c.name, src.name), node=src.name)
            for consumer, slot in cons.get(id(c), ()):
                onode = orig_ops.get(consumer.name)
                if onode is not None \
                        and plan.class_of(onode) == _df.BF16_SAFE:
                    raise _Refusal(
                        "up-cast '%s' feeds bf16-safe '%s' — an "
                        "unlicensed round-trip" % (c.name,
                                                   consumer.name),
                        node=consumer.name)
            up += 1
        else:
            raise _Refusal("cast '%s' matches no amp naming convention"
                           % c.name, node=c.name)
    return eraser, {"down_casts": down, "up_casts": up}


def _cert_qdq_streams(ctx):
    inference = getattr(ctx.tp, "INFERENCE_KINDS", None) \
        or frozenset({"executor_infer"})
    if ctx.kind is not None and ctx.kind not in inference:
        raise _Refusal("quantizing rewrite on non-inference build "
                       "kind '%s'" % ctx.kind)
    eraser = _QdqEraser()
    _skeleton_diff(ctx.original, ctx.transformed, eraser)
    orig_vars = {n.name for n in ctx.original._topo() if n.is_variable}
    cons = _consumers(ctx.transformed)
    w_streams = a_pairs = 0
    for n in ctx.transformed._topo():
        if n.is_variable:
            if n.name.endswith("__q8") \
                    and n.name[:-4] not in orig_vars:
                raise _Refusal(
                    "int8 variable '%s' aliases no original argument"
                    % n.name, node=n.name)
            continue
        if not eraser.is_adapter(n) or _is_amp_cast(n):
            continue
        op = n.op.name
        if op == "quantize_int8":
            # a quantize must feed only dequantize tails (QDQ pairs)
            for consumer, _ in cons.get(id(n), ()):
                if consumer.op.name != "dequantize_int8":
                    raise _Refusal(
                        "quantize '%s' feeds '%s' (op %s) — raw int8 "
                        "escapes the QDQ pair"
                        % (n.name, consumer.name, consumer.op.name),
                        node=n.name)
        elif op == "dequantize_int8":
            src, _ = n.inputs[0]
            if src.is_variable:
                if not src.name.endswith("__q8"):
                    raise _Refusal(
                        "dequantize '%s' reads non-int8 variable '%s'"
                        % (n.name, src.name), node=n.name)
                w_streams += 1
                for consumer, slot in cons.get(id(n), ()):
                    if consumer.op.name not in _df.QUANT_COMPUTE:
                        raise _Refusal(
                            "weight stream '%s' feeds non-matmul-class "
                            "'%s' (op %s)" % (n.name, consumer.name,
                                              consumer.op.name),
                            node=consumer.name)
            elif src.op.name == "quantize_int8":
                a_pairs += 1
                for consumer, slot in cons.get(id(n), ()):
                    if consumer.op.name not in _df.QUANT_COMPUTE:
                        raise _Refusal(
                            "activation QDQ '%s' feeds non-matmul-"
                            "class '%s' (op %s)"
                            % (n.name, consumer.name,
                               consumer.op.name), node=consumer.name)
            else:
                raise _Refusal(
                    "dequantize '%s' over '%s' (op %s) is neither a "
                    "weight stream nor a QDQ tail"
                    % (n.name, src.name, src.op.name), node=n.name)
    return eraser, {"weight_streams": w_streams, "act_qdq": a_pairs}


def _cert_layout_runs(ctx):
    eraser = _LayoutEraser()
    plan = _df.conv_layout(ctx.original, ctx.shapes, ctx.types)
    member_names = set()
    for r in plan.runs:
        if r["applied"]:
            member_names.update(
                n.name for n in ctx.original._topo()
                if id(n) in r["nodes"])

    def attr_delta_ok(o, t, delta):
        if o.name not in member_names:
            return False
        for k in delta:
            if k == "layout":
                if t.attrs.get("layout") != "NHWC":
                    return False
            elif k == "axis":
                if str(t.attrs.get("axis")) != "3":
                    return False
            else:
                return False
        return True

    retargeted = _skeleton_diff(ctx.original, ctx.transformed, eraser,
                                attr_delta_ok=attr_delta_ok)
    transposes = _adapters(ctx.transformed, eraser)
    return eraser, {"retargeted": len(retargeted),
                    "transposes": len(transposes),
                    "applied_runs": plan.n_applied}


#: algebra name -> checker; a checker returns (eraser, counts) or
#: raises _Refusal.  The checker receives a ctx with original /
#: transformed / kind / shapes / types / tp.
ALGEBRAS = {
    "annotation_only": _cert_annotation_only,
    "cast_boundaries": _cert_cast_boundaries,
    "qdq_streams": _cert_qdq_streams,
    "layout_runs": _cert_layout_runs,
}


# ---------------------------------------------------------- certificate
class Certificate:
    """The result of :func:`certify` — machine-checkable evidence that
    one pass's rewrite stayed inside its declared algebra."""

    __slots__ = ("pass_name", "algebra", "ok", "reason", "counts",
                 "digest")

    def __init__(self, pass_name, algebra, ok, reason=None, counts=None,
                 digest=None):
        self.pass_name = pass_name
        self.algebra = algebra
        self.ok = bool(ok)
        self.reason = reason
        self.counts = dict(counts or {})
        self.digest = digest

    def to_dict(self):
        out = {"pass": self.pass_name, "algebra": self.algebra,
               "ok": self.ok}
        if self.reason:
            out["reason"] = self.reason
        if self.counts:
            out["counts"] = self.counts
        if self.digest:
            out["digest"] = self.digest
        return out

    def to_finding(self, node=None):
        """Refusal rendered as a Finding the pipeline rejects on."""
        return Finding(
            "certificate", ERROR,
            "transform '%s' REFUSED: rewrite is not certifiable under "
            "its declared algebra '%s' — %s"
            % (self.pass_name, self.algebra or "<undeclared>",
               self.reason or "unknown delta"),
            node=node,
            fix_hint="the pass must stay inside its declared rewrite "
                     "algebra (docs/compile.md, certification "
                     "contract); fix the rewrite or declare a wider "
                     "algebra with its own checker",
            details={"certificate": self.to_dict()})

    def __repr__(self):
        return "<Certificate %s/%s %s%s>" % (
            self.pass_name, self.algebra or "?",
            "ok" if self.ok else "REFUSED",
            (" (%s)" % self.reason) if self.reason else "")


class _Ctx:
    __slots__ = ("original", "transformed", "kind", "shapes", "types",
                 "tp")

    def __init__(self, original, transformed, kind, shapes, types, tp):
        self.original = original
        self.transformed = transformed
        self.kind = kind
        self.shapes = shapes
        self.types = types
        self.tp = tp


def certify(tp, original, transformed, kind=None, shapes=None,
            types=None):
    """Certify that ``transformed`` is equivalent to ``original``
    modulo the rewrite algebra ``tp`` declares.

    ``tp`` is a registered :class:`~mxtpu_torch.analysis.rewrite
    .TransformPass` (or its catalog name).  Returns a
    :class:`Certificate`; a pass with no declared algebra, an unknown
    algebra, or a rewrite outside its algebra is REFUSED (``ok`` False)
    — never an exception, so the pipeline gate can treat refusal
    exactly like an error-budget rejection."""
    if isinstance(tp, str):
        from .rewrite import get_transform
        tp = get_transform(tp)
    pass_name = getattr(tp, "name", None) or "<anonymous>"
    algebra = getattr(tp, "algebra", None)
    if not algebra:
        return Certificate(pass_name, None, False,
                           reason="pass declares no rewrite algebra")
    checker = ALGEBRAS.get(algebra)
    if checker is None:
        return Certificate(pass_name, algebra, False,
                           reason="unknown rewrite algebra '%s' (no "
                                  "registered checker)" % algebra)
    ctx = _Ctx(original, transformed, kind, shapes, types, tp)
    try:
        eraser, counts = checker(ctx)
        ko = _canonical_keys(original, eraser)
        kt = _canonical_keys(transformed, eraser)
        if ko != kt:
            return Certificate(
                pass_name, algebra, False, counts=counts,
                reason="erased canonical head keys disagree "
                       "(structural delta survives adapter erasure)")
    except _Refusal as r:
        return Certificate(pass_name, algebra, False, reason=str(r))
    return Certificate(pass_name, algebra, True, counts=counts,
                       digest=_digest_keys(kt))
