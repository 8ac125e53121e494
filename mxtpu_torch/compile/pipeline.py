"""The compile pipeline: transform → verify → build → instrument.

Counterpart of ``mxtpu/compile/pipeline.py``, the port's one
program-build seam. A transform only does what a dataflow analysis
licensed (:mod:`mxtpu_torch.analysis.dataflow`); the full verifier suite
re-runs on the transformed graph (:func:`mxtpu_torch.analysis.analyze`),
and a transform whose output fails a check its input passed, or whose
rewrite certification refuses, is rejected with the offending
:class:`~mxtpu_torch.analysis.Finding`; the build falls back to the
unrewritten graph.

A "program" in the port is an executor plan (``executor._trace_graph``:
the topo order, attrs and input slots walked eagerly at every call)
built once per kind and pipeline config. mxtpu compiles its programs
ahead of time at the first call (``fn.lower().compile()``) and demotes
to the jit function on repeated signature misses; eager torch has no
compile and no signature, so :func:`instrument_program` times the first
call (``executor_compile_ms{kind=}``), counts its operations and bytes
into the program table (:mod:`mxtpu_torch.diagnostics.programs`) and
then calls the plan as it is. Those two deltas are deliberate.

The active pipeline is empty by default (zero behaviour change);
``MXTPU_PIPELINE=bf16`` or :func:`configure`/:func:`pipeline_scope`
selects transforms by registry name (:mod:`mxtpu_torch.analysis.rewrite`).
"""
from __future__ import annotations

import contextlib
import logging as _logging
import os as _os
import threading as _threading

from .. import telemetry as _tel
from ..analysis import concurrency as _conc
from ..diagnostics.programs import (CostCounter, cost_enabled,
                                    owner_name, record_program,
                                    summarize_precision)

__all__ = ["set_output_sanitizer", "set_calib_observer",
           "add_build_listener",
           "remove_build_listener", "program_build_count", "notify_build",
           "record_program_build", "instrument_program",
           "prewarm_scope", "in_prewarm", "prewarm_build_count",
           "configure", "configured", "refresh_from_knobs",
           "pipeline_scope", "canonical_order",
           "set_certification", "certification_enabled",
           "transform_graph", "PipelineReport"]

_log = _logging.getLogger("mxtpu_torch.compile")

# ------------------------------------------------------------- sanitizer seam
# the numerics sanitizer installs fn(kind, out, precision) here when
# MXTPU_SANITIZE is armed; every instrumented program (fwd_eval/fwd_bwd/
# fused_step/metric_accum) routes its outputs through it. Unset, the
# cost per call is ONE module-global read + None check.
_OUTPUT_SANITIZER = None


def set_output_sanitizer(fn):
    """Install ``fn(kind, out)`` called on every instrumented program's
    outputs (the numerics sanitizer); ``None`` uninstalls."""
    global _OUTPUT_SANITIZER
    _OUTPUT_SANITIZER = fn


# The int8-calibration observer rides the same seam with the same
# zero-overhead contract: compile.quant installs fn(kind, {name: array})
# here while calibration is armed (MXTPU_QUANT_CALIB / arm()); programs
# built with observation heads (instrument_program's ``calib_heads``)
# feed the extra outputs through it and strip them before the sanitizer
# and the caller ever see them.
_CALIB_OBSERVER = None


def set_calib_observer(fn):
    """Install ``fn(kind, named_arrays)`` receiving every instrumented
    program's calibration observations; ``None`` uninstalls."""
    global _CALIB_OBSERVER
    _CALIB_OBSERVER = fn


# ------------------------------------------------------- certification gate
# Translation validation (mxtpu_torch.analysis.equiv) rides the transform
# seam as a gate BESIDE the verifier re-run: every accepted rewrite is
# certified equivalent to its input modulo the pass's declared algebra,
# and a non-certifiable rewrite is refused — rejected and fallen back
# from exactly like the error-budget path. Disarmed
# (MXTPU_PIPELINE_CERT=0), the per-pass cost is ONE module-global
# check.
_CERT_DISARM = ("0", "off", "false", "none", "")
_CERT_ARMED = (_os.environ.get("MXTPU_PIPELINE_CERT", "1")
               .strip().lower() not in _CERT_DISARM)


def set_certification(flag):
    """Arm (True) or disarm (False) the pipeline's per-pass
    equivalence-certification gate; returns the previous state."""
    global _CERT_ARMED
    prev = _CERT_ARMED
    _CERT_ARMED = bool(flag)
    return prev


def certification_enabled():
    return _CERT_ARMED


def _certify(tp, original, transformed, kind=None, shapes=None,
             types=None):
    from ..analysis import equiv as _equiv
    return _equiv.certify(tp, original, transformed, kind=kind,
                          shapes=shapes, types=types)


# ---------------------------------------------------------------- cache hooks
# Program-construction observability for the serving layer: every time a
# program is built (a miss in a per-kind program table: the plan is
# made and its first call pays the first-call costs), listeners
# are notified with (kind, owner). The serving layer counts these to surface
# executor-cache efficiency; warmup correctness is asserted by the count
# staying flat under traffic.
_BUILD_LISTENERS = []
_BUILD_COUNT = [0]
_BUILD_LOCK = _conc.lock("pipeline", "_BUILD_LOCK")

# standing series: registry-direct so they exist for /metrics even when
# MXTPU_TELEMETRY=0 was set at import
_M_BUILDS_TOTAL = _tel.registry().counter(
    "executor_program_builds_total",
    help="traced-program constructions (each compiles on first dispatch)")


def add_build_listener(fn):
    """Register ``fn(kind, owner)`` called on every program build."""
    _BUILD_LISTENERS.append(fn)
    return fn


def remove_build_listener(fn):
    if fn in _BUILD_LISTENERS:
        _BUILD_LISTENERS.remove(fn)


def program_build_count():
    """Total traced-program constructions since import (monotonic)."""
    return _BUILD_COUNT[0]


# ------------------------------------------------------------- pre-warm seam
# Deploy-time compilation (serving warmup, WarmExecutableCache.prewarm,
# a hot-swap's pre-flip warm) runs inside prewarm_scope() so the build
# counters can tell a planned deploy compile from a mid-traffic cache
# miss — the event continuous serving treats as a regression. Depth is
# thread-local: warmup runs on the deploying thread while traffic keeps
# building elsewhere.
_PREWARM_TLS = _threading.local()

_M_PREWARM_BUILDS = _tel.registry().counter(
    "executor_prewarm_builds_total",
    help="program builds inside a prewarm_scope (deploy-time compiles, "
         "not mid-traffic cache misses)")


@contextlib.contextmanager
def prewarm_scope():
    """Mark program builds on this thread as deploy-time pre-warm."""
    depth = getattr(_PREWARM_TLS, "depth", 0)
    _PREWARM_TLS.depth = depth + 1
    try:
        yield
    finally:
        _PREWARM_TLS.depth = depth


def in_prewarm():
    """True while the calling thread is inside a ``prewarm_scope``."""
    return getattr(_PREWARM_TLS, "depth", 0) > 0


def prewarm_build_count():
    """Total builds that happened inside a prewarm_scope (monotonic)."""
    return int(_M_PREWARM_BUILDS.value)


def notify_build(kind, owner):
    with _BUILD_LOCK:  # concurrent replica builds must not lose counts
        _BUILD_COUNT[0] += 1
    _M_BUILDS_TOTAL.inc()
    if in_prewarm():
        _M_PREWARM_BUILDS.inc()
    _tel.registry().counter("executor_program_builds",
                            labels={"kind": kind}).inc()
    for fn in list(_BUILD_LISTENERS):
        try:
            fn(kind, owner)
        except Exception:
            # allow-swallow(observer contract: a broken build
            # LISTENER must not fail the build it observes)
            pass


def record_program_build(kind, owner, fn, precision=None, transforms=None,
                         cert=None):
    """Public build-seam entry for program tables outside the Executor
    (the fused train step, metric accumulators): bump the build
    counters, notify the listeners, and wrap ``fn`` for first-call
    compile timing and cost capture — the exact sequence the Executor's
    ``_get_fn`` performs, so every traced-program construction in the
    process reports through one seam. ``precision``/``transforms``/
    ``cert`` tag the program's cost record (``program_table``'s
    prec/xforms/cert columns) when the compile pipeline rewrote the
    graph."""
    notify_build(kind, owner)
    return instrument_program(kind, fn, owner=owner, precision=precision,
                              transforms=transforms, cert=cert)


def instrument_program(kind, fn, owner=None, precision=None,
                       transforms=None, calib_heads=None, cert=None):
    """Wrap a freshly built program with the build-seam diagnostics.

    ``fn`` is an executor plan's replica walk: it returns ``(outputs,
    aux_updates)``, ``outputs`` one list of output tensors per replica.
    The first invocation lands in ``executor_compile_ms{kind=...}``;
    with cost capture on (``MXTPU_DIAG_COST``, default) it runs under a
    :class:`~mxtpu_torch.diagnostics.programs.CostCounter` and records
    its operations, bytes and the card's peak-allocation rise into the
    program table. Every later call is ``fn`` itself, behind one None
    check each for the calibration observer and the sanitizer.

    ``precision``/``transforms``/``cert`` stamp the program's record
    (mxtpu's prec/xforms/cert columns). ``calib_heads`` names, in
    order, the observation heads appended to the outputs at the build:
    the wrapper feeds each replica's ``{name: tensor}`` to the armed
    calibration observer and strips them before the sanitizer and the
    caller see the outputs."""
    import time as _time
    owner = owner_name(owner)
    state = {"first": True, "rec": None,
             "lock": _conc.lock("pipeline", "_first_call_lock")}

    def _first_call(args, kwargs):
        import torch
        t0 = _time.perf_counter()
        if not cost_enabled():
            out = fn(*args, **kwargs)
        else:
            cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
            if cuda:
                alloc0 = torch.cuda.memory_allocated()
                peak0 = torch.cuda.max_memory_allocated()
            with CostCounter() as counter:
                out = fn(*args, **kwargs)
            temp = 0
            if cuda:
                peak1 = torch.cuda.max_memory_allocated()
                temp = max(0, peak1 - alloc0) if peak1 > peak0 else 0
            rec = record_program(
                kind, owner, counter, (_time.perf_counter() - t0) * 1e3,
                args=args, out=out[0] if isinstance(out, tuple) else out,
                temp_bytes=temp, transforms=transforms, cert=cert)
            summarize_precision(rec, args, tag=precision)
            rec.calls += 1
            state["rec"] = rec
        _tel.histogram("executor_compile_ms",
                       labels={"kind": kind}).observe(
            (_time.perf_counter() - t0) * 1e3)
        return out

    def _dispatch(args, kwargs):
        if state["first"]:
            with state["lock"]:
                if state["first"]:
                    try:
                        return _first_call(args, kwargs)
                    finally:
                        state["first"] = False
        rec = state["rec"]
        if rec is not None:
            rec.calls += 1
        return fn(*args, **kwargs)

    def wrapped(*args, **kwargs):
        out = _dispatch(args, kwargs)
        if calib_heads:
            # split the trailing observation heads off each replica's
            # outputs, feed the observer, return the clean shape
            outs, rest = out[0], tuple(out[1:])
            n = len(calib_heads)
            obs = _CALIB_OBSERVER
            clean = []
            for rep in outs:
                main, extra = list(rep[:len(rep) - n]), rep[len(rep) - n:]
                if obs is not None:
                    try:
                        obs(kind, dict(zip(calib_heads, extra)))
                    except Exception:
                        # allow-swallow(observer contract: a broken
                        # calibration observer must not fail the call
                        # it observes)
                        pass
                clean.append(main)
            out = (clean,) + rest
        san = _OUTPUT_SANITIZER
        if san is not None:
            # the hook gets THIS program's precision tag, not the
            # current global pipeline config
            san(kind, out, precision)
        return out

    return wrapped


# ---------------------------------------------------------- pipeline config
def _parse_env():
    # precision/transform mode is a declared knob (mxtpu_torch.tune): a set
    # MXTPU_PIPELINE env always wins — including set-but-empty, which
    # means "explicitly off" and must override a TunedConfig artifact —
    # otherwise the active artifact's `compile.pipeline` value applies,
    # and the default stays the empty pipeline (zero behavior change)
    raw = _os.environ.get("MXTPU_PIPELINE")
    if raw is None:
        from ..tune import registry as _knobs
        raw = _knobs.resolve("compile.pipeline") or ""
    raw = raw.strip()
    if raw.lower() in ("", "0", "none", "off", "false"):
        return ()
    return tuple(p.strip() for p in raw.split(",") if p.strip())


_CONFIGURED = _parse_env()
_CONFIG_LOCK = _conc.lock("pipeline", "_CONFIG_LOCK")
# True once configure(names) pinned an explicit pass list — an artifact
# installed later (refresh_from_knobs) must not clobber it
_CONFIG_EXPLICIT = False


def configured():
    """The active transform-pass names, in order (empty = no rewrites;
    the seam then returns every graph unchanged)."""
    return _CONFIGURED


def configure(names=None):
    """Set the process-wide pipeline. ``None`` re-reads
    ``MXTPU_PIPELINE`` (and the active TunedConfig artifact's
    ``compile.pipeline`` knob); a sequence of registered transform
    names activates them in order; ``()`` empties the pipeline.
    Affects programs built AFTER the call — already-built executables
    keep the graph they compiled."""
    global _CONFIGURED, _CONFIG_EXPLICIT
    with _CONFIG_LOCK:
        _CONFIGURED = _parse_env() if names is None \
            else tuple(str(n) for n in names)
        _CONFIG_EXPLICIT = names is not None
    return _CONFIGURED


def refresh_from_knobs():
    """Re-resolve the pipeline from env + artifact. The module snapshots
    its config at import; :func:`mxtpu_torch.tune.use` calls this so an
    artifact installed AFTER import still applies its
    ``compile.pipeline`` value — unless an explicit ``configure(names)``
    pinned the pipeline, which (like an explicit argument everywhere
    else in the knob precedence) always wins."""
    if not _CONFIG_EXPLICIT:
        configure(None)
    return _CONFIGURED


@contextlib.contextmanager
def pipeline_scope(names):
    """Temporarily activate a pipeline (tests, experiments)::

        with mxtpu_torch.compile.pipeline_scope(["bf16"]):
            mod.fit(...)
    """
    global _CONFIGURED, _CONFIG_EXPLICIT
    prev, prev_explicit = _CONFIGURED, _CONFIG_EXPLICIT
    configure(names)
    try:
        yield
    finally:
        # restore VALUE AND PROVENANCE: a scope over an env/artifact-
        # derived config must leave it refreshable, not pinned
        with _CONFIG_LOCK:
            _CONFIGURED, _CONFIG_EXPLICIT = prev, prev_explicit


# ------------------------------------------------------------ transform gate
def canonical_order(names):
    """Sequence the CATALOG transforms among themselves into the
    canonical composition order (:data:`mxtpu_torch.analysis.rewrite.
    CANONICAL_ORDER` — layout before bf16 before the annotation passes)
    regardless of how the operator listed them. Non-catalog names
    (tests, experiments) keep their exact slots, so an experimental
    pass's position stays the operator's choice."""
    from ..analysis.rewrite import CANONICAL_ORDER
    rank = {n: i for i, n in enumerate(CANONICAL_ORDER)}
    names = list(names)
    slots = [i for i, n in enumerate(names) if n in rank]
    ordered = sorted((names[i] for i in slots), key=rank.get)
    for i, n in zip(slots, ordered):
        names[i] = n
    return tuple(names)


class PipelineReport:
    """What the pipeline did to one graph: per-transform actions
    (INFO findings with per-node provenance), applied/rejected status,
    and — for a rejection — the offending verifier Finding(s)."""

    def __init__(self, kind=None, passes=()):
        self.kind = kind
        self.passes = tuple(passes)
        self.entries = []      # {name, applied, rejected, actions,
        #                         offending, error}
        self.symbol_changed = False
        # {new_arg: {"src", "scale", "axis"}} from applied passes — the
        # executor materializes these (e.g. int8 weights) at bind time
        self.prepared_args = {}

    def _add(self, name):
        e = {"name": name, "applied": False, "rejected": False,
             "actions": [], "offending": [], "error": None,
             "cert": None, "cert_refused": False}
        self.entries.append(e)
        return e

    @property
    def applied(self):
        return [e["name"] for e in self.entries if e["applied"]]

    @property
    def rejected(self):
        return [e["name"] for e in self.entries if e["rejected"]]

    @property
    def precision(self):
        """Precision tag for the diagnostics program record, or None
        when no precision-changing transform applied. An applied quant
        rewrite wins over bf16 — the program's weight streams are int8
        regardless of what precision the surviving compute runs in."""
        if "quant" in self.applied:
            return "int8_ptq"
        return "mixed_bf16" if "bf16" in self.applied else None

    @property
    def transforms(self):
        """Applied pass names, as the diagnostics ProgramRecord tag —
        what the program that compiled from this graph was built WITH
        (a rejected pass is deliberately absent: the program never saw
        its rewrite)."""
        return tuple(self.applied)

    @property
    def cert(self):
        """Certification tag for the diagnostics ProgramRecord: ``ok``
        when every applied rewrite carries an equivalence certificate,
        ``off`` when some applied rewrite was accepted with the gate
        disarmed, None when no rewrite applied (the program compiled
        from the unrewritten graph — nothing to certify)."""
        applied = [e for e in self.entries if e["applied"]]
        if not applied:
            return None
        if all(e["cert"] is not None and e["cert"].ok for e in applied):
            return "ok"
        return "off"

    def certificates(self):
        """name → :class:`~mxtpu_torch.analysis.equiv.Certificate` for every
        pass the gate examined (applied or refused)."""
        return {e["name"]: e["cert"] for e in self.entries
                if e["cert"] is not None}

    def findings(self):
        """The report flattened to the Finding schema (merged into
        ``Symbol.lint(pipeline=...)`` / ``Module.check`` reports and the
        CLI's ``--pipeline`` output)."""
        from ..analysis.findings import INFO, WARNING, Finding
        out = []
        for e in self.entries:
            if e["error"] is not None:
                out.append(Finding(
                    "pipeline", WARNING,
                    "transform '%s' crashed and was skipped: %s"
                    % (e["name"], e["error"]),
                    fix_hint="report this — a transform pass should "
                             "degrade by returning None, not raise"))
                continue
            if e["rejected"]:
                off = e["offending"][0] if e["offending"] else None
                if e["cert_refused"]:
                    cert = e["cert"]
                    out.append(Finding(
                        "pipeline", WARNING,
                        "transform '%s' REFUSED by certification: its "
                        "rewrite is not equivalent to the input graph "
                        "under its declared algebra '%s' (%s) — the "
                        "build fell back to the unrewritten graph"
                        % (e["name"],
                           (cert.algebra if cert else None)
                           or "<undeclared>",
                           cert.reason if cert else "unknown"),
                        node=off.node if off else None,
                        fix_hint="the rewrite left its declared "
                                 "algebra; fix the transform or drop "
                                 "it from MXTPU_PIPELINE"))
                else:
                    out.append(Finding(
                        "pipeline", WARNING,
                        "transform '%s' REJECTED: its output graph "
                        "fails verifier pass '%s' (%s) — the build "
                        "fell back to the unrewritten graph"
                        % (e["name"], off.pass_name if off else "?",
                           off.message if off else "unknown"),
                        node=off.node if off else None,
                        fix_hint="the rewrite is unsound for this "
                                 "graph; fix the transform or drop it "
                                 "from MXTPU_PIPELINE"))
                out.extend(e["offending"])
            else:
                cert = e.get("cert")
                certified = (", certified equivalent (algebra %s)"
                             % cert.algebra
                             if e["applied"] and cert is not None
                             and cert.ok else "")
                out.append(Finding(
                    "pipeline", INFO,
                    "transform '%s' %s (%d recorded action(s)%s)"
                    % (e["name"],
                       "applied" if e["applied"] else "made no change",
                       len(e["actions"]), certified)))
            out.extend(e["actions"])
        return out

    def to_dict(self):
        return {"kind": self.kind, "passes": list(self.passes),
                "applied": self.applied, "rejected": self.rejected,
                "symbol_changed": self.symbol_changed,
                "cert": self.cert,
                "certificates": {n: c.to_dict() for n, c in
                                 self.certificates().items()},
                "findings": [f.to_dict() for f in self.findings()]}

    def render(self):
        lines = ["compile pipeline (%s): %d transform(s); applied=%s "
                 "rejected=%s"
                 % (self.kind or "-", len(self.passes),
                    ",".join(self.applied) or "-",
                    ",".join(self.rejected) or "-")]
        lines += [f.render() for f in self.findings()]
        return "\n".join(lines)

    __str__ = render


def _verify(symbol, shapes, types, module):
    from .. import analysis as _analysis
    return _analysis.analyze(symbol, shapes=shapes, types=types,
                             module=module)


def _enrich_hints(symbol, shapes, types):
    """Resolve every variable shape/dtype the ORIGINAL graph can infer
    (including the ops' top-down ``infer_args`` parameter backfill) and
    fold them into the caller's hints. A rewrite may interpose nodes —
    e.g. a Cast between a weight and its FullyConnected — past which the
    backfill cannot reach, so the transformed graph must be analyzed
    and verified with the variables pinned to what the unrewritten
    graph already proved about them."""
    from ..analysis import provenance as _prov
    shp, dt, _events = _prov.infer_walk(symbol, shapes, types)
    out_s = dict(shapes or {})
    out_t = dict(types or {})
    for node in symbol._topo():
        if not node.is_variable:
            continue
        s = shp.get(node.name)
        if s is not None:
            out_s.setdefault(node.name, tuple(s))
        d = dt.get(node.name)
        if d is not None:
            out_t.setdefault(node.name, d)
    return out_s, out_t


def _fresh_errors(base, post):
    """Error findings of ``post`` beyond what ``base`` already had, per
    verifier pass. Counted per pass (not matched by message: node names
    legitimately differ across a rewrite); a transform is charged only
    with errors it ADDED, so a graph that already fails shape inference
    for lack of hints does not spuriously reject every rewrite."""
    from collections import Counter
    budget = Counter(f.pass_name for f in base.errors)
    fresh = []
    seen = Counter()
    for f in post.errors:
        seen[f.pass_name] += 1
        if seen[f.pass_name] > budget[f.pass_name]:
            fresh.append(f)
    return fresh


def transform_graph(symbol, kind=None, shapes=None, types=None,
                    module=None, passes=None, values=None):
    """Run the active pipeline over ``symbol``; returns
    ``(symbol', PipelineReport)``.

    Each transform runs on the current graph; if it returns a new
    Symbol, the FULL verifier suite re-runs on the result and the
    rewrite is accepted only when it adds no error-severity findings —
    otherwise it is rejected (offending Finding recorded, warning
    logged) and the pipeline continues from the unrewritten graph.
    ``passes`` overrides the configured list (the ``--pipeline`` report
    surface); with an empty pipeline the input symbol is returned
    untouched, cheaply. ``values`` (executor builds) exposes the bound
    parameter arrays to weight-materializing passes (``quant`` reads
    scales off them); passes never mutate them.
    """
    names = tuple(passes) if passes is not None else configured()
    names = canonical_order(names)
    report = PipelineReport(kind=kind, passes=names)
    if not names:
        return symbol, report
    from ..analysis import rewrite as _rw
    from ..base import MXNetError
    shapes, types = _enrich_hints(symbol, shapes, types)
    cur = symbol
    base = None  # lazy: verifier baseline of `cur`
    for name in names:
        entry = report._add(name)
        try:
            tp = _rw.get_transform(name)
        except MXNetError as exc:
            entry["error"] = str(exc)
            _log.warning("compile pipeline: %s", exc)
            continue
        tctx = _rw.TransformContext(cur, kind=kind, shapes=shapes,
                                    types=types, module=module,
                                    values=values)
        try:
            new_sym = tp.run(tctx)
        except Exception as exc:  # a broken transform must not kill builds
            entry["error"] = "%s: %s" % (type(exc).__name__, exc)
            _log.warning("compile pipeline: transform '%s' crashed: %s",
                         name, exc)
            continue
        entry["actions"] = list(tctx.actions)
        if new_sym is None or new_sym is cur:
            continue
        # a pass may INTRODUCE variables (quant's int8 weights) — fold
        # its declared hints in so the verifier re-run and every later
        # pass see their shapes/dtypes (hints for variables a rejected
        # graph dropped are inert: inference looks up by name)
        if tctx.hint_shapes or tctx.hint_types:
            shapes = dict(shapes)
            shapes.update(tctx.hint_shapes)
            types = dict(types)
            types.update(tctx.hint_types)
        if base is None:
            base = _verify(cur, shapes, types, module)
        post = _verify(new_sym, shapes, types, module)
        offending = _fresh_errors(base, post)
        if offending:
            entry["rejected"] = True
            entry["offending"] = offending
            _tel.counter("transform_rejected", labels={"pass": name}).inc()
            _log.warning(
                "compile pipeline: transform '%s' rejected for kind=%s — "
                "verifier pass '%s' fails on its output (%s); falling "
                "back to the unrewritten graph", name, kind,
                offending[0].pass_name, offending[0].message)
            continue
        if _CERT_ARMED:
            cert = _certify(tp, cur, new_sym, kind=kind, shapes=shapes,
                            types=types)
            entry["cert"] = cert
            if not cert.ok:
                entry["rejected"] = True
                entry["cert_refused"] = True
                entry["offending"] = [cert.to_finding()]
                _tel.counter(
                    "transform_cert_refused", labels={"pass": name},
                    help="pipeline rewrites refused by equivalence "
                         "certification (the build fell back to the "
                         "unrewritten graph)").inc()
                _log.warning(
                    "compile pipeline: transform '%s' REFUSED by "
                    "certification for kind=%s — %s; falling back to "
                    "the unrewritten graph", name, kind, cert.reason)
                continue
            _tel.counter(
                "transform_certified", labels={"pass": name},
                help="pipeline rewrites certified equivalent to their "
                     "input modulo the pass's declared algebra").inc()
        cur = new_sym
        base = post  # the accepted graph is the next baseline
        entry["applied"] = True
        report.prepared_args.update(tctx.prepared_args)
        _tel.counter("transform_applied", labels={"pass": name}).inc()
    report.symbol_changed = cur is not symbol
    return cur, report
