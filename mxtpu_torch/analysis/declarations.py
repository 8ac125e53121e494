"""Single-source concurrency declarations: the lock hierarchy, the
hot-path module table, and the blocking-call catalog.

Counterpart of ``mxtpu/analysis/declarations.py``: the same levels in
the same order, so a lock keeps its rank across the two packages, with
the port's own owners where its classes differ (the image-record
prefetcher is ``_Prefetcher`` here). Keys of subsystems the port does
not have yet (decode, elastic, the device-memory ledger and watchdog)
stay, so the slices that port them find their level declared.
:mod:`mxtpu_torch.analysis.concurrency` (the runtime witness) checks
this hierarchy against real acquisition orders, including acquisitions
through call indirection.

Stdlib-only: importable from the lowest layers (telemetry, engine) at
module-import time with zero cycle risk.

Keys name locks by ``(owning class, attribute)`` for ``self.<attr>``
locks and ``(module basename sans .py, global name)`` for module-level
locks — the exact resolution the AST lint performs, and the tag the
tracked-lock factory (:func:`mxtpu_torch.analysis.concurrency.lock`)
stamps at creation.
"""
from __future__ import annotations

__all__ = ["LOCK_LEVELS", "LOCK_RANK", "HOT_PATHS", "ALLOWED_EDGES",
           "ALLOWED_BLOCKING", "BLOCKING_KINDS", "lock_rank",
           "level_names", "key_str"]

#: Declared lock hierarchy, outermost-first: a thread may acquire locks
#: only left→right (acquiring an earlier-level lock while holding a
#: later-level one is an inversion). Levels group locks that are never
#: nested among themselves; same-level nesting is allowed by the rule
#: and policed by the witness's observed-order cycle check instead.
#: NOTE on condition aliases: a TrackedCondition built over an existing
#: lock (batcher ``_not_empty``, snapshot ``_cond``) shares that lock's
#: key at RUNTIME — the witness only ever observes the shared lock. The
#: ``*_not_empty``/``*_cond`` keys below exist for the AST lint, which
#: resolves ``with self._cond:`` sites by attribute name.
LOCK_LEVELS = [
    ("batcher", {("DynamicBatcher", "_lock"),
                 ("DynamicBatcher", "_not_empty"),
                 ("ContinuousBatcher", "_lock"),
                 ("ContinuousBatcher", "_not_empty")}),
    # continuous-serving control plane: the hot-swap flip and
    # the warm-cache map. Held only for pointer/dict ops — never while
    # dispatching, so they sit between the batcher and the replica
    # dispatch locks.
    ("serving-swap", {("ServingSession", "_swap_lock"),
                      ("WarmExecutableCache", "_lock")}),
    # stateful decode serving: the session's queue/active bookkeeping
    # (condition shares the lock — see the alias note above) sits below
    # serving-swap (a decode hot-swap builds pools, never the reverse)
    # and above the replica dispatch locks the step loop acquires
    ("decode", {("DecodeSession", "_lock"), ("DecodeSession", "_work")}),
    # the slot/block arena free-list locks: taken under the session
    # lock at admit/evict/block-growth, never hold anything themselves
    # except telemetry
    ("decode-arena", {("SequenceSlotArena", "_lock"),
                      ("PagedArena", "_lock")}),
    # the token-stream queue (condition shares the lock): emit sites
    # hold session/arena locks while pushing, never the reverse — a
    # leaf-like level between the arena and the replica dispatch locks
    ("decode-stream", {("TokenStream", "_lock"),
                       ("TokenStream", "_ready")}),
    ("pool", {("ExecutorPool", "_rr_lock"), ("ExecutorPool", "_owned_lock"),
              ("_Replica", "lock")}),
    ("slot-state", {("FusedState", "_mem_lock")}),
    # input staging: the native-prefetcher ticket store (image_record;
    # mxtpu's owner is _NativePrefetcher)
    ("io", {("_Prefetcher", "_lock")}),
    # dist-kvstore transport: the server's barrier condition and the
    # worker client's rpc serialization lock (held across the socket
    # round trip by design — that IS its job)
    ("kvstore-transport", {("KVServer", "cv"), ("KVClient", "_lock")}),
    # the per-program first-call build lock (compile/pipeline
    # _instrument_program): held across lower+compile+record, so it must
    # come BEFORE the diagnostics registries it records into
    ("program-build", {("pipeline", "_first_call_lock")}),
    # elastic writer queue + supervisor flags. Held only for queue
    # and flag ops; telemetry emission happens outside, so they sit
    # above the registry level. The writer's condition wraps its lock.
    ("elastic", {("SnapshotWriter", "_cond"), ("SnapshotWriter", "_lock"),
                 ("Supervisor", "_lock"), ("snapshot", "_WRITER_LOCK")}),
    ("postmortem", {("diagnostics", "_PM_LOCK")}),
    # active-mesh/plan slot (sharding.plan)
    ("plan", {("plan", "_active_lock")}),
    ("ledger", {("DeviceMemoryLedger", "_lock")}),
    ("programs", {("programs", "_LOCK")}),
    # watchdog singleton construction registers gauges -> must precede
    # the telemetry registry level
    ("watchdog", {("watchdog", "_SINGLETON_LOCK")}),
    # autotuning config/registry slots: resolve() runs under serving
    # locks (warm-cache eviction) and use() pokes the compile pipeline,
    # so tune sits between watchdog and the registry/engine levels
    ("tune", {("config", "_LOCK"), ("registry", "_LOCK"),
              ("OnlineController", "_lock")}),
    # int8 calibration stats fold (compile/quant.py): observe() runs on
    # the instrumented-program return path — possibly under replica
    # dispatch locks — holds only for the per-name dict fold, and emits
    # telemetry OUTSIDE the lock, so it sits just above the registry
    ("quant-calib", {("CalibRecorder", "_lock")}),
    ("telemetry-registry", {("MetricsRegistry", "_lock"),
                            ("_DefaultRegistry", "_lock")}),
    # the compile pipeline's build and config locks sit at this level
    ("engine", {("ThreadedEngine", "_pending_lock"),
                ("pipeline", "_BUILD_LOCK"), ("pipeline", "_CONFIG_LOCK"),
                ("engine", "_ENGINE_LOCK"),
                ("KVStore", "_MESH_SUM_LOCK")}),
    # cold configuration slots policed mostly for completeness
    ("sanitizer", {("sanitizer", "_LOCK")}),
    # the fault-injection guard: point() crossings evaluate the armed
    # schedule from inside arbitrary subsystems, so its lock must be
    # acquirable under everything above
    ("faults", {("FaultSchedule", "_lock"), ("injection", "_CONF_LOCK")}),
    # the measurement-corpus appender (obs/corpus.py): taken at the
    # build/retire/step measurement seams, which may hold nearly
    # anything above; it only guards one file handle and never acquires
    # another tracked lock
    ("obs-corpus", {("corpus", "_WRITER_LOCK")}),
    # the training-health panel snapshot: written at the metric-sync
    # cadence on the training thread, read by debug_state/mxtpu_top —
    # guards one dict swap, acquires nothing
    ("health", {("health", "_PANEL_LOCK")}),
    # innermost leaves: never hold anything else
    ("leaf", {("profiler", "_lock")}),
]

#: key -> (rank, level name); shared by the lint and the witness
LOCK_RANK = {}
for _rank, (_level, _keys) in enumerate(LOCK_LEVELS):
    for _k in _keys:
        LOCK_RANK[_k] = (_rank, _level)


def lock_rank(key):
    """``(rank, level)`` for a declared key, or None (unregistered)."""
    return LOCK_RANK.get(key)


def level_names():
    return [lv for lv, _ in LOCK_LEVELS]


def key_str(key):
    """Render ``("Owner", "_attr")`` as ``Owner._attr`` (telemetry
    labels, findings, docs)."""
    return "%s.%s" % key


#: Observed-order edges exempt from the hierarchy rule, with the
#: recorded reason (the triage-pass contract: a real finding is either
#: FIXED or allowlisted here with why it is safe). Key: (held, acquired).
ALLOWED_EDGES = {
}

#: Declared blocking-call kinds the runtime witness checks at the
#: blocking seams (``concurrency.blocking(kind)`` call sites +
#: ``diagnostics.wait_begin``): a thread entering one of these while
#: holding ANY tracked hierarchy lock is a blocking-under-lock finding.
BLOCKING_KINDS = {
    "device_wait":     "executor.device_wait / watchdog-registered waits",
    "serving_collect": "bulk device→host transfer retiring a batch",
    "device_get":      "bulk device->host copy outside a registered wait",
    "sleep":           "time.sleep (retry backoff, injected latency)",
    "http":            "blocking HTTP/socket round trip",
}

#: (kind, held-lock key) pairs exempt from blocking-under-lock, with
#: recorded reasons.
ALLOWED_BLOCKING = {
    # the kvstore client lock exists to serialize the socket round trip:
    # holding it across the rpc IS its contract (one outstanding rpc per
    # connection), and nothing else is ever acquired under it
    ("http", ("KVClient", "_lock")):
        "rpc serialization lock — holding it across the round trip is "
        "the lock's declared job",
    # FOUND by the witness's first armed run (the triage-pass
    # satellite): _warmup_replica holds the dispatch lock across the
    # warmup forward+get_outputs pairs. Deliberate: warmup/respawn must
    # fence dispatchers out of a half-warmed replica, and the path is
    # deploy-time (prewarm_scope), never per-request. The hot path's
    # own collect runs OFF the lock (serving/pool.py contract).
    ("device_get", ("_Replica", "lock")):
        "deploy-time warmup measures the steady-state call under the "
        "dispatch lock on purpose — a half-warmed replica must not "
        "serve traffic; the request path collects off-lock",
}

#: hot-path modules (relative to the repo root) for the lint's
#: host-sync / swallowed-exception / f64 rules. None = the whole file;
#: a set restricts the rules to those classes (metric.py's numpy
#: fallback path is INTENTIONALLY host-bound; only its device path is
#: hot).
HOT_PATHS = {
    "mxtpu_torch/engine.py": None,
    "mxtpu_torch/executor.py": None,
    "mxtpu_torch/compile/pipeline.py": None,
    "mxtpu_torch/module/fused.py": None,
    "mxtpu_torch/serving/batcher.py": None,
    "mxtpu_torch/serving/pool.py": None,
    "mxtpu_torch/serving/server.py": None,
    "mxtpu_torch/serving/metrics.py": None,
    # admission runs on EVERY request's submit path: a host sync in a
    # signal read would serialize the whole intake behind the device
    "mxtpu_torch/serving/admission.py": None,
    # the decode step loop runs per generated token and the arena's
    # gather/scatter per device step: a stray host sync or f64 ctor
    # here lands in every token of every sequence
    "mxtpu_torch/serving/decode/session.py": None,
    "mxtpu_torch/serving/decode/arena.py": None,
    # the stream sits on every retired token's emit path
    "mxtpu_torch/serving/decode/stream.py": None,
    "mxtpu_torch/predict.py": None,
    "mxtpu_torch/metric.py": {"DeviceKernel", "DeviceMetricAccum"},
    # the device accumulate + cadence fold run between steps on the
    # training thread; detectors are pure host floats (cheap), but the
    # sync discipline (ONE pragma'd pull per cadence) is the contract
    "mxtpu_torch/obs/health.py": None,
    "mxtpu_torch/io.py": {"PrefetchingIter", "DevicePrefetchIter"},
    # the snapshot CAPTURE path runs on the training thread between
    # steps: it must enqueue device-side copies, never materialize host
    # bytes itself (the SnapshotWriter thread carries the one allowed
    # sync, pragma'd at its materialization site)
    "mxtpu_torch/elastic/snapshot.py": None,
    "mxtpu_torch/elastic/state.py": {"ElasticSession"},
    # the injection guard and the retry loop run inside every other hot
    # path — they are policed by every rule, including their own
    "mxtpu_torch/faults/injection.py": None,
    "mxtpu_torch/faults/retry.py": None,
    # the tracked-lock layer wraps every hierarchy acquisition — same
    # policing logic as the faults guard
    "mxtpu_torch/analysis/concurrency.py": None,
    # the transform catalog + its licensing analyses run inside every
    # program build (the compile-pipeline seam is already hot-listed);
    # a host sync or f64 promotion here lands in every bind/fit
    "mxtpu_torch/analysis/rewrite.py": None,
    "mxtpu_torch/analysis/dataflow.py": None,
    # the calibration observer runs on every observed inference call's
    # return path, and quantize/scale math runs per program build
    "mxtpu_torch/compile/quant.py": None,
}
