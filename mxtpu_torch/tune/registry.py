"""The knob registry: every tunable constant in the framework, declared.

Counterpart of ``mxtpu/tune/registry.py``. Every ``declare(...)`` below
is mxtpu's verbatim, those of subsystems the port does not have yet
(serving admission, decode, elastic, compile, quant) included: the
fingerprint covers the whole catalog, so leaving one out would make
``registry_version()`` differ and every artifact searched against mxtpu
stale here.

This registry fixes the naming half: one :class:`Knob` declaration per
tunable — name, owning subsystem, value kind, the hand-picked default
(preserved bit-for-bit: with no artifact the registry is a
behavior-neutral seam), the env override the subsystem already honored,
the finite candidate list the offline search enumerates, and the
certified safe range the online controller may nudge within.

Resolution precedence (the ``TunedConfig`` contract, enforced by
:func:`resolve`):

    hand-picked default  <  TunedConfig artifact  <  env var  <  explicit argument

i.e. an operator's env override always beats the artifact, and an
explicit keyword argument beats both — exactly the precedence every
subsystem already implemented for default-vs-env-vs-arg, with the
artifact slotted between default and env.

``registry_version()`` fingerprints the declarations; a ``TunedConfig``
saved against a different registry (knobs renamed, domains changed) is
STALE and rejected at load — searched values for knobs that no longer
mean the same thing must never be silently applied.

This module is intentionally stdlib-only at import time: consumers
(``compile.pipeline``, ``serving.pool``) resolve knobs during their own
module import, before the ``mxtpu`` package finishes initializing.
"""
from __future__ import annotations

import hashlib
import logging
import os
import threading
from collections import OrderedDict

from ..analysis import concurrency as _conc

__all__ = ["Knob", "declare", "get_knob", "knobs", "subsystems",
           "registry_version", "resolve", "resolve_int", "catalog_rows",
           "catalog_table"]

log = logging.getLogger("mxtpu_torch.tune")

#: the knobs the port reads; the rest of the catalog is declared for
#: ``registry_version()`` parity and read by no code of the port yet
PORTED = frozenset(("fit.max_in_flight", "fit.metric_sync",
                    "fit.device_metrics", "fit.device_prefetch",
                    "fit.batch_size", "health.cadence", "health.window",
                    "health.spike_k", "fit.remat", "compile.pipeline",
                    "compile.fuse_opt_max_kb", "compile.remat_threshold",
                    "quant.calibration_percentile", "quant.per_channel",
                    "quant.min_layer_elems",
                    "serving.max_in_flight", "serving.refill_watermark",
                    "serving.max_queue", "serving.max_delay_ms",
                    "serving.queue_wait_budget_ms",
                    "serving.watchdog_shed_s", "serving.min_mem_headroom",
                    "serving.queue_frac_shed", "serving.degrade_frac",
                    "serving.mem_budget_bytes", "serving.warm_versions",
                    "decode.slot_capacity", "decode.max_new_tokens_default",
                    "decode.join_watermark", "decode.block_size",
                    "decode.max_blocks_per_seq",
                    "decode.prefill_chunk_tokens"))

#: where each unread knob's reader comes in (ROADMAP section A), by
#: name or by subsystem prefix
_READ_LATER = (
    ("elastic.", "A.12 (elastic)"),
)


def unread_by(name):
    """None for a knob the port reads; for any other, the slice that
    brings its reader (a setting of it has no effect here yet)."""
    if name in PORTED:
        return None
    for prefix, where in _READ_LATER:
        if name == prefix or (prefix.endswith(".")
                              and name.startswith(prefix)):
            return where
    return "no slice yet"


_UNSET = object()


class Knob:
    """One declared tunable.

    * ``name``       — dotted ``<subsystem>.<knob>`` id (artifact key);
    * ``kind``       — ``int`` / ``float`` / ``bool`` / ``str`` /
      ``choice``; the ``*_or_none`` suffix admits None ("auto" — the
      consumer derives the value itself when the knob resolves to None);
    * ``default``    — the hand-picked constant this knob replaces;
    * ``env``        — the environment override the subsystem honored
      before the registry existed (empty-string env values read as
      unset);
    * ``choices``    — legal values for ``choice`` kind;
    * ``candidates`` — finite values the OFFLINE search enumerates
      (None = not searched);
    * ``safe_range`` — ``(lo, hi)`` the ONLINE controller may nudge
      within (None = never adjusted live);
    * ``help``       — one line for the generated catalog.
    """

    __slots__ = ("name", "subsystem", "kind", "default", "env", "choices",
                 "candidates", "safe_range", "help")

    def __init__(self, name, kind, default, env=None, choices=None,
                 candidates=None, safe_range=None, help=""):
        self.name = str(name)
        self.subsystem = self.name.split(".", 1)[0]
        self.kind = kind
        self.default = default
        self.env = env
        self.choices = tuple(choices) if choices is not None else None
        self.candidates = tuple(candidates) if candidates is not None \
            else None
        self.safe_range = tuple(safe_range) if safe_range is not None \
            else None
        self.help = help

    # ------------------------------------------------------------ coerce
    def coerce(self, value):
        """Normalize ``value`` to this knob's kind. String inputs follow
        the SAME parse the subsystem's env read used (bools via
        ``!= "0"``), so moving an env behind the registry cannot change
        what any existing setting means."""
        base = self.kind.replace("_or_none", "")
        if value is None:
            if self.kind.endswith("_or_none") or base == "str":
                return None if self.kind.endswith("_or_none") else ""
            raise ValueError("knob %s: None is not a legal %s"
                             % (self.name, self.kind))
        if base == "int":
            return int(float(value)) if isinstance(value, str) \
                else int(value)
        if base == "float":
            return float(value)
        if base == "bool":
            if isinstance(value, str):
                return value != "0"   # the env contract: only "0" is off
            return bool(value)
        if base == "str":
            return str(value)
        if base == "choice":
            v = str(value).lower()
            if v not in self.choices:
                raise ValueError("knob %s: %r not in %s"
                                 % (self.name, value, list(self.choices)))
            return v
        raise ValueError("knob %s: unknown kind %r" % (self.name, self.kind))

    def clamp(self, value):
        """Pin ``value`` inside the certified safe range (online nudges
        must never leave it; no-op without one)."""
        if self.safe_range is None:
            return value
        lo, hi = self.safe_range
        if lo is not None and value < lo:
            value = lo
        if hi is not None and value > hi:
            value = hi
        return value

    def fingerprint(self):
        """The part of the declaration an artifact's values depend on:
        identity + semantics, NOT the default (retuning a default must
        not strand every saved artifact)."""
        return (self.name, self.kind, self.env, self.choices,
                self.safe_range)

    def to_dict(self):
        return {"name": self.name, "subsystem": self.subsystem,
                "kind": self.kind, "default": self.default,
                "env": self.env, "choices": list(self.choices or ()) or None,
                "candidates": list(self.candidates or ()) or None,
                "safe_range": list(self.safe_range) if self.safe_range
                else None, "help": self.help}


_KNOBS = OrderedDict()
_LOCK = _conc.lock("registry", "_LOCK")


def declare(*args, **kwargs):
    """Register a knob (module import time; idempotent re-declare of an
    identical knob is allowed for reload-tolerance)."""
    k = Knob(*args, **kwargs)
    with _LOCK:
        prev = _KNOBS.get(k.name)
        if prev is not None and prev.fingerprint() != k.fingerprint():
            raise ValueError("knob %r re-declared with different "
                             "semantics" % k.name)
        _KNOBS[k.name] = k
    return k


def get_knob(name):
    try:
        return _KNOBS[name]
    except KeyError:
        raise KeyError("unknown knob %r (catalog: %s)"
                       % (name, ", ".join(sorted(_KNOBS))))


def knobs():
    """All declared knobs, in declaration order."""
    return list(_KNOBS.values())


def subsystems():
    out = []
    for k in _KNOBS.values():
        if k.subsystem not in out:
            out.append(k.subsystem)
    return out


def registry_version():
    """Stable fingerprint of the declared knob set. A ``TunedConfig``
    records the version it was searched against; a mismatch at load
    means the knobs' semantics moved and the artifact is stale."""
    h = hashlib.sha1()
    for name in sorted(_KNOBS):
        h.update(repr(_KNOBS[name].fingerprint()).encode())
    return h.hexdigest()[:12]


# ------------------------------------------------------------------ resolve
def resolve(name, explicit=None, artifact=_UNSET):
    """The single knob-resolution point every subsystem pulls through.

    ``explicit`` — the caller's keyword argument (None = not passed);
    ``artifact`` — a :class:`~mxtpu.tune.TunedConfig` (or None), or
    omitted to consult the process-active artifact
    (:func:`mxtpu_torch.tune.use` / ``MXTPU_TUNED``); pass ``False`` to
    ignore any active artifact.

    Precedence: default < artifact < env < explicit. With no artifact
    present this reproduces the subsystem's historical
    explicit-else-env-else-default behavior exactly.
    """
    knob = get_knob(name)
    if explicit is not None:
        return knob.coerce(explicit)
    if knob.env:
        raw = os.environ.get(knob.env)
        if raw is not None and raw.strip() != "":
            return knob.coerce(raw)
    if artifact is not False:
        if artifact is _UNSET or artifact is None:
            from . import config as _config   # lazy: config imports us
            artifact = _config.active()
        if artifact is not None:
            v = artifact.get(name, _UNSET)
            if v is not _UNSET:
                return knob.coerce(v)
    return knob.coerce(knob.default) if knob.default is not None else None


def resolve_int(name, explicit=None, artifact=_UNSET, floor=None):
    """``resolve`` + integer floor — the common ``max(1, int(v))``
    pattern at the old call sites."""
    v = resolve(name, explicit=explicit, artifact=artifact)
    if v is None:
        return None
    v = int(v)
    if floor is not None and v < floor:
        v = floor
    return v


# ------------------------------------------------------------------ catalog
def catalog_rows():
    """JSON-ready catalog (docs/tune.md table + ``__main__ catalog``)."""
    return [k.to_dict() for k in knobs()]


def catalog_table():
    """The knob catalog as a markdown table — docs/tune.md embeds this
    output so the doc can be regenerated instead of hand-maintained."""
    lines = ["| knob | kind | default | env | searched | safe range | "
             "meaning |", "|---|---|---|---|---|---|---|"]
    for k in knobs():
        default = "auto" if k.default is None else repr(k.default)
        lines.append(
            "| `%s` | %s | %s | %s | %s | %s | %s |"
            % (k.name, k.kind, default,
               "`%s`" % k.env if k.env else "—",
               ", ".join(repr(c) for c in k.candidates)
               if k.candidates else "—",
               "[%s, %s]" % k.safe_range if k.safe_range else "—",
               k.help))
    return "\n".join(lines)


# =================================================================== catalog
# The declarations. Defaults here ARE the hand-picked constants the
# subsystems used to inline — docs/tune.md's table and the
# behavior-neutrality test both read them from this single place.

# --- fit (Module.fit async-pipeline knobs, docs/training_pipeline.md)
declare("fit.max_in_flight", "int", 2, env="MXTPU_FIT_INFLIGHT",
        candidates=(1, 2, 3, 4, 6, 8), safe_range=(1, 8),
        help="dispatched steps kept in flight before fit blocks on the "
             "oldest (pipeline depth)")
declare("fit.metric_sync", "int_or_none", None, env="MXTPU_FIT_METRIC_SYNC",
        candidates=(1, 4, 8, 16),
        help="device->host metric sync cadence in batches (auto: derived "
             "from the batch callbacks; 0 = epoch-end only)")
declare("fit.device_metrics", "bool", True, env="MXTPU_FIT_DEVICE_METRICS",
        help="accumulate eval metrics on device via jitted kernels")
declare("fit.device_prefetch", "bool", False,
        env="MXTPU_FIT_DEVICE_PREFETCH", candidates=(False, True),
        help="stage batch N+1's device transfer from a producer thread "
             "while step N runs")
declare("fit.batch_size", "int_or_none", None, env="MXTPU_FIT_BATCH_SIZE",
        help="training batch size for drivers that build their own "
             "iterator (bench.py, tune probes); fit itself keeps the "
             "caller's iterator")
declare("fit.remat", "str", "none", env="MXTPU_REMAT",
        help="selective rematerialization policy of the fused step: "
             "none/auto/block/conv/all (memory-capacity lever; "
             "docs/perf.md). Unset or auto honor the remat_reuse "
             "pass's per-node annotations; an env-SET none/0 pins no-"
             "remat and suppresses them, like block/conv/all pin "
             "their explicit policy")

# --- training health (device-resident stats + detectors,
#     docs/observability.md "Training health")
declare("health.cadence", "int", 1, env="MXTPU_HEALTH_CADENCE",
        candidates=(1, 2, 4), safe_range=(1, 16),
        help="detector stride in metric-sync cadences: the stat rows "
             "land every sync, the detector suite runs every Nth")
declare("health.window", "int", 8, env="MXTPU_HEALTH_WINDOW",
        candidates=(4, 8, 16), safe_range=(2, 64),
        help="rolling-window length (in detector cadences) of the loss "
             "spike / divergence baselines")
declare("health.spike_k", "float", 8.0, env="MXTPU_HEALTH_SPIKE_K",
        safe_range=(2.0, 32.0),
        help="loss-spike threshold in MADs above the rolling median")

# --- serving (ServingSession / batcher / admission, docs/serving.md)
declare("serving.max_in_flight", "int", 2, env="MXTPU_SERVING_INFLIGHT",
        candidates=(1, 2, 3, 4, 6), safe_range=(1, 8),
        help="device batches each dispatcher keeps in flight per replica")
declare("serving.refill_watermark", "int_or_none", None,
        env="MXTPU_SERVING_WATERMARK", candidates=(1, 2, 4, 8, 32),
        safe_range=(1, 128),
        help="pending rows that trigger an immediate refill of a freed "
             "slot (auto: derived from the measured per-bucket cost rows)")
declare("serving.max_queue", "int", 256, env="MXTPU_SERVING_MAX_QUEUE",
        help="bounded request-queue depth; beyond it submit raises "
             "QueueFull (429)")
declare("serving.max_delay_ms", "float", 5.0,
        env="MXTPU_SERVING_MAX_DELAY_MS",
        help="batching deadline: latency donated to coalescing before a "
             "padded partial batch flushes")
declare("serving.queue_wait_budget_ms", "float_or_none", None,
        env="MXTPU_SERVING_QUEUE_WAIT_BUDGET_MS",
        candidates=(250.0, 500.0, 1000.0, 2000.0),
        safe_range=(50.0, 10000.0),
        help="admission latency budget (auto: half the request timeout "
             "when set, else 1000ms)")
declare("serving.watchdog_shed_s", "float", 10.0,
        safe_range=(2.0, 60.0),
        help="no-progress seconds after which admission sheds (wedge "
             "signal)")
declare("serving.min_mem_headroom", "float", 0.03,
        safe_range=(0.01, 0.25),
        help="ledger headroom fraction below which admission sheds")
declare("serving.queue_frac_shed", "float", 0.95,
        help="queue occupancy fraction at which admission sheds before "
             "QueueFull would")
declare("serving.degrade_frac", "float", 0.5,
        help="fraction of the latency budget past which admission "
             "reports DEGRADED")
declare("serving.mem_budget_bytes", "float", 0.0,
        env="MXTPU_SERVING_MEM_BUDGET",
        help="device-memory budget for the admission headroom signal "
             "(0 = signal off)")
declare("serving.warm_versions", "int", 4,
        env="MXTPU_SERVING_WARM_VERSIONS",
        help="model versions the process-wide WarmExecutableCache retains")

# --- decode (stateful autoregressive decode serving, docs/decode.md)
declare("decode.slot_capacity", "int", 8, env="MXTPU_DECODE_SLOTS",
        candidates=(4, 8, 16, 32), safe_range=(1, 256),
        help="sequence slots in the device-resident decode state arena "
             "(in-flight sequences per DecodeSession)")
declare("decode.max_new_tokens_default", "int", 32,
        env="MXTPU_DECODE_MAX_NEW_TOKENS",
        candidates=(16, 32, 64, 128), safe_range=(1, 4096),
        help="generated-token budget a /v1/generate request gets when it "
             "does not name its own max_new_tokens")
declare("decode.join_watermark", "int", 4,
        env="MXTPU_DECODE_JOIN_WATERMARK",
        candidates=(1, 2, 4, 8), safe_range=(1, 64),
        help="requests allowed to queue while the slot arena is full "
             "before length-aware est-completion pricing starts "
             "shedding (429)")
declare("decode.block_size", "int", 16, env="MXTPU_DECODE_BLOCK_SIZE",
        candidates=(8, 16, 32, 64), safe_range=(1, 1024),
        help="tokens per KV-cache block in the paged decode arena "
             "(allocation granularity: a sequence holds "
             "ceil(tokens/block_size) blocks)")
declare("decode.max_blocks_per_seq", "int", 16,
        env="MXTPU_DECODE_MAX_BLOCKS_PER_SEQ",
        candidates=(8, 16, 32, 64), safe_range=(1, 512),
        help="block-table length per sequence slot — block_size × this "
             "is the per-request token budget AND the bucketed "
             "attention view's time extent")
declare("decode.prefill_chunk_tokens", "int", 32,
        env="MXTPU_DECODE_PREFILL_CHUNK",
        candidates=(16, 32, 64, 128), safe_range=(1, 4096),
        help="prompt tokens per chunked-prefill dispatch — the prefill "
             "latency quantum: a longer prompt never occupies the "
             "decode loop for more than one chunk per iteration")

# --- elastic (async checkpoint cadence, docs/elastic.md)
declare("elastic.every_n_steps", "int", 0, env="MXTPU_ELASTIC_EVERY_STEPS",
        candidates=(0, 50, 200, 1000),
        help="mid-epoch snapshot cadence in global steps (0 = epoch "
             "boundaries only)")
declare("elastic.epoch_period", "int", 1, env="MXTPU_ELASTIC_EPOCH_PERIOD",
        help="epoch-boundary snapshot period (0 disables)")
declare("elastic.keep", "int", 2, env="MXTPU_ELASTIC_KEEP",
        help="checkpoint generations retained")

# --- compile (the pipeline seam, docs/compile.md)
# candidates are pipeline COMPOSITIONS, not single passes: tune.search
# explores which subset of the transform catalog pays on a workload
# instead of an operator hand-picking the pass list (the sequencing
# itself is canonical — compile.pipeline normalizes the order)
declare("compile.pipeline", "str", "", env="MXTPU_PIPELINE",
        candidates=("", "bf16", "fuse_opt", "layout", "remat_reuse",
                    "quant", "bf16,quant",
                    "bf16,fuse_opt", "bf16,fuse_opt,remat_reuse",
                    "bf16,fuse_opt,layout,remat_reuse",
                    "bf16,quant,fuse_opt,layout,remat_reuse"),
        help="transform-pass list the compile pipeline runs (comma-"
             "separated registry names; empty = no rewrites)")
declare("compile.fuse_opt_max_kb", "float", 32.0,
        env="MXTPU_FUSE_OPT_MAX_KB",
        candidates=(8.0, 32.0, 128.0, 1024.0), safe_range=(1.0, 4096.0),
        help="fuse_opt class bound: only parameters at or under this "
             "many KB batch into a shared update region (small-param "
             "chains are launch-bound; big weight chains are bandwidth-"
             "bound and the stack would cost real movement)")
declare("compile.remat_threshold", "float", 4.0,
        env="MXTPU_REMAT_THRESHOLD",
        candidates=(1.0, 2.0, 4.0, 8.0, 16.0), safe_range=(0.25, 64.0),
        help="remat_reuse annotation bar: a node's residual is "
             "recomputed in backward when its recompute-flops per saved "
             "byte is at or below this ratio")

# --- quant (int8 post-training quantization, docs/compile.md)
declare("quant.calibration_percentile", "float", 99.9,
        env="MXTPU_QUANT_PERCENTILE",
        candidates=(99.0, 99.9, 99.99, 100.0), safe_range=(90.0, 100.0),
        help="activation clipping statistic: per-batch percentile of "
             "|x| whose running max sets the per-tensor int8 scale "
             "(100.0 = plain abs-max, no clipping)")
declare("quant.per_channel", "bool", True, env="MXTPU_QUANT_PER_CHANNEL",
        candidates=(True, False),
        help="weight scales per output channel (axis 0) when on; one "
             "per-tensor scale per weight when off")
declare("quant.min_layer_elems", "int", 64, env="MXTPU_QUANT_MIN_ELEMS",
        candidates=(0, 64, 4096, 65536), safe_range=(0, 1 << 24),
        help="smallest weight (elements) the quant pass rewrites — "
             "below it the dequantize overhead beats the byte savings")


def _warn_unread_env():
    """Name every environment override set for a knob the port does not
    read: it is accepted by mxtpu and has no effect here."""
    for k in knobs():
        if k.env and os.environ.get(k.env, "").strip() \
                and k.name not in PORTED:
            log.warning("%s is set, but the port does not read knob %s "
                        "yet (its reader comes with %s): it has no effect",
                        k.env, k.name, unread_by(k.name))


_warn_unread_env()
