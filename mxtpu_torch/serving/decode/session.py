"""DecodeSession: step-granularity continuous batching for autoregressive
decode.

Counterpart of ``mxtpu/serving/decode/session.py``. A generate request is
a sequence that occupies a state slot for its whole life, rides many
device steps, and joins or leaves the in-flight batch between steps.
The session's one worker runs the loop:

    admit queued requests into free slots   (within one step)
    gather active rows from the arena       (on the device; fresh
                                             sequences zeroed in-batch)
    run one (tokens, state) -> (logits, state) bucket program
    scatter updated state back              (pad rows dropped)
    sample / emit one token per sequence    (greedy, or seeded
                                             temperature sampling in
                                             host f32 numpy)
    retire finished sequences               (EOS / max_new_tokens /
                                             deadline)

The step program is served through the ordinary serving machinery
(``ExecutorPool`` over the process-wide warm cache): cost rows, prewarm,
versioned hot-swap (``swap_model``: in-flight sequences finish on their
admission-time version). Admission prices a request's end-to-end cost,
per-step cost x the exact remaining tokens of the sequences ahead
(:class:`~mxtpu_torch.serving.admission.DecodeAdmissionPolicy`).

Three arena layouts share the loop: ``slots`` (a
:class:`SequenceSlotArena`, the default), paged ``rows`` (the same
recurrent state as one-token rows of a :class:`PagedArena`, the same
tokens), and paged ``kv`` (a growing KV cache in :class:`PagedArena`
blocks, primed by a chunked prefill program interleaved with decode
steps so a long prompt never stalls a generating sequence;
``decode_prefill_stalls`` counts violations).

The one host transfer of a step is its logits (``to_numpy``, a
registered ``decode_logits`` wait); sampling and EOS are host decisions,
so the tokens equal mxtpu's for the same logits. Closing the session
gives back the watchdog/signal hold it took and drops its warm-cache
versions.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict, deque

import numpy as _np

from ... import diagnostics as _diag
from ...analysis import concurrency as _conc
from ...base import MXNetError
from ...faults import injection as _faults
from ...ndarray import to_numpy
from ...obs import corpus as _obs_corpus
from ...obs.sampler import TraceSampler
from ..admission import (ACCEPTING, AdmissionShed, AdmissionSignals,
                         DecodeAdmissionPolicy, STATE_NAMES)
from ..batcher import BatcherClosed, QueueFull, pick_bucket
from ..metrics import MetricsRegistry
from ..pool import ExecutorPool, default_contexts, warm_cache
from .stream import TokenStream

__all__ = ["DecodeSession", "DecodeResult", "DecodeWorkerCrash",
           "serve_decode"]

log = logging.getLogger("mxtpu_torch.serving.decode")

#: hard per-request generated-token ceiling on the open data plane —
#: the `decode.max_new_tokens_default` knob's safe_range upper bound.
#: Without it one unauthenticated /v1/generate request could pin a
#: sequence slot for an arbitrary number of steps and starve admission.
MAX_NEW_TOKENS_CAP = 4096
#: total per-request step budget (prompt + generated): prefill consumes
#: one device step per prompt token too, so an uncapped prompt would
#: pin a slot just as effectively as an uncapped generation budget
MAX_REQUEST_TOKENS_CAP = 8192


class DecodeWorkerCrash(Exception):
    """The decode worker died with sequences in flight. A plain
    ``Exception`` (NOT MXNetError): infrastructure failure — the HTTP
    layer maps it to 500 and every affected waiter is answered."""


class DecodeResult:
    """Future for one generate request (``.wait(timeout)`` -> dict).

    With an attached :class:`TokenStream` (``generate_stream``), the
    terminal transition ALWAYS lands in the stream too: ``finish``
    pushes ``{"done": result}``, ``fail`` pushes ``{"error", "type"}``
    — every failure path in the session resolves the result, so a
    streaming consumer can never be left hanging."""

    __slots__ = ("event", "value", "error", "t_enqueue", "stream")

    def __init__(self):
        self.event = threading.Event()
        self.value = None
        self.error = None
        self.t_enqueue = time.monotonic()
        self.stream = None

    def finish(self, value):
        self.value = value
        self.event.set()
        if self.stream is not None:
            self.stream.put({"done": value})
            self.stream.close()

    def fail(self, exc):
        self.error = exc
        self.event.set()
        if self.stream is not None:
            self.stream.put({"error": str(exc),
                             "type": type(exc).__name__})
            self.stream.close()

    def wait(self, timeout=None):
        if not self.event.wait(timeout):
            raise TimeoutError("generate did not complete in %.3fs"
                               % timeout)
        if self.error is not None:
            raise self.error
        return self.value


class _Sequence:
    """One in-flight (or queued) generate request."""

    __slots__ = ("prompt", "max_new", "eos_id", "seed", "temperature",
                 "expire_at", "slot", "pool", "prefill_pool", "version",
                 "fresh", "pos", "out_tokens", "_rng", "item",
                 "enqueue_step", "join_step", "finish_step",
                 "req_ord", "t_admit", "t_last_tok", "trace")

    def __init__(self, prompt, max_new, eos_id, seed, temperature,
                 expire_at):
        self.prompt = prompt
        self.max_new = max_new
        self.eos_id = eos_id
        self.seed = seed
        self.temperature = temperature
        self.expire_at = expire_at
        self.slot = None
        self.pool = None
        self.prefill_pool = None
        self.version = None
        self.fresh = True
        self.pos = 0              # prompt tokens consumed so far
        self.out_tokens = []
        self._rng = None          # lazy: greedy requests never draw
        self.item = DecodeResult()
        self.enqueue_step = -1
        self.join_step = -1
        self.finish_step = -1
        self.req_ord = -1         # session-wide enqueue ordinal
        self.t_admit = None       # session clock at slot admission
        self.t_last_tok = None    # session clock at the previous emit
        self.trace = None         # exemplar event list when sampled

    def mark(self, event, t, **detail):
        """Append one exemplar timeline event (no-op unless sampled)."""
        if self.trace is not None:
            row = {"event": event, "t": round(float(t), 6)}
            if detail:
                row.update(detail)
            self.trace.append(row)

    def next_input_token(self):
        return self.prompt[self.pos] if self.pos < len(self.prompt) \
            else self.out_tokens[-1]

    def remaining_tokens(self, chunk=None):
        """Expected steps to completion: unconsumed prompt + ungenerated
        budget — the length-aware admission model's exact per-sequence
        basis (no timing involved). With ``chunk`` (the kv-mode prefill
        quantum) the unconsumed prompt prices at one step per CHUNK, and
        the final chunk's step double-counts with the first generated
        token (prefill emits it), hence the −1."""
        rem_prompt = len(self.prompt) - self.pos
        rem_new = self.max_new - len(self.out_tokens)
        if chunk and rem_prompt > 0:
            return (rem_prompt + chunk - 1) // chunk + rem_new - 1
        return rem_prompt + rem_new

    def rng(self):
        if self._rng is None:
            self._rng = _np.random.RandomState(self.seed)
        return self._rng


class DecodeSession:
    """Stateful autoregressive decode service over one hot-swappable
    step model.

    Parameters
    ----------
    symbol_json : str or Symbol — the SINGLE-STEP graph, outputs
        ``[logits] + next_states`` (see ``decode.model.lm_step_symbol``)
    params : dict — trained weights (``arg:``/``aux:`` convention)
    example_shapes : dict name -> per-sequence shape with leading dim 1
        for EVERY input: ``data`` (the token) and each state
    state_names : ordered state input names (their positions match the
        symbol's state outputs 1..n)
    buckets : allowed step batch sizes (each is compiled+warmed once)
    slot_capacity : sequence slots in the device state arena (default:
        the ``decode.slot_capacity`` knob, 8)
    max_new_tokens_default : generated-token budget when a request
        doesn't set one (knob ``decode.max_new_tokens_default``, 32)
    join_watermark : requests allowed to queue on a full arena before
        est-completion pricing sheds (knob ``decode.join_watermark``, 4)
    eos_id : session-default end-of-sequence token id (None = run to
        the token budget)
    admission : an AdmissionPolicy, None, or "auto"
        (:class:`DecodeAdmissionPolicy`)
    join_wait_budget_ms : admission budget for the estimated wait until
        a slot frees (default: the ``serving.queue_wait_budget_ms``
        knob resolution, else 1000ms)
    id2word : optional id -> str map; results gain a ``"text"`` field
    state_dtype : dtype the arena keeps sequence state in (default
        float32). ``"bfloat16"`` halves the per-slot device bytes for
        bf16-pipeline deployments — state round-trips through the
        narrow dtype between steps, a deliberate memory/precision
        trade (tokens may differ from f32-state decode)
    tuned : TunedConfig artifact (or path); precedence
        ``default < artifact < env < explicit argument``
    arena : ``"slots"`` (contiguous per-slot state, the default) or
        ``"paged"`` (block-granular :class:`PagedArena`). Paged without
        a ``paged`` bundle stores the SAME recurrent state as one-token
        rows (``rows`` layout — byte-identical tokens to ``slots``);
        with a bundle it serves a growing KV cache (``kv`` layout).
    paged : ``attn_decode_fixture``-shaped bundle for the kv layout:
        ``prefill_symbol_json`` / ``prefill_example_shapes`` /
        ``prefill_bucket_axes``, ``kv_specs`` (per-TOKEN trailing
        shapes), ``block_size``, ``max_blocks_per_seq``. The session's
        ``symbol_json`` / ``example_shapes`` are then the STEP graph
        (``data`` + ``attn_mask`` + the kv view inputs) and
        ``state_names`` must be empty.
    block_size / max_blocks_per_seq / prefill_chunk_tokens : kv-layout
        geometry and the prefill latency quantum — knobs
        ``decode.block_size`` (16), ``decode.max_blocks_per_seq`` (16),
        ``decode.prefill_chunk_tokens`` (32); explicit argument beats
        the ``paged`` bundle beats env/artifact/default
    prefill_chunked : False dispatches a sequence's WHOLE remaining
        prompt as one prefill call (the stall baseline the
        ``decode_prefill_stalls`` counter exists to indict)
    prefill_buckets : compiled chunk sizes of the prefill program
        (default: the resolved ``prefill_chunk_tokens`` alone)
    kv_blocks : shared KV block pool size (default ``slot_capacity ×
        max_blocks_per_seq`` — no oversubscription; smaller pools admit
        more sequences than worst-case fits and fail the overflowing
        SEQUENCE at block-alloc time, never the whole step)
    """

    def __init__(self, symbol_json, params, example_shapes, state_names,
                 buckets=(1, 4, 8), slot_capacity=None,
                 max_new_tokens_default=None, join_watermark=None,
                 eos_id=None, contexts=None, cache_size=8, warmup=True,
                 max_queue=None, admission="auto",
                 join_wait_budget_ms=None, version_tag="v0", id2word=None,
                 state_dtype=None, default_timeout=None, tuned=None,
                 arena="slots", paged=None, block_size=None,
                 max_blocks_per_seq=None, prefill_chunk_tokens=None,
                 prefill_chunked=True, prefill_buckets=None,
                 kv_blocks=None, clock=None, trace_sample=None):
        from ... import tune as _tune
        self.metrics = MetricsRegistry(namespace="mxtpu_decode")
        _diag.on_session_start()
        # the session clock: EVERY request-latency stamp (enqueue,
        # admission, token retire, deadline) reads this one callable, so
        # tests inject a deterministic clock and assert exact TTFT/TBT
        # values measured at token RETIRE, not at HTTP flush
        self._clock = clock if clock is not None else time.monotonic
        # seeded deterministic exemplar sampling (MXTPU_TRACE_SAMPLE, or
        # an explicit rate/sampler for tests): which requests carry a
        # structured per-token timeline is a pure function of the
        # enqueue ordinal
        if isinstance(trace_sample, TraceSampler):
            self._sampler = trace_sample
        elif trace_sample is not None:
            rate, _, seed = str(trace_sample).partition(":")
            self._sampler = TraceSampler(rate=float(rate),
                                         seed=int(seed) if seed else 0)
        else:
            self._sampler = TraceSampler()
        self._req_ord = 0
        self._sampled_traces = deque(maxlen=16)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self._state_names = list(state_names)
        if arena not in ("slots", "paged"):
            raise MXNetError("arena must be 'slots' or 'paged' (got %r)"
                             % (arena,))
        self._kind = "slots" if arena == "slots" \
            else ("kv" if paged else "rows")
        pb = dict(paged) if paged else {}
        if self._kind == "kv":
            if self._state_names:
                raise MXNetError(
                    "kv layout serves a stateless step graph — "
                    "state_names must be empty (the cache lives in the "
                    "paged arena, not in recurrent state)")
            for key in ("prefill_symbol_json", "prefill_example_shapes",
                        "prefill_bucket_axes", "kv_specs"):
                if key not in pb:
                    raise MXNetError("paged bundle missing %r" % key)
            self._kv_specs = [dict(s) for s in pb["kv_specs"]]
            self._kv_names = [s["name"] for s in self._kv_specs]
            for name in ("data", "attn_mask") + tuple(self._kv_names):
                if name not in example_shapes:
                    raise MXNetError(
                        "decode example_shapes missing %r" % name)
        else:
            for name in ("data",) + tuple(self._state_names):
                if name not in example_shapes:
                    raise MXNetError(
                        "decode example_shapes missing %r" % name)
        tuned = _tune.artifact(tuned)
        self._tuned = tuned
        self.slot_capacity = _tune.resolve_int(
            "decode.slot_capacity", explicit=slot_capacity,
            artifact=tuned, floor=1)
        self.max_new_tokens_default = _tune.resolve_int(
            "decode.max_new_tokens_default",
            explicit=max_new_tokens_default, artifact=tuned, floor=1)
        self.join_watermark = _tune.resolve_int(
            "decode.join_watermark", explicit=join_watermark,
            artifact=tuned, floor=1)
        self.max_queue = _tune.resolve_int("serving.max_queue",
                                           explicit=max_queue,
                                           artifact=tuned)
        # paged geometry: explicit argument beats the bundle beats
        # env/artifact/knob-default (rows layout pins its own below)
        self.block_size = _tune.resolve_int(
            "decode.block_size",
            explicit=block_size if block_size is not None
            else pb.get("block_size"), artifact=tuned, floor=1)
        self.max_blocks_per_seq = _tune.resolve_int(
            "decode.max_blocks_per_seq",
            explicit=max_blocks_per_seq if max_blocks_per_seq is not None
            else pb.get("max_blocks_per_seq"), artifact=tuned, floor=1)
        self.prefill_chunk_tokens = _tune.resolve_int(
            "decode.prefill_chunk_tokens", explicit=prefill_chunk_tokens,
            artifact=tuned, floor=1)
        self.prefill_chunked = bool(prefill_chunked)
        self.prefill_buckets = tuple(sorted(set(
            int(b) for b in (prefill_buckets
                             or (self.prefill_chunk_tokens,)))))
        # the declared prefill latency quantum: chunked mode dispatches
        # at most this many prompt tokens per device call; the unchunked
        # baseline dispatches up to its largest compiled bucket, and
        # every oversized dispatch while a generating sequence waits is
        # a counted stall
        self._prefill_quantum = self.prefill_chunk_tokens \
            if self.prefill_chunked else self.prefill_buckets[-1]
        join_wait_budget_ms = _tune.resolve(
            "serving.queue_wait_budget_ms", explicit=join_wait_budget_ms,
            artifact=tuned)
        if join_wait_budget_ms is None:
            join_wait_budget_ms = 1000.0
        self.eos_id = eos_id
        self.id2word = id2word
        self.default_timeout = default_timeout
        self.version_tag = version_tag
        self._generation = 0
        self._swap_seq = 0
        self._cache_size = max(cache_size, len(self.buckets))
        contexts = contexts or default_contexts(max_replicas=1)
        # single-replica by design for now: the step loop drives one
        # device (replicas[0]) — clamp rather than compile + warm N-1
        # pools that would never serve a step (multi-device decode is a
        # sharding problem, not a replica-pool one)
        contexts = list(contexts)
        if len(contexts) > 1:
            log.warning("decode: %d contexts given; using %s only",
                        len(contexts), contexts[0])
        self._contexts = contexts[:1]
        self._released = False
        self._pool = ExecutorPool(symbol_json, params, example_shapes,
                                  contexts=self._contexts,
                                  cache_size=self._cache_size,
                                  metrics=self.metrics,
                                  version_tag=version_tag)
        warm_cache().hold(self._pool.symbol_hash, version_tag, self)
        if warmup:
            with self.metrics.span("warmup"):
                self._pool.warmup(self.buckets)
        from .arena import PagedArena, SequenceSlotArena
        if self._kind == "kv":
            self._prefill_symbol_json = pb["prefill_symbol_json"]
            self._prefill_shapes = {
                k: tuple(v)
                for k, v in pb["prefill_example_shapes"].items()}
            self._prefill_bucket_axes = dict(pb["prefill_bucket_axes"])
            self._prefill_pool = ExecutorPool(
                self._prefill_symbol_json, params, self._prefill_shapes,
                contexts=self._contexts, cache_size=self._cache_size,
                metrics=self.metrics,
                version_tag=version_tag + ".prefill",
                bucket_axes=self._prefill_bucket_axes)
            warm_cache().hold(self._prefill_pool.symbol_hash,
                              version_tag + ".prefill", self)
            if warmup:
                with self.metrics.span("prefill_warmup"):
                    self._prefill_pool.warmup(self.prefill_buckets)
            blocks_total = int(kv_blocks) if kv_blocks is not None \
                else self.slot_capacity * self.max_blocks_per_seq
            self.arena = PagedArena(self.slot_capacity, self.block_size,
                                    blocks_total,
                                    self.max_blocks_per_seq,
                                    self._kv_specs,
                                    ctx=self._contexts[0],
                                    dtype=state_dtype)
        elif self._kind == "rows":
            # recurrent state as one-token rows: block geometry pinned
            # to one block of one row per slot — the byte-identity
            # bridge between the contiguous and paged gather math
            self._prefill_pool = None
            specs = [{"name": n,
                      "shape": tuple(example_shapes[n])[1:],
                      "dtype": str(state_dtype or "float32")}
                     for n in self._state_names]
            self.arena = PagedArena(self.slot_capacity, 1,
                                    self.slot_capacity, 1, specs,
                                    ctx=self._contexts[0])
        else:
            self._prefill_pool = None
            specs = [{"name": n, "shape": tuple(example_shapes[n]),
                      "dtype": str(state_dtype or "float32")}
                     for n in self._state_names]
            self.arena = SequenceSlotArena(self.slot_capacity, specs,
                                           ctx=self._contexts[0])
        # kv-mode admission prices prefill per CHUNK, not per token
        self._price_chunk = self._prefill_quantum \
            if self._kind == "kv" else None
        if admission == "auto":
            admission = DecodeAdmissionPolicy(
                join_wait_budget_ms=join_wait_budget_ms,
                join_watermark=self.join_watermark,
                watchdog_shed_s=_tune.resolve("serving.watchdog_shed_s",
                                              artifact=tuned),
                queue_frac_shed=_tune.resolve("serving.queue_frac_shed",
                                              artifact=tuned),
                degrade_frac=_tune.resolve("serving.degrade_frac",
                                           artifact=tuned))
        if admission is not None and not hasattr(admission, "decide"):
            raise MXNetError("admission must be an AdmissionPolicy "
                             "(got %r)" % (admission,))
        self._admission = admission
        self._admission_state = ACCEPTING
        self._sheds_by_reason = {}
        self._last_shed_reason = None
        self._lock = _conc.lock("DecodeSession", "_lock")
        self._work = _conc.condition(self._lock)
        self._queue = []
        self._active = []
        self._steps = 0
        self._tokens_out = 0
        self._closed = False
        self._abort = False
        self.metrics.gauge("queue_depth", fn=lambda: len(self._queue))
        self.metrics.gauge("decode_active_sequences",
                           fn=lambda: len(self._active))
        self.metrics.gauge("decode_slot_occupancy",
                           fn=lambda: self.arena.occupancy)
        self.metrics.gauge(
            "decode_tokens_per_sec",
            fn=lambda: round(self._tokens_out / self.metrics.uptime, 3)
            if self.metrics.uptime > 0 else 0.0)
        self.metrics.gauge("admission_state",
                           fn=lambda: self._admission_state)
        # the liveness tripwire exists (at 0) from construction so the
        # zero-idle-step gate reads an exact counter, not an absence
        self.metrics.counter("decode_steps_with_admittable_waiting")
        # prefill/TTFT/paged series exist from construction too — gates
        # read exact zeros, not absences
        self.metrics.counter("decode_prefill_chunks")
        self.metrics.counter("decode_prefill_tokens")
        self.metrics.counter("decode_prefill_stalls")
        self.metrics.histogram("decode_ttft_ms")
        # per-request latency attribution: time-between-tokens
        # and the per-phase breakdown exist from construction so gates
        # read exact zeros, not absences
        self.metrics.histogram("decode_tbt_ms")
        for _phase in ("admission", "prefill", "step", "retire"):
            self.metrics.histogram("decode_phase_ms",
                                   labels={"phase": _phase})
        self.metrics.counter("decode_trace_sampled")
        if self._kind != "slots":
            self.metrics.gauge("decode_kv_blocks_live",
                               fn=lambda: self.arena.blocks_live)
            self.metrics.gauge("decode_kv_blocks_free",
                               fn=lambda: self.arena.blocks_free)
            self.metrics.gauge("decode_kv_block_occupancy",
                               fn=lambda: self.arena.block_occupancy)
        self._worker = self._spawn_worker()

    # --------------------------------------------------------- versions
    @property
    def pool(self):
        return self._pool

    @property
    def example_shapes(self):
        return self._pool.example_shapes

    def swap_model(self, symbol_json, params, version_tag=None,
                   warmup=True, prefill_symbol_json=None):
        """Zero-downtime step-model rollout. The incoming pool is built
        and pre-warmed while the old one serves; the flip is one pointer
        swap. Sequences already in flight keep their admission-time pool
        (same state layout — the arena is version-agnostic) and finish
        on the OLD weights; sequences admitted after the flip run the
        new ones. Requires identical input/state shapes."""
        if self._closed:
            raise BatcherClosed("decode session is closed")
        if version_tag is None:
            with self._lock:
                self._swap_seq += 1
                version_tag = "v%d" % self._swap_seq
        new_pool = ExecutorPool(symbol_json, params, self.example_shapes,
                                contexts=self._contexts,
                                cache_size=self._cache_size,
                                metrics=self.metrics,
                                version_tag=version_tag)
        warm_cache().hold(new_pool.symbol_hash, version_tag, self)
        if warmup:
            with self.metrics.span("swap_warmup"):
                new_pool.warmup(self.buckets)
        new_prefill = None
        if self._kind == "kv":
            # the prefill program swaps IN LOCKSTEP with the step
            # program (shared weights): in-flight sequences keep their
            # admission-time (step, prefill) pool PAIR
            new_prefill = ExecutorPool(
                prefill_symbol_json or self._prefill_symbol_json,
                params, self._prefill_shapes, contexts=self._contexts,
                cache_size=self._cache_size, metrics=self.metrics,
                version_tag=version_tag + ".prefill",
                bucket_axes=self._prefill_bucket_axes)
            if warmup:
                with self.metrics.span("swap_warmup"):
                    new_prefill.warmup(self.prefill_buckets)
        with self._lock:
            self._pool = new_pool
            if new_prefill is not None:
                self._prefill_pool = new_prefill
                warm_cache().hold(new_prefill.symbol_hash,
                                  version_tag + ".prefill", self)
            self._generation += 1
            self.version_tag = version_tag
        self.metrics.counter("model_swaps").inc()
        return self.version_info()

    def version_info(self):
        return {"version": self.version_tag,
                "generation": self._generation,
                "symbol_hash": self._pool.symbol_hash,
                "mode": "decode",
                "swaps": int(self.metrics.counter("model_swaps").value)}

    # --------------------------------------------------------- admission
    def _est_step_ms(self):
        """Per-step service estimate: the live ``decode_step_ms``
        histogram once it has ≥8 observations, else the warmup-measured
        cost-registry row of the bucket a loaded arena would run
        (largest measured), else 1.0. Returns ``(ms, basis)``."""
        h = self.metrics.histogram("decode_step_ms")
        if h.count >= 8:
            return float(h.mean), "live-steps"
        rows = {int(b): c for b, c in self._pool.bucket_costs().items()
                if c and c.get("exec_ms", 0) > 0}
        if rows:
            loaded = pick_bucket(min(self.slot_capacity,
                                     self.buckets[-1]), self.buckets)
            row = rows.get(loaded) or rows[max(rows)]
            return float(row["exec_ms"]), "cost-rows"
        return 1.0, "default"

    def _signals(self):
        """Length-aware :class:`AdmissionSignals`: slot occupancy plus
        the est-completion model — per-step cost × the EXACT remaining
        token count until the slot a new arrival needs frees (sorted
        per-sequence remaining, not timing)."""
        with self._lock:
            remaining = sorted(s.remaining_tokens(self._price_chunk)
                               for s in self._active)
            queued = [s.remaining_tokens(self._price_chunk)
                      for s in self._queue]
        step_ms, _ = self._est_step_ms()
        free = self.arena.free_slots
        est_join = 0.0
        tokens_ahead = 0
        if free == 0 and self.slot_capacity:
            q = len(queued)
            rounds, pos = divmod(q, self.slot_capacity)
            tokens = remaining[min(pos, len(remaining) - 1)] \
                if remaining else 0
            if rounds:
                mean_req = (sum(queued) / len(queued)) if queued \
                    else float(self.max_new_tokens_default)
                tokens += rounds * mean_req
            tokens_ahead = int(tokens)
            est_join = step_ms * tokens
        age = _diag.progress_age_s()
        for w in _diag.active_waits():
            age = max(age, w["age_s"])
        return AdmissionSignals(
            queue_depth=len(queued),
            queue_limit=self.max_queue,
            pending_rows=len(queued),
            inflight_depth=len(self._active),
            inflight_limit=self.slot_capacity,
            replicas=len(self._pool),
            est_batch_ms=step_ms,
            est_queue_wait_ms=est_join,
            watchdog_age_s=age,
            slot_capacity=self.slot_capacity,
            slots_free=free,
            est_join_wait_ms=est_join,
            est_tokens_ahead=tokens_ahead,
            blocks_capacity=getattr(self.arena, "blocks_total", 0),
            blocks_free=getattr(self.arena, "blocks_free", 0))

    def _admit(self):
        pol = self._admission
        if pol is None:
            return
        decision = pol.decide(self._signals())
        self._admission_state = decision.state
        if not decision.admit:
            reason_key = decision.reason.split(":")[0]
            self.metrics.counter("requests_shed",
                                 labels={"reason": reason_key}).inc()
            self._sheds_by_reason[reason_key] = \
                self._sheds_by_reason.get(reason_key, 0) + 1
            self._last_shed_reason = decision.reason
            raise AdmissionShed("decode admission: %s" % decision.reason)

    def admission_snapshot(self):
        step_ms, basis = self._est_step_ms()
        return {"state": STATE_NAMES.get(self._admission_state,
                                         self._admission_state),
                "policy": type(self._admission).__name__
                if self._admission is not None else None,
                "sheds_by_reason": dict(self._sheds_by_reason),
                "last_shed_reason": self._last_shed_reason,
                "est_step_ms": step_ms,
                "step_cost_basis": basis,
                "signals": self._signals().to_dict()}

    # ------------------------------------------------------------ client
    def generate_async(self, prompt, max_new_tokens=None, eos_id=None,
                       seed=0, temperature=0.0, timeout=None,
                       stream=False):
        """Enqueue one generate request; returns a :class:`DecodeResult`
        future. Raises AdmissionShed/QueueFull under backpressure (429),
        BatcherClosed when draining (503). With ``stream=True`` the
        result carries a :class:`TokenStream` (``result.stream``) that
        receives every retired token and the terminal done/error
        event."""
        if self._closed:
            raise BatcherClosed("decode session is closed")
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise MXNetError("generate: prompt must be non-empty "
                             "(token ids)")
        max_new = int(max_new_tokens) if max_new_tokens is not None \
            else self.max_new_tokens_default
        if max_new < 1:
            raise MXNetError("generate: max_new_tokens must be >= 1")
        if max_new > MAX_NEW_TOKENS_CAP:
            raise MXNetError(
                "generate: max_new_tokens %d over the server cap %d"
                % (max_new, MAX_NEW_TOKENS_CAP))
        if len(prompt) + max_new > MAX_REQUEST_TOKENS_CAP:
            raise MXNetError(
                "generate: prompt (%d) + max_new_tokens (%d) over the "
                "per-request step cap %d"
                % (len(prompt), max_new, MAX_REQUEST_TOKENS_CAP))
        if self._kind == "kv":
            budget = self.block_size * self.max_blocks_per_seq
            if len(prompt) + max_new > budget:
                raise MXNetError(
                    "generate: prompt (%d) + max_new_tokens (%d) over "
                    "this session's KV budget %d (block_size %d × "
                    "max_blocks_per_seq %d)"
                    % (len(prompt), max_new, budget, self.block_size,
                       self.max_blocks_per_seq))
        timeout = timeout if timeout is not None else self.default_timeout
        self.metrics.counter("requests_received").inc()
        self._admit()
        now = self._clock()
        expire_at = now + timeout if timeout is not None else None
        seq = _Sequence(prompt, max_new,
                        eos_id if eos_id is not None else self.eos_id,
                        int(seed), float(temperature), expire_at)
        # re-stamp on the SESSION clock (the DecodeResult ctor used the
        # wall monotonic): every latency below subtracts this value
        seq.item.t_enqueue = now
        if stream:
            # attached BEFORE enqueue: every terminal transition after
            # this point (finish, fail, timeout, worker death, close)
            # lands in the stream too
            seq.item.stream = TokenStream()
        with self._lock:
            if self._closed:
                raise BatcherClosed("decode session is closed")
            if len(self._queue) >= self.max_queue:
                self.metrics.counter("requests_rejected").inc()
                raise QueueFull("decode queue full (%d requests)"
                                % self.max_queue)
            seq.enqueue_step = self._steps
            seq.req_ord = self._req_ord
            self._req_ord += 1
            if self._sampler.sampled(seq.req_ord):
                seq.trace = []
                seq.mark("enqueue", now, prompt_len=len(prompt),
                         max_new=max_new)
            self._queue.append(seq)
            self._work.notify()
        return seq.item

    def generate(self, prompt, timeout=None, **kwargs):
        """Synchronous generate: token ids in, result dict out
        (``tokens``, ``finish_reason``, ``version``, step provenance,
        ``text`` when the session holds an ``id2word`` map)."""
        timeout = timeout if timeout is not None else self.default_timeout
        return self.generate_async(prompt, timeout=timeout,
                                   **kwargs).wait(timeout)

    def generate_stream(self, prompt, timeout=None, **kwargs):
        """Streaming generate: returns the :class:`TokenStream` whose
        events are ``{"token", "index"}`` per retired token and a
        terminal ``{"done": result}`` / ``{"error", "type"}`` — the
        HTTP layer's ``?stream=1`` backend. The paired future stays
        reachable as ``stream`` consumers usually only need events;
        call :meth:`generate_async` with ``stream=True`` directly when
        both are wanted."""
        timeout = timeout if timeout is not None else self.default_timeout
        return self.generate_async(prompt, timeout=timeout, stream=True,
                                   **kwargs).stream

    def stats(self):
        out = self.metrics.to_dict()
        out["decode_steps"] = self._steps
        out["decode_tokens"] = self._tokens_out
        return out

    def debug_panel(self):
        """The ``/debug/state`` decode block (rendered by
        ``mxtpu_top``): slots, queue, steps, version, admission."""
        panel = {"slot_capacity": self.slot_capacity,
                 "free_slots": self.arena.free_slots,
                 "active_sequences": len(self._active),
                 "queued": len(self._queue),
                 "steps": self._steps,
                 "tokens_out": self._tokens_out,
                 "buckets": list(self.buckets),
                 "state_bytes": self.arena.state_bytes(),
                 "arena": self._kind,
                 "version": self.version_info(),
                 "admission": self.admission_snapshot(),
                 "trace_sample": {
                     "rate": self._sampler.rate,
                     "seed": self._sampler.seed,
                     "sampled": int(self.metrics.counter(
                         "decode_trace_sampled").value),
                     "held": len(self._sampled_traces)}}
        if self._kind != "slots":
            panel["kv"] = {"block_size": self.arena.block_size,
                           "blocks_total": self.arena.blocks_total,
                           "blocks_free": self.arena.blocks_free,
                           "blocks_live": self.arena.blocks_live,
                           "block_bytes": self.arena.block_bytes,
                           "live_kv_bytes": self.arena.live_kv_bytes()}
        if self._kind == "kv":
            panel["prefill"] = {
                "chunk_tokens": self.prefill_chunk_tokens,
                "chunked": self.prefill_chunked,
                "buckets": list(self.prefill_buckets),
                "chunks": int(self.metrics.counter(
                    "decode_prefill_chunks").value),
                "tokens": int(self.metrics.counter(
                    "decode_prefill_tokens").value),
                "stalls": int(self.metrics.counter(
                    "decode_prefill_stalls").value)}
        return panel

    def _progress_marker(self):
        """Monotone loop-progress stamp for the drain watchdog: decode
        steps alone miss a kv-mode drain that is busy prefilling."""
        return self._steps + int(
            self.metrics.counter("decode_prefill_chunks").value)

    @property
    def closed(self):
        return self._closed

    def close(self, drain=True):
        """Graceful shutdown: refuse new work; with ``drain=True`` run
        the loop until every queued and in-flight sequence completes,
        else fail them. Then release the state arena (the ledger's
        ``decode_state`` bytes return to baseline)."""
        if self._closed:
            return
        with self._lock:
            self._closed = True
            if not drain:
                self._abort = True
                err = BatcherClosed("decode session shut down")
                for s in self._queue:
                    s.item.fail(err)
                self._queue = []
                for s in self._active:
                    s.item.fail(err)
                # slots released after the worker exits, below
            self._work.notify_all()
        # a long but LIVE drain (large token budgets × many slots) keeps
        # the complete-everything contract: keep waiting while the loop
        # still makes step progress; only a STALLED drain is aborted
        self._worker.join(timeout=60)
        while self._worker.is_alive():
            before = self._progress_marker()
            self._worker.join(timeout=60)
            if self._worker.is_alive() \
                    and self._progress_marker() == before:
                log.error("decode: close(drain=%s) saw no step progress "
                          "for 60s — aborting the worker", drain)
                with self._lock:
                    self._abort = True
                    err = BatcherClosed("decode session shut down "
                                        "(drain aborted: no progress)")
                    for s in self._queue:
                        s.item.fail(err)
                    self._queue = []
                    self._work.notify_all()
                self._worker.join(timeout=60)
                break
        if self._worker.is_alive():
            # wedged mid-step: answer the waiters but leave the arena
            # alone — releasing slots under a live worker could corrupt
            # its in-flight gather/scatter. The watchdog owns wedges.
            log.error("decode: worker still alive after abort; "
                      "skipping arena teardown")
            self._release_process_state()
            with self._lock:
                for s in self._active:
                    if not s.item.event.is_set():
                        s.item.fail(BatcherClosed(
                            "decode session shut down (worker wedged)"))
            return
        with self._lock:
            for s in self._active:
                if s.slot is not None:
                    self.arena.release(s.slot)
                    s.slot = None
                if not s.item.event.is_set():
                    s.item.fail(BatcherClosed("decode session shut down"))
            self._active = []
        self.arena.close()
        self._release_process_state()

    def _release_process_state(self):
        """Give back the watchdog/signal hold and the warm-cache versions
        this session served."""
        if self._released:
            return
        self._released = True
        _diag.on_session_end()
        warm_cache().drop(self)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    # ------------------------------------------------------------ worker
    def _spawn_worker(self):
        t = threading.Thread(target=self._worker_main, daemon=True,
                             name="mxtpu-decode-0")
        t.start()
        return t

    def _worker_main(self):
        """Outermost frame: a normal return is a drain; ANY escaping
        exception (including an injected ``FaultKill``) is a worker
        death — every waiter is answered and, unless the session is
        closing, a fresh worker respawns off the death path."""
        try:
            self._loop()
        except BaseException as exc:
            self._on_worker_death(exc, respawn=not self._closed)

    def _on_worker_death(self, exc, respawn=True):
        crash = DecodeWorkerCrash("decode worker died: %s: %s"
                                  % (type(exc).__name__, exc))
        with self._lock:
            casualties = self._active + self._queue
            self._active = []
            self._queue = []
        for s in casualties:
            if s.slot is not None:
                self._evict(s, "error", swallow=True)
            s.item.fail(crash)
        self.metrics.counter("requests_failed").inc(len(casualties))
        # restore capacity BEFORE the postmortem dump below: the dump
        # serializes the whole debug state and new traffic must not
        # wait out a forensics write to find a live worker
        if respawn:
            log.error("decode: worker died (%s: %s) — respawning",
                      type(exc).__name__, exc)
            self.metrics.counter("decode_worker_respawns").inc()
            self._worker = self._spawn_worker()
        _diag.postmortem("decode_worker_death", exc=exc, source="serving")

    def _loop(self):
        while True:
            with self._lock:
                if self._abort:
                    return
                self._admit_queued_locked()
                active = list(self._active)
                if not active:
                    if self._closed and not self._queue:
                        return
                    self._work.wait(0.25)
                    continue
                if self._queue and self.arena.free_slots > 0:
                    # the liveness contract's tripwire: the sweep above
                    # drained every admittable request, so this stays 0
                    # — the gate asserts it from the counter, not timing
                    self.metrics.counter(
                        "decode_steps_with_admittable_waiting").inc()
            # step OUTSIDE the session lock: submitters must never block
            # behind device work. Sequences group by their admission-
            # time pool so a mid-run swap never migrates in-flight state
            # onto new weights.
            if self._kind == "kv":
                # one prefill chunk (oldest prefilling sequence, FIFO)
                # interleaved with ONE decode step per loop iteration:
                # a long prompt advances one bounded chunk at a time,
                # generating sequences advance every iteration — the
                # never-stall contract, counted not timed
                prefilling = [s for s in active
                              if s.pos < len(s.prompt)]
                decoding = [s for s in active
                            if s.pos >= len(s.prompt)]
                if prefilling:
                    s = prefilling[0]
                    try:
                        self._prefill_chunk(s, bool(decoding))
                    except Exception as exc:
                        self._fail_chunk([s], exc)
                    except BaseException:
                        self._fail_chunk([s], DecodeWorkerCrash(
                            "decode worker died mid-prefill"))
                        raise
                active = decoding
            groups = OrderedDict()
            for s in active:
                groups.setdefault(id(s.pool), (s.pool, []))[1].append(s)
            for pool, seqs in groups.values():
                for i in range(0, len(seqs), self.buckets[-1]):
                    chunk = seqs[i:i + self.buckets[-1]]
                    try:
                        if self._kind == "kv":
                            self._step_chunk_kv(pool, chunk)
                        else:
                            self._step_chunk(pool, chunk)
                    except Exception as exc:
                        self._fail_chunk(chunk, exc)
                    except BaseException:
                        # worker death mid-step (injected kill): answer
                        # this chunk before unwinding — the other chunks
                        # fall to _on_worker_death
                        self._fail_chunk(chunk, DecodeWorkerCrash(
                            "decode worker died mid-step"))
                        raise

    def _fail_chunk(self, chunk, exc):
        """A step program failure kills the CHUNK's sequences (their
        state generation is indeterminate), never the worker: waiters
        answered, slots evicted, capacity intact for the next step.
        Members that already FINISHED this step (e.g. retired cleanly
        before a later member's eviction raised) keep their result —
        fail() must never overwrite a delivered generation."""
        failed = 0
        for s in chunk:
            with self._lock:
                if s in self._active:
                    self._active.remove(s)
            if s.item.event.is_set():
                continue
            s.finish_step = self._steps
            self._evict(s, "error", swallow=True)
            s.item.fail(exc)
            failed += 1
        self.metrics.counter("requests_failed").inc(failed)
        if not isinstance(exc, MXNetError):
            _diag.postmortem("decode_step_exception", exc=exc,
                             source="serving")

    def _admit_queued_locked(self):
        """Move queued requests into free slots (caller holds the
        session lock) — the join-within-one-step contract: every
        admittable request is in the NEXT step's batch. Expired queued
        requests are reaped here, before they could waste a slot."""
        now = self._clock()
        live = []
        for s in self._queue:
            if s.expire_at is not None and now > s.expire_at:
                self.metrics.counter("requests_timed_out").inc()
                s.item.fail(TimeoutError("generate timed out in queue"))
            else:
                live.append(s)
        self._queue = live
        while self._queue:
            slot = self.arena.allocate()
            if slot is None:
                break
            s = self._queue.pop(0)
            s.slot = slot
            if self._kind == "rows":
                # rows layout: the one state row is block-allocated at
                # admission — an injected alloc failure fails THIS
                # request and the slot (with any partial table) is
                # released in the eviction's finally
                try:
                    self._ensure_blocks(s, 1)
                except Exception as exc:
                    self._evict(s, "error", swallow=True)
                    s.item.fail(exc)
                    self.metrics.counter("requests_failed").inc()
                    continue
            s.fresh = True
            s.pool = self._pool        # admission-time version pin
            s.prefill_pool = self._prefill_pool
            s.version = self.version_tag
            s.join_step = self._steps
            self._active.append(s)
            s.t_admit = now
            wait_ms = (now - s.item.t_enqueue) * 1e3
            self.metrics.histogram("decode_join_latency_ms").observe(
                wait_ms)
            # phase=admission: queue wait, enqueue -> slot grant
            self.metrics.histogram(
                "decode_phase_ms",
                labels={"phase": "admission"}).observe(wait_ms)
            s.mark("admit", now, slot=slot, step=self._steps)
            _diag.record("decode", "admit",
                         "ord=%d slot=%d" % (s.req_ord, slot))

    def _step_chunk(self, pool, seqs):
        """One device step for up to largest-bucket sequences of one
        model version: gather state, run the bucket program, scatter
        state back, emit/retire. The only host transfer is the logits."""
        bucket = pick_bucket(len(seqs), self.buckets)
        tokens = _np.zeros((bucket, 1), dtype=_np.float32)
        rows_mode = self._kind == "rows"
        pad = self.arena.pad_flat_index if rows_mode \
            else self.arena.capacity
        idx = _np.full((bucket,), pad, dtype=_np.int32)
        fresh = _np.ones((bucket,), dtype=_np.float32)
        for i, s in enumerate(seqs):
            tokens[i, 0] = s.next_input_token()
            idx[i] = self.arena.flat_index(s.slot, 0) if rows_mode \
                else s.slot
            fresh[i] = 1.0 if s.fresh else 0.0
        _faults.point("serving.decode.step")
        t0 = time.perf_counter()
        states = self.arena.gather_rows(idx, fresh) if rows_mode \
            else self.arena.gather(idx, fresh)
        rep = pool.replicas[0]
        shapes = pool.bucket_shapes(bucket)
        with rep.lock:
            pred = rep.predictor_for(shapes)
            ex = pred._executor
            feed = {"data": tokens}
            for name, st in zip(self._state_names, states):
                feed[name] = st
            # async dispatch: arg _data assignment keeps device arrays
            # on device (never Predictor.set_input's host staging path)
            ex.forward(is_train=False, **feed)
            outs = [o._data for o in ex.outputs]
        logits_dev, new_states = outs[0], outs[1:]
        if rows_mode:
            self.arena.scatter_rows(idx, new_states)
        else:
            self.arena.scatter(idx, new_states)
        for s in seqs:
            s.fresh = False
        # the per-step host sync: ONE bulk logits transfer, off every
        # lock; the registered wait doubles as the witness's blocking
        # seam and shows up in watchdog postmortems by name
        _diag.wait_begin("decode_logits")
        try:
            # the single host transfer of the step
            logits = to_numpy(logits_dev)
        finally:
            _diag.wait_end()
        self._steps += 1
        self.metrics.counter("decode_steps_total").inc()
        step_ms = (time.perf_counter() - t0) * 1e3
        self.metrics.histogram("decode_step_ms").observe(step_ms)
        self.metrics.histogram(
            "decode_phase_ms", labels={"phase": "step"}).observe(step_ms)
        _diag.record("decode", "step",
                     "n=%d step=%d %.3fms" % (len(seqs), self._steps,
                                              step_ms))
        if _obs_corpus.enabled():
            _obs_corpus.record_service("decode_step", step_ms,
                                      rows=len(seqs))
        now = self._clock()
        for s in seqs:
            s.mark("step", now, step=self._steps)
        self._advance(seqs, logits)

    def _ensure_blocks(self, s, n_tokens):
        """Grow ``s``'s KV block table to cover ``n_tokens`` positions.
        The injection point fires FIRST (chaos: a failed allocation must
        behave exactly like a dry pool); failure is per-SEQUENCE — the
        caller fails this request and its eviction releases the slot
        with every block the table already holds."""
        _faults.point("serving.decode.block_alloc")
        grew = self.arena.ensure_tokens(s.slot, n_tokens)
        if grew:
            _diag.record("decode", "block_alloc",
                         "slot=%d +%d blocks" % (s.slot, grew))
            s.mark("block_alloc", self._clock(), blocks=grew)

    def _emit_token(self, s, token):
        """The single token-retirement seam: every emitted token —
        decode step or final prefill chunk — passes through here, so
        streaming and time-to-first-token observe ALL of them.

        TTFT and TBT are stamped HERE, on the session clock, at token
        retire — before the stream put, so a slow streaming consumer
        (HTTP flush, chunked-transfer backpressure) can never inflate
        the latency series. The injected-clock test pins this contract.
        """
        first = not s.out_tokens
        s.out_tokens.append(token)
        self._tokens_out += 1
        self.metrics.counter("decode_tokens_total").inc()
        now = self._clock()
        if first:
            self.metrics.histogram("decode_ttft_ms").observe(
                (now - s.item.t_enqueue) * 1e3)
        else:
            self.metrics.histogram("decode_tbt_ms").observe(
                (now - s.t_last_tok) * 1e3)
        s.t_last_tok = now
        s.mark("token", now, index=len(s.out_tokens) - 1,
               token=int(token))
        _diag.record("decode", "token",
                     "ord=%d idx=%d" % (s.req_ord,
                                        len(s.out_tokens) - 1))
        if s.item.stream is not None:
            s.item.stream.put({"token": int(token),
                               "index": len(s.out_tokens) - 1})

    def _prefill_chunk(self, s, decoding_active):
        """One bounded prefill dispatch for ONE sequence: embed + attend
        the next ``≤ quantum`` prompt tokens against the already-cached
        positions, scatter their k/v rows, and — on the FINAL chunk —
        sample the first token from the last valid row's logits (the
        TTFT emit site). Non-final chunks never transfer logits to the
        host: the decode loop's one-sync-per-step discipline holds."""
        _faults.point("serving.decode.prefill")
        t0 = time.perf_counter()
        p0 = s.pos
        rem = len(s.prompt) - p0
        cv = min(rem, self._prefill_quantum, self.prefill_buckets[-1])
        bucket = pick_bucket(cv, self.prefill_buckets)
        self._ensure_blocks(s, p0 + cv)
        T = self.max_blocks_per_seq * self.block_size
        data = _np.zeros((bucket, 1), dtype=_np.float32)
        data[:cv, 0] = s.prompt[p0:p0 + cv]
        mask_cache = _np.zeros((bucket, T), dtype=_np.float32)
        mask_cache[:cv, :p0] = 1.0
        mask_chunk = _np.zeros((bucket, bucket), dtype=_np.float32)
        for c in range(bucket):
            if c < cv:
                mask_chunk[c, :c + 1] = 1.0
            else:
                # pad rows carry only the self bit: an all-masked
                # softmax row would be NaN; their (zero-keyed) output
                # is discarded and their scatter index is the drop
                # sentinel
                mask_chunk[c, c] = 1.0
        kv_valid = _np.zeros((1, T), dtype=_np.float32)
        kv_valid[0, :p0] = 1.0
        chunk_valid = _np.zeros((bucket, 1), dtype=_np.float32)
        chunk_valid[:cv, 0] = 1.0
        views = self.arena.gather_view([s.slot])
        pool = s.prefill_pool
        rep = pool.replicas[0]
        shapes = pool.bucket_shapes(bucket)
        with rep.lock:
            pred = rep.predictor_for(shapes)
            ex = pred._executor
            feed = {"data": data, "attn_mask_cache": mask_cache,
                    "attn_mask_chunk": mask_chunk,
                    "kv_valid_cache": kv_valid,
                    "chunk_valid": chunk_valid}
            for name, view in zip(self._kv_names, views):
                feed[name] = view
            ex.forward(is_train=False, **feed)
            outs = [o._data for o in ex.outputs]
        logits_dev, kv_rows = outs[0], outs[1:]
        flat = _np.full((bucket,), self.arena.pad_flat_index,
                        dtype=_np.int32)
        for c in range(cv):
            flat[c] = self.arena.flat_index(s.slot, p0 + c)
        self.arena.scatter_rows(flat, kv_rows)
        s.pos = p0 + cv
        self.metrics.counter("decode_prefill_chunks").inc()
        self.metrics.counter("decode_prefill_tokens").inc(cv)
        if cv > self.prefill_chunk_tokens and decoding_active:
            # the stall indictment, counted not timed: this dispatch
            # processed more prompt tokens than the declared latency
            # quantum while a generating sequence sat out the iteration
            self.metrics.counter("decode_prefill_stalls").inc()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        self.metrics.histogram("decode_prefill_chunk_ms").observe(
            prefill_ms)
        self.metrics.histogram(
            "decode_phase_ms",
            labels={"phase": "prefill"}).observe(prefill_ms)
        _diag.record("decode", "prefill_chunk",
                     "slot=%d pos=%d/%d %.3fms"
                     % (s.slot, s.pos, len(s.prompt), prefill_ms))
        if _obs_corpus.enabled():
            _obs_corpus.record_service("decode_prefill", prefill_ms,
                                       rows=cv)
        s.mark("prefill_chunk", self._clock(), pos=s.pos,
               prompt_len=len(s.prompt), tokens=cv)
        if s.pos < len(s.prompt):
            return     # mid-prompt: logits stay on device, no sync
        _diag.wait_begin("decode_prefill_logits")
        try:
            logits = to_numpy(logits_dev)
        finally:
            _diag.wait_end()
        if s.expire_at is not None and self._clock() > s.expire_at:
            self._retire(s, error=TimeoutError(
                "generate exceeded its deadline mid-prefill"),
                reason="deadline")
            return
        token = self._sample(logits[cv - 1], s)
        self._emit_token(s, token)
        if s.eos_id is not None and token == s.eos_id:
            self._retire(s, reason="eos")
        elif len(s.out_tokens) >= s.max_new:
            self._retire(s, reason="length")

    def _step_chunk_kv(self, pool, seqs):
        """One attention decode step for up to largest-bucket GENERATING
        sequences: grow block tables, gather the bucketed KV view, run
        the step program, scatter each sequence's new k/v row at its
        position, emit one token each. Same one-host-sync shape as the
        recurrent ``_step_chunk``."""
        # block growth first, per sequence, before any device work: a
        # dry pool (or injected alloc fault) fails THAT sequence alone
        # and the step proceeds for the rest
        live = []
        for s in seqs:
            try:
                self._ensure_blocks(s, s.pos + 1)
                live.append(s)
            except Exception as exc:
                with self._lock:
                    if s in self._active:
                        self._active.remove(s)
                s.finish_step = self._steps
                self._evict(s, "error", swallow=True)
                s.item.fail(exc)
                self.metrics.counter("requests_failed").inc()
        if not live:
            return
        seqs = live
        bucket = pick_bucket(len(seqs), self.buckets)
        T = self.max_blocks_per_seq * self.block_size
        _faults.point("serving.decode.step")
        t0 = time.perf_counter()
        tokens = _np.zeros((bucket, 1), dtype=_np.float32)
        mask = _np.zeros((bucket, T), dtype=_np.float32)
        slots = [None] * bucket
        flat = _np.full((bucket,), self.arena.pad_flat_index,
                        dtype=_np.int32)
        for i, s in enumerate(seqs):
            tokens[i, 0] = s.next_input_token()
            mask[i, :s.pos] = 1.0
            slots[i] = s.slot
            flat[i] = self.arena.flat_index(s.slot, s.pos)
        views = self.arena.gather_view(slots)
        rep = pool.replicas[0]
        shapes = pool.bucket_shapes(bucket)
        with rep.lock:
            pred = rep.predictor_for(shapes)
            ex = pred._executor
            feed = {"data": tokens, "attn_mask": mask}
            for name, view in zip(self._kv_names, views):
                feed[name] = view
            ex.forward(is_train=False, **feed)
            outs = [o._data for o in ex.outputs]
        logits_dev, kv_rows = outs[0], outs[1:]
        self.arena.scatter_rows(flat, kv_rows)
        for s in seqs:
            s.pos += 1
        _diag.wait_begin("decode_logits")
        try:
            # the single host transfer of the step
            logits = to_numpy(logits_dev)
        finally:
            _diag.wait_end()
        self._steps += 1
        self.metrics.counter("decode_steps_total").inc()
        step_ms = (time.perf_counter() - t0) * 1e3
        self.metrics.histogram("decode_step_ms").observe(step_ms)
        self.metrics.histogram(
            "decode_phase_ms", labels={"phase": "step"}).observe(step_ms)
        _diag.record("decode", "step",
                     "n=%d step=%d %.3fms" % (len(seqs), self._steps,
                                              step_ms))
        if _obs_corpus.enabled():
            _obs_corpus.record_service("decode_step", step_ms,
                                       rows=len(seqs))
        now = self._clock()
        for i, s in enumerate(seqs):
            s.mark("step", now, step=self._steps)
            if s.expire_at is not None and now > s.expire_at:
                self._retire(s, error=TimeoutError(
                    "generate exceeded its deadline mid-decode"),
                    reason="deadline")
                continue
            token = self._sample(logits[i], s)
            self._emit_token(s, token)
            if s.eos_id is not None and token == s.eos_id:
                self._retire(s, reason="eos")
            elif len(s.out_tokens) >= s.max_new:
                self._retire(s, reason="length")

    def _sample(self, row, seq):
        """Next token from one logits row: greedy argmax at
        ``temperature<=0`` (the default), else seeded softmax sampling —
        all float32 host math, so a request's draws depend only on its
        own (logits, seed) stream, never on batch composition."""
        if seq.temperature <= 0.0:
            return int(_np.argmax(row))
        z = row.astype(_np.float32) / _np.float32(seq.temperature)
        z = z - z.max()
        p = _np.exp(z)
        p = p / p.sum()
        r = _np.float32(seq.rng().random_sample())
        return int(min(_np.searchsorted(_np.cumsum(p), r),
                       len(row) - 1))

    def _advance(self, seqs, logits):
        """Consume one step's logits: prompt prefill advances the
        cursor, generation emits a token, finished sequences retire and
        free their slot for the NEXT step."""
        now = self._clock()
        for i, s in enumerate(seqs):
            if s.expire_at is not None and now > s.expire_at:
                self._retire(s, error=TimeoutError(
                    "generate exceeded its deadline mid-decode"),
                    reason="deadline")
                continue
            if s.pos < len(s.prompt):
                s.pos += 1
            if s.pos < len(s.prompt):
                continue   # still prefilling: logits unused by contract
            token = self._sample(logits[i], s)
            self._emit_token(s, token)
            if s.eos_id is not None and token == s.eos_id:
                self._retire(s, reason="eos")
            elif len(s.out_tokens) >= s.max_new:
                self._retire(s, reason="length")

    def _retire(self, s, reason, error=None):
        t0 = time.perf_counter()
        s.finish_step = self._steps
        with self._lock:
            if s in self._active:
                self._active.remove(s)
        self._evict(s, reason)
        now = self._clock()
        s.mark("retire", now, reason=reason,
               tokens=len(s.out_tokens), error=error is not None)
        if s.trace is not None:
            # sampled request: count it, hold the finished exemplar for
            # the debug panel, and (on success) ship it in the result
            self.metrics.counter("decode_trace_sampled").inc()
            self._sampled_traces.append(
                {"req_ord": s.req_ord, "reason": reason,
                 "error": error is not None,
                 "events": list(s.trace)})
        if error is not None:
            self.metrics.counter("requests_timed_out").inc()
            self.metrics.histogram(
                "decode_phase_ms", labels={"phase": "retire"}).observe(
                (time.perf_counter() - t0) * 1e3)
            s.item.fail(error)
            return
        self.metrics.counter("requests_completed").inc()
        request_ms = (now - s.item.t_enqueue) * 1e3
        self.metrics.histogram("request_latency_ms").observe(request_ms)
        if _obs_corpus.enabled():
            _obs_corpus.record_service("decode_request", request_ms,
                                       rows=len(s.out_tokens))
        result = {"tokens": list(s.out_tokens),
                  "prompt_len": len(s.prompt),
                  "finish_reason": reason,
                  "version": s.version,
                  "enqueue_step": s.enqueue_step,
                  "join_step": s.join_step,
                  "finish_step": s.finish_step,
                  "steps": s.finish_step - s.join_step}
        if s.trace is not None:
            result["trace"] = list(s.trace)
        if self.id2word is not None:
            result["text"] = " ".join(
                str(self.id2word.get(t, t)) for t in s.out_tokens)
        self.metrics.histogram(
            "decode_phase_ms", labels={"phase": "retire"}).observe(
            (time.perf_counter() - t0) * 1e3)
        s.item.finish(result)

    def _evict(self, s, reason, swallow=False):
        """Return a sequence's slot to the arena. The injection point
        fires FIRST, but the slot release is in a finally: an injected
        eviction failure may fail the step, never leak the slot (the
        chaos gate's no-leak contract)."""
        try:
            _faults.point("serving.decode.evict")
        except BaseException:
            if not swallow:
                raise
        finally:
            if s.slot is not None:
                self.arena.release(s.slot)
                s.slot = None
            self.metrics.counter("decode_evictions",
                                 labels={"reason": reason}).inc()


def serve_decode(symbol_json, params, example_shapes, state_names,
                 host="127.0.0.1", port=8080, block=True,
                 **session_kwargs):
    """One-call decode server: build the session, bind the socket,
    serve ``POST /v1/generate`` (plus /metrics, /debug/state, /healthz)
    over the shared serving HTTP layer. With ``block=False`` returns
    the running server; ``server.shutdown()`` drains and stops."""
    from ..server import ServingHTTPServer
    session = DecodeSession(symbol_json, params, example_shapes,
                            state_names, **session_kwargs)
    server = ServingHTTPServer(None, host=host, port=port, decode=session)
    if not block:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        return server
    try:
        server.serve_forever()
    finally:
        server.shutdown()
    return server
