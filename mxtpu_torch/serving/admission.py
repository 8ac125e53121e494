"""Signal-driven admission control: shed load before the device wedges.

Counterpart of ``mxtpu/serving/admission.py``, pure Python and the same
rules in the same order, so the same signals give the same
``Decision``. A bounded queue says nothing about how long it will take
to drain; admission judges each request against what the session
already measures:

  * **queue-wait estimate**: pending rows x the measured per-batch cost
    (warmup cost rows, refined by live per-bucket service times) over
    the healthy replicas;
  * **watchdog age**: seconds since the watchdog saw progress, or the
    oldest active device wait;
  * **memory-ledger headroom**: live device bytes against the budget;
  * **queue occupancy**: shed a breath before ``QueueFull`` would.

A shed surfaces as :class:`AdmissionShed` (HTTP 429), counted as
``requests_shed{reason=...}`` and shown in ``/debug/state``'s
``serving_admission`` panel. :class:`DecodeAdmissionPolicy` prices a
decode request by the exact remaining tokens ahead of it.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["AdmissionShed", "AdmissionSignals", "Decision",
           "AdmissionPolicy", "SignalAdmissionPolicy",
           "DecodeAdmissionPolicy", "derive_knobs",
           "mix_service_model",
           "ACCEPTING", "DEGRADED", "SHEDDING", "STATE_NAMES"]

#: admission_state gauge values (exported, dashboard-stable)
ACCEPTING, DEGRADED, SHEDDING = 0, 1, 2
STATE_NAMES = {ACCEPTING: "accepting", DEGRADED: "degraded",
               SHEDDING: "shedding"}


class AdmissionShed(MXNetError):
    """Request shed by the admission policy — HTTP 429 (retryable)."""


class AdmissionSignals:
    """One point-in-time snapshot of the signals a policy judges.

    Built by ``ServingSession._signals()`` from structures the server
    already maintains — constructing one takes no locks and performs no
    device work (admission runs on every request's submit path).
    ``mem_headroom_frac`` is None when no memory budget is configured:
    a missing signal must read as healthy, never as evidence.
    """

    __slots__ = ("queue_depth", "queue_limit", "pending_rows",
                 "inflight_depth", "inflight_limit", "replicas",
                 "est_batch_ms", "est_queue_wait_ms", "watchdog_age_s",
                 "mem_headroom_frac", "slot_capacity", "slots_free",
                 "est_join_wait_ms", "est_tokens_ahead",
                 "blocks_capacity", "blocks_free")

    def __init__(self, queue_depth=0, queue_limit=1, pending_rows=0,
                 inflight_depth=0, inflight_limit=1, replicas=1,
                 est_batch_ms=0.0, est_queue_wait_ms=0.0,
                 watchdog_age_s=0.0, mem_headroom_frac=None,
                 slot_capacity=0, slots_free=0, est_join_wait_ms=None,
                 est_tokens_ahead=0, blocks_capacity=0, blocks_free=0):
        self.queue_depth = queue_depth
        self.queue_limit = queue_limit
        self.pending_rows = pending_rows
        self.inflight_depth = inflight_depth
        self.inflight_limit = inflight_limit
        self.replicas = replicas
        self.est_batch_ms = est_batch_ms
        self.est_queue_wait_ms = est_queue_wait_ms
        self.watchdog_age_s = watchdog_age_s
        self.mem_headroom_frac = mem_headroom_frac
        # decode (stateful sequence serving) signals — zero/None for the
        # stateless predict path, which must keep behaving identically:
        # slot occupancy of the sequence arena plus the LENGTH-AWARE
        # est-completion model (per-step cost row × expected remaining
        # tokens of the sequences ahead — docs/decode.md)
        self.slot_capacity = slot_capacity
        self.slots_free = slots_free
        self.est_join_wait_ms = est_join_wait_ms
        self.est_tokens_ahead = est_tokens_ahead
        # paged-KV observability (zero for slot arenas): the policy's
        # shed math is slot- and token-based — a full block pool fails
        # the individual sequence at alloc time instead of shedding at
        # the door, so these are REPORTED, not judged
        self.blocks_capacity = blocks_capacity
        self.blocks_free = blocks_free

    def to_dict(self):
        return {k: getattr(self, k) for k in self.__slots__}


class Decision:
    """What the policy decided for one request."""

    __slots__ = ("admit", "state", "reason")

    def __init__(self, admit, state=ACCEPTING, reason="ok"):
        self.admit = admit
        self.state = state
        self.reason = reason

    def __repr__(self):
        return "Decision(admit=%s, state=%s, reason=%r)" % (
            self.admit, STATE_NAMES.get(self.state, self.state), self.reason)


class AdmissionPolicy:
    """Base policy: admit everything (the bounded queue alone provides
    backpressure)."""

    def decide(self, signals):
        return Decision(True, ACCEPTING, "admit-all")


class SignalAdmissionPolicy(AdmissionPolicy):
    """Threshold policy over :class:`AdmissionSignals`.

    Sheds when any of the following holds (first match names the
    reason):

    * ``watchdog`` — no watchdog/device progress for
      ``watchdog_shed_s`` (default 10s): the device is wedging; queued
      work behind a wedge only deepens the postmortem;
    * ``memory`` — ledger headroom below ``min_mem_headroom`` (default
      3% of budget; skipped when no budget is configured);
    * ``queue`` — queue occupancy at/above ``queue_frac_shed`` (default
      95%) of the bound: shed with a reason before ``QueueFull`` sheds
      without one;
    * ``latency`` — estimated queue wait above ``queue_wait_budget_ms``:
      the request would blow its latency budget while still in the
      queue, so a fast 429 (client retries elsewhere) beats a slow 504.

    Between ``degrade_frac`` (default 0.5) and 1.0 of the latency
    budget the policy still admits but reports ``DEGRADED`` — the
    dashboard-visible early warning. The policy is stateless: every
    decision is a pure function of the snapshot, so concurrent
    submitters need no lock and tests need no teardown.
    """

    def __init__(self, queue_wait_budget_ms=1000.0, watchdog_shed_s=10.0,
                 min_mem_headroom=0.03, queue_frac_shed=0.95,
                 degrade_frac=0.5):
        self.queue_wait_budget_ms = float(queue_wait_budget_ms)
        self.watchdog_shed_s = float(watchdog_shed_s)
        self.min_mem_headroom = float(min_mem_headroom)
        self.queue_frac_shed = float(queue_frac_shed)
        self.degrade_frac = float(degrade_frac)

    def decide(self, s):
        if s.watchdog_age_s > self.watchdog_shed_s:
            return Decision(False, SHEDDING,
                            "watchdog: no progress for %.1fs"
                            % s.watchdog_age_s)
        if s.mem_headroom_frac is not None \
                and s.mem_headroom_frac < self.min_mem_headroom:
            return Decision(False, SHEDDING,
                            "memory: ledger headroom %.1f%% below floor"
                            % (s.mem_headroom_frac * 100.0))
        if s.queue_limit and \
                s.queue_depth >= self.queue_frac_shed * s.queue_limit:
            return Decision(False, SHEDDING,
                            "queue: depth %d at %.0f%% of bound %d"
                            % (s.queue_depth,
                               100.0 * s.queue_depth / s.queue_limit,
                               s.queue_limit))
        if s.est_queue_wait_ms > self.queue_wait_budget_ms:
            return Decision(False, SHEDDING,
                            "latency: est queue wait %.1fms over budget "
                            "%.1fms" % (s.est_queue_wait_ms,
                                        self.queue_wait_budget_ms))
        if s.est_queue_wait_ms > self.degrade_frac \
                * self.queue_wait_budget_ms:
            return Decision(True, DEGRADED,
                            "est queue wait %.1fms past %.0f%% of budget"
                            % (s.est_queue_wait_ms,
                               100.0 * self.degrade_frac))
        return Decision(True, ACCEPTING, "ok")


class DecodeAdmissionPolicy(AdmissionPolicy):
    """Length-aware admission for stateful decode serving.

    A decode request does not cost one batch: it occupies a sequence
    slot for its WHOLE remaining length (prompt + generated tokens), so
    position-based queue limits misprice it in both directions — a full
    arena of nearly-finished sequences can absorb a deep queue, while a
    full arena of fresh long sequences cannot absorb anything. The
    policy therefore prices a request's *end-to-end* admission: the
    per-step cost row (refined by the live step histogram) times the
    expected tokens until the slot it needs frees
    (``est_join_wait_ms`` / ``est_tokens_ahead``, computed by
    ``DecodeSession._signals`` from the exact remaining-token counts of
    the in-flight sequences — not from timing).

    Sheds (first match names the reason):

    * ``watchdog`` — no device progress for ``watchdog_shed_s``;
    * ``slots`` — the arena is full, more than ``join_watermark``
      requests are already queued for slots, AND the est-completion
      model says the join wait blows ``join_wait_budget_ms``. Short
      in-flight mixes keep small remaining-token counts, so the same
      queue depth still admits behind them (the mix-aware pattern,
      per-sequence);
    * ``queue`` — absolute queue occupancy backstop, as in
      :class:`SignalAdmissionPolicy`.

    Between ``degrade_frac`` and 1.0 of the join budget the policy
    admits but reports DEGRADED. Stateless like its sibling: every
    decision is a pure function of the snapshot.
    """

    def __init__(self, join_wait_budget_ms=1000.0, join_watermark=4,
                 watchdog_shed_s=10.0, queue_frac_shed=0.95,
                 degrade_frac=0.5):
        self.join_wait_budget_ms = float(join_wait_budget_ms)
        self.join_watermark = int(join_watermark)
        self.watchdog_shed_s = float(watchdog_shed_s)
        self.queue_frac_shed = float(queue_frac_shed)
        self.degrade_frac = float(degrade_frac)

    def decide(self, s):
        if s.watchdog_age_s > self.watchdog_shed_s:
            return Decision(False, SHEDDING,
                            "watchdog: no progress for %.1fs"
                            % s.watchdog_age_s)
        join_wait = s.est_join_wait_ms or 0.0
        if s.slot_capacity and s.slots_free == 0 \
                and s.queue_depth >= self.join_watermark \
                and join_wait > self.join_wait_budget_ms:
            return Decision(False, SHEDDING,
                            "slots: arena full, est join wait %.1fms "
                            "(%d tokens ahead) over budget %.1fms"
                            % (join_wait, s.est_tokens_ahead,
                               self.join_wait_budget_ms))
        if s.queue_limit and \
                s.queue_depth >= self.queue_frac_shed * s.queue_limit:
            return Decision(False, SHEDDING,
                            "queue: depth %d at %.0f%% of bound %d"
                            % (s.queue_depth,
                               100.0 * s.queue_depth / s.queue_limit,
                               s.queue_limit))
        if join_wait > self.degrade_frac * self.join_wait_budget_ms:
            return Decision(True, DEGRADED,
                            "est join wait %.1fms past %.0f%% of budget"
                            % (join_wait, 100.0 * self.degrade_frac))
        return Decision(True, ACCEPTING, "ok")


def mix_service_model(live_rows, bucket_costs, buckets, min_count=8):
    """Learn the live per-bucket service mix for the queue-wait estimate.

    The original estimate assumed every queued batch would be shaped
    like the LARGEST bucket (rows ÷ largest bucket, priced at the
    largest bucket's cost row). Under a small-bucket-heavy mix that
    model is wrong twice at once: the queue actually drains in MORE,
    CHEAPER batches — and because the per-batch price was the largest
    bucket's, the estimate over-stated the wait and admission
    over-shed (the case the mix model exists for).

    ``live_rows`` maps bucket -> ``(count, mean_service_ms)`` read off
    the per-bucket ``batch_service_ms{bucket=...}`` histograms the
    dispatcher stamps at retire time. With at least ``min_count`` total
    observations, the estimate is the MIX-WEIGHTED expectation: a
    batch ahead of you costs the traffic-weighted mean service time and
    carries the traffic-weighted mean row count. Before live traffic
    the warmup cost-registry rows price the largest bucket (the
    deploy-time prior — conservative by design: shedding a breath early
    on a cold server beats admitting into an unknown).

    Returns ``{"est_batch_ms", "est_rows_per_batch", "basis"}`` with
    ``basis`` one of ``live-mix`` / ``cost-rows`` / ``default``.
    """
    buckets = tuple(sorted(set(int(b) for b in buckets))) or (1,)
    rows = {int(b): (int(n), float(m))
            for b, (n, m) in (live_rows or {}).items()
            if n > 0 and m > 0}
    total = sum(n for n, _ in rows.values())
    if total >= min_count:
        est_ms = sum(n * m for n, m in rows.values()) / total
        est_rows = sum(b * n for b, (n, _) in rows.items()) / total
        return {"est_batch_ms": est_ms,
                "est_rows_per_batch": max(1.0, est_rows),
                "basis": "live-mix"}
    costs = {int(b): c for b, c in (bucket_costs or {}).items()
             if c and c.get("exec_ms", 0) > 0}
    if costs:
        largest = max(costs)
        return {"est_batch_ms": float(costs[largest]["exec_ms"]),
                "est_rows_per_batch": float(buckets[-1]),
                "basis": "cost-rows"}
    return {"est_batch_ms": 1.0,
            "est_rows_per_batch": float(buckets[-1]),
            "basis": "default"}


def derive_knobs(bucket_costs, buckets, marginal_tolerance=1.25):
    """Pick continuous-batching knobs from measured per-bucket cost rows.

    ``bucket_costs`` maps bucket size -> a dict with ``exec_ms`` (the
    warmup-measured steady-state batch time) and optionally ``flops``
    (the cost-registry row). The refill watermark is the smallest
    bucket whose per-row cost is within ``marginal_tolerance`` of the
    best bucket's: dispatching at that fill sacrifices <25% per-row
    efficiency versus waiting for a full batch, and waiting any longer
    buys less than the device idle time it costs. Falls back to the
    structural quarter-of-largest default when no rows were measured
    (``MXTPU_DIAG_COST=0`` and warmup skipped).

    Returns ``{"refill_watermark", "est_batch_ms", "basis"}``.
    """
    buckets = tuple(sorted(set(int(b) for b in buckets)))
    rows = {int(b): c for b, c in (bucket_costs or {}).items()
            if c and c.get("exec_ms", 0) > 0 and int(b) in buckets}
    if not rows:
        return {"refill_watermark": None, "est_batch_ms": None,
                "basis": "default"}

    def per_row(b):
        # exec_ms/row captures the amortization of fixed dispatch +
        # memory-movement cost that flops (linear in rows) cannot see
        return rows[b]["exec_ms"] / b
    best = min(per_row(b) for b in rows)
    watermark = next((b for b in sorted(rows)
                      if per_row(b) <= marginal_tolerance * best),
                     buckets[-1])
    largest_cost = rows.get(buckets[-1]) or rows[max(rows)]
    return {"refill_watermark": watermark,
            "est_batch_ms": largest_cost["exec_ms"],
            "basis": "cost-registry"}
