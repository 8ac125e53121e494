"""Offline search: cost-model-ranked candidates, probe-measured top-K.

Counterpart of ``mxtpu/tune/searcher.py``: the ranking
(:func:`search_from_rows`) is mxtpu's, verbatim, and the probes run the
port's fixtures on the device given (``ctx``, default ``gpu(0)``; pass
``cpu()`` on the host). :func:`probe_serving` measures the continuous
session at the candidate's in-flight depth and refill watermark, as
mxtpu's does.

The search implements the two-stage scheme of PAPERS "Learning to
Optimize Tensor Programs": a cheap model RANKS the whole candidate
space (pure arithmetic over the cost-registry rows — thousands of
configs cost microseconds), and only the top-K predicted candidates are
MEASURED with short deterministic probe runs on the bench fixtures.
The winner is emitted as a versioned :class:`~mxtpu_torch.tune.TunedConfig`
with the model basis and the probe evidence recorded, so the choice is
reviewable and replayable.

Determinism contract: ranking is a pure function of the input rows
(:func:`search_from_rows` — same rows, same winner; tested), candidate
enumeration order is the sorted cross product of the declared
``candidates`` domains, and every tie breaks toward the earlier
candidate.

Entry points::

    python -m mxtpu_torch.tune search --out tuned.json    # CLI
    mxtpu_torch.tune.search(out="tuned.json")             # library

The probes run in-process on the port's fixture models: the
deterministic counts (sync points, batches formed) are the acceptance
basis; wall-clock means ride along as evidence.
"""
from __future__ import annotations

import itertools
import logging
import time

from . import config as _config
from . import cost as _cost
from . import registry as _registry

__all__ = ["candidate_space", "enumerate_candidates", "rank_candidates",
           "default_candidates", "search_from_rows", "probe_fit",
           "probe_serving", "search"]

log = logging.getLogger("mxtpu_torch.tune")

#: knobs the offline search optimizes, per objective group. Grouped so
#: the cross product stays honest: fit knobs and serving knobs do not
#: interact through either prediction, so searching them jointly would
#: square the space for nothing.
FIT_KNOBS = ("fit.max_in_flight", "fit.metric_sync", "fit.device_prefetch")
SERVING_KNOBS = ("serving.max_in_flight", "serving.refill_watermark")


def default_candidates():
    """The hand-picked defaults over the searched knobs — the config
    every subsystem ran before the registry existed, used both as the
    search's basis-seeding probe config and as the comparison
    baseline.
    ``fit.metric_sync`` uses the conservative auto fallback (1: sync
    every batch — the value fit derives when an unknown batch callback
    is present)."""
    d = {n: _registry.resolve(n, artifact=False)
         for n in FIT_KNOBS + SERVING_KNOBS}
    if d.get("fit.metric_sync") is None:
        d["fit.metric_sync"] = 1
    return d


def candidate_space(names):
    """``{knob-name: (candidate values...)}`` from the registry's
    declared finite domains."""
    space = {}
    for name in names:
        k = _registry.get_knob(name)
        if not k.candidates:
            raise ValueError("knob %s has no declared candidates" % name)
        space[name] = k.candidates
    return space


def enumerate_candidates(space):
    """Sorted cross product of a candidate space, as dicts. The
    enumeration order is part of the determinism contract (ties break
    toward the earlier candidate)."""
    names = sorted(space)
    out = []
    for combo in itertools.product(*(space[n] for n in names)):
        out.append(dict(zip(names, combo)))
    return out


def rank_candidates(model, candidates, objective):
    """``[(predicted_ms, index, candidate), ...]`` sorted ascending —
    the model's ranking, cheapest first; ``index`` is the enumeration
    position (the deterministic tiebreak)."""
    ranked = []
    for i, cand in enumerate(candidates):
        ranked.append((round(float(objective(model, cand)), 9), i, cand))
    ranked.sort(key=lambda t: (t[0], t[1]))
    return ranked


def _fit_objective(model, cand):
    return model.predict_step_ms(cand["fit.max_in_flight"],
                                 cand["fit.metric_sync"],
                                 cand["fit.device_prefetch"])


def _serving_objective(model, cand, buckets=(1, 8, 32, 128)):
    return model.predict_request_ms(cand["serving.refill_watermark"],
                                    cand["serving.max_in_flight"],
                                    buckets=buckets)


def search_from_rows(bucket_costs=None, fit_basis=None, program_rows=None,
                     buckets=(1, 8, 32, 128), top_k=3):
    """The PURE half of the search: build the cost model from the given
    rows, rank both candidate spaces, and return

        (winner_values, {"fit": ranked, "serving": ranked}, model)

    with no probe runs. Same rows in, same winner out — this is the
    function the seeded-search determinism test pins, and what
    :func:`search` uses for its ranking stage.
    """
    model = _cost.CostModel(bucket_costs=bucket_costs,
                            fit_basis=fit_basis,
                            program_rows=program_rows)
    fit_ranked = rank_candidates(
        model, enumerate_candidates(candidate_space(FIT_KNOBS)),
        _fit_objective)
    serving_ranked = rank_candidates(
        model, enumerate_candidates(candidate_space(SERVING_KNOBS)),
        lambda m, c: _serving_objective(m, c, buckets=buckets))
    winner = {}
    winner.update(fit_ranked[0][2])
    winner.update(serving_ranked[0][2])
    return winner, {"fit": fit_ranked[:max(1, top_k)],
                    "serving": serving_ranked[:max(1, top_k)]}, model


# ------------------------------------------------------------------- probes
def _context(ctx):
    from ..context import gpu
    return gpu(0) if ctx is None else ctx


def _fit_fixture(batch=None, steps=16, seed=0, ctx=None):
    """A tiny deterministic MLP training setup (module, train_iter) on
    ``ctx`` (default gpu(0)); ``batch`` defaults to the
    ``fit.batch_size`` knob, else 32."""
    import numpy as _np
    from .. import io as _io
    from .. import module as _module
    from ..models import mlp

    if batch is None:
        batch = _registry.resolve_int("fit.batch_size") or 32
    sym = mlp.get_symbol(num_classes=10)
    rng = _np.random.RandomState(seed)
    n = batch * steps
    data = rng.rand(n, 784).astype(_np.float32)
    label = rng.randint(0, 10, (n,)).astype(_np.float32)
    it = _io.NDArrayIter(data, label, batch, shuffle=False,
                         label_name="softmax_label")
    mod = _module.Module(sym, context=_context(ctx), logger=log)
    return mod, it


def probe_fit(cand, steps=16, batch=None, seed=0, ctx=None):
    """Measure one fit candidate: a short deterministic training run,
    returning the SYNC-POINT counts (pacing waits + cadence metric
    syncs, read as deltas off the process telemetry registry — exact,
    not timed) plus wall-clock means as caveated evidence."""
    from .. import telemetry as _tel
    mod, it = _fit_fixture(batch=batch, steps=steps, seed=seed, ctx=ctx)
    h_pace = _tel.histogram("fit_sync_wait_ms")
    h_msync = _tel.histogram("fit_metric_sync_ms")
    h_step = _tel.histogram("fit_step_ms")
    # WINDOW deltas off the cumulative process histograms — count AND
    # sum, so this probe's mean is not contaminated by earlier probes
    # in the same process (the evidence must describe THIS candidate)
    before = (h_pace.count, h_msync.count, h_step.count,
              h_step.mean * h_step.count)
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=1, eval_metric="acc", optimizer="sgd",
            optimizer_params={"learning_rate": 0.01},
            max_in_flight=cand["fit.max_in_flight"],
            metric_sync=cand["fit.metric_sync"],
            device_prefetch=cand["fit.device_prefetch"],
            tuned=False)
    wall_ms = (time.perf_counter() - t0) * 1e3
    pacing_waits = h_pace.count - before[0]
    metric_syncs = h_msync.count - before[1]
    n_steps = h_step.count - before[2]
    step_sum = h_step.mean * h_step.count - before[3]
    return {"candidate": dict(cand),
            "steps": n_steps,
            "pacing_waits": pacing_waits,
            "metric_syncs": metric_syncs,
            "sync_points": pacing_waits + metric_syncs,
            "step_ms_mean": round(step_sum / n_steps, 3) if n_steps
            else 0.0,
            "wall_ms": round(wall_ms, 1)}


def probe_serving(cand, fixture="mlp", buckets=(1, 8), n_requests=48,
                  wave=6, seed=0, ctx=None):
    """Measure one serving candidate: a deterministic burst of
    single-row requests through a continuous session on ``ctx`` at the
    candidate's in-flight depth and refill watermark, returning batch
    formation / refill / idle-gap counts, the fill ratio and the warm
    per-bucket cost rows."""
    import numpy as _np
    from ..models.serving_fixtures import get_fixture
    from ..serving import ServingSession

    sym_json, params, shapes = get_fixture(fixture, seed=seed)
    rng = _np.random.RandomState(seed)
    payloads = [{"data": rng.rand(*shapes["data"]).astype(_np.float32)}
                for _ in range(wave)]
    sess = ServingSession(
        sym_json, params, shapes, buckets=buckets, max_delay_ms=2.0,
        mode="continuous", warmup=True, tuned=False,
        max_in_flight=cand["serving.max_in_flight"],
        refill_watermark=cand["serving.refill_watermark"],
        contexts=[_context(ctx)])
    try:
        items = []
        for i in range(n_requests):
            items.append(sess.predict_async(payloads[i % wave]))
            if (i + 1) % wave == 0:
                for it in items:
                    it.wait(30)
                items = []
        for it in items:
            it.wait(30)
        m = sess.metrics
        formed = m.counter("batches_formed").value
        refilled = m.counter("batches_refilled").value
        gaps = m.histogram("dispatch_idle_gap_ms")
        valid = m.counter("batch_rows_valid").value
        padded = m.counter("batch_rows_padded").value
        costs = sess.pool.bucket_costs()
    finally:
        sess.close()
    total = valid + padded
    return {"candidate": dict(cand),
            "batches_formed": int(formed),
            "batches_refilled": int(refilled),
            "idle_gaps": gaps.count,
            "idle_gap_mean_ms": round(gaps.mean, 3),
            "batch_fill_ratio": round(valid / total, 4) if total else 0.0,
            "bucket_costs": {str(b): c for b, c in costs.items()}}


# ------------------------------------------------------------------- search
def search(fixture="mlp", buckets=(1, 8), top_k=3, probe=True,
           probe_steps=16, out=None, logger=None, ctx=None):
    """The offline search (``python -m mxtpu_torch.tune search``),
    its probes on ``ctx`` (default gpu(0)).

    1. **Seed the basis**: one default-config probe each for fit and
       serving populates the live telemetry means, the AOT program
       rows, and the per-bucket ``exec_ms`` rows.
    2. **Rank**: the cost model predicts end-to-end step/request cost
       for every candidate (:func:`search_from_rows`).
    3. **Measure**: only the top-K predicted candidates run probes;
       the measured sync-point / batch counts pick the winner (ties →
       higher-ranked prediction).
    4. **Emit**: a :class:`TunedConfig` with values, basis, per-
       candidate evidence and an ``offline-search`` provenance entry —
       saved to ``out`` when given.
    """
    lg = logger or log
    from .. import diagnostics as _diag
    from .. import telemetry as _tel

    defaults = default_candidates()
    lg.info("tune.search: seeding basis with default-config probes "
            "(fixture=%s)", fixture)
    seed_fit = probe_fit(defaults, steps=probe_steps, ctx=ctx)
    seed_serving = probe_serving(defaults, fixture=fixture,
                                 buckets=buckets, ctx=ctx)
    bucket_costs = {int(b): c
                    for b, c in seed_serving["bucket_costs"].items()}
    fit_basis = {
        "step_exec_ms": max(_tel.histogram("fit_step_ms").mean, 1e-3),
        "dispatch_ms": max(_tel.histogram("fit_dispatch_ms").mean, 1e-3),
        "metric_sync_ms": max(_tel.histogram("fit_metric_sync_ms").mean,
                              1e-3),
        "assemble_ms": max(_tel.histogram("io_batch_assemble_ms").mean,
                           0.0),
    }
    program_rows = _diag.programs()
    winner, ranked, model = search_from_rows(
        bucket_costs=bucket_costs, fit_basis=fit_basis,
        program_rows=program_rows, buckets=buckets, top_k=top_k)

    evidence = [{"stage": "seed", "group": "fit", **seed_fit},
                {"stage": "seed", "group": "serving", **seed_serving}]
    if probe:
        best_fit = None
        for pred, idx, cand in ranked["fit"]:
            measured = probe_fit(cand, steps=probe_steps, ctx=ctx)
            measured.update(stage="probe", group="fit",
                            predicted_step_ms=pred, rank=idx)
            evidence.append(measured)
            key = (measured["sync_points"], pred, idx)
            if best_fit is None or key < best_fit[0]:
                best_fit = (key, cand)
        winner.update(best_fit[1])
        best_srv = None
        for pred, idx, cand in ranked["serving"]:
            measured = probe_serving(cand, fixture=fixture,
                                     buckets=buckets, ctx=ctx)
            measured.update(stage="probe", group="serving",
                            predicted_request_ms=pred, rank=idx)
            evidence.append(measured)
            # fewer formed batches at equal traffic = better coalescing;
            # predicted cost then enumeration order break ties
            key = (measured["batches_formed"], pred, idx)
            if best_srv is None or key < best_srv[0]:
                best_srv = (key, cand)
        winner.update(best_srv[1])

    cfg = _config.TunedConfig(
        values=winner,
        basis={"fixture": fixture, "buckets": list(buckets),
               "cost_model": model.to_dict(),
               "defaults_compared": defaults},
        evidence=evidence,
        created=time.strftime("%Y-%m-%dT%H:%M:%S%z"))
    cfg.record("offline-search", fixture=fixture, top_k=top_k,
               probed=bool(probe),
               predicted_fit_ranking=[[p, c] for p, _, c in ranked["fit"]],
               predicted_serving_ranking=[[p, c] for p, _, c
                                          in ranked["serving"]])
    for name in sorted(winner):
        lg.info("tune.search: %s = %r (default %r)", name, winner[name],
                defaults.get(name))
    if out:
        cfg.save(out)
        lg.info("tune.search: wrote %s", out)
    return cfg
