"""Deterministic cost model over the measured rows the framework keeps.

Counterpart of ``mxtpu/tune/cost.py``, its arithmetic verbatim: the same
rows rank the same candidates the same way in both packages. The rows
here are the port's program table (``diagnostics.programs()``: the
flops and bytes of each program's first call, from
``diagnostics.programs.CostCounter``) and serving's warm per-bucket ms.

The design follows PAPERS "Learning to Optimize Tensor Programs" (a
cost model guiding search so only the top predicted candidates are
measured) and "Value Function Based Performance Optimization of Deep
Learning Workloads" (predicting a config's END-TO-END value — step
time, request latency — without running it). The model here is
deliberately small and closed-form: it is seeded from numbers the
framework already measures deterministically —

* the program-table rows (``diagnostics.programs()``: flops,
  bytes-accessed, build ms per program), and
* the per-bucket ``exec_ms`` rows serving warmup measures
  (``ExecutorPool.bucket_costs()``),

and every prediction is pure arithmetic over those rows, so the same
rows always rank candidates the same way (the seeded-search determinism
contract).

Two predictions:

* :meth:`CostModel.predict_request_ms` — serving: per-request cost of a
  (watermark, in-flight-depth) config, decomposed into per-row service,
  accumulation wait, and the dispatch overhead a deeper in-flight
  window hides;
* :meth:`CostModel.predict_step_ms` — training: per-step cost of an
  (in-flight, metric-sync, prefetch) config, decomposed into dispatch,
  amortized metric-sync, pipeline pacing, and the input-assembly stall
  prefetch hides.

The absolute numbers are estimates; the RANKING over candidates is what
search consumes, and the decomposition is recorded in the artifact's
``basis`` so a reader can replay it.
"""
from __future__ import annotations

__all__ = ["ServiceLine", "CostModel"]

#: deterministic fallback rates when no measured rows exist at all
#: (flops/ms and bytes/ms of a nominal host) — only reached when both
#: warmup and the AOT capture were disabled
_FALLBACK_FLOPS_PER_MS = 5.0e7
_FALLBACK_BYTES_PER_MS = 1.0e8


class ServiceLine:
    """``service_ms(rows) ≈ fixed + marginal * rows`` — the two-parameter
    line least-squares-fit to the measured per-bucket rows. ``fixed``
    captures dispatch + compile-amortized overhead the per-row flops
    cannot see; ``marginal`` is the true per-row cost."""

    __slots__ = ("fixed", "marginal", "basis")

    def __init__(self, fixed, marginal, basis):
        self.fixed = float(fixed)
        self.marginal = float(marginal)
        self.basis = basis    # "bucket-rows" / "aot-rows" / "fallback"

    def __call__(self, rows):
        return self.fixed + self.marginal * max(0, rows)

    def to_dict(self):
        return {"fixed_ms": round(self.fixed, 6),
                "marginal_ms_per_row": round(self.marginal, 6),
                "basis": self.basis}

    @classmethod
    def fit(cls, bucket_costs, program_row=None):
        """Fit the line from ``{bucket: {"exec_ms": ...}}`` rows.

        Two or more buckets: exact least squares (closed form — no
        numpy dependency, bit-stable across platforms). One bucket: the
        AOT row's flops split the single measurement into fixed vs
        marginal (flops are linear in rows, so the flops-implied time
        is the marginal part). No rows: the deterministic fallback off
        the AOT flops/bytes alone.
        """
        rows = sorted((int(b), float(c["exec_ms"]))
                      for b, c in (bucket_costs or {}).items()
                      if c and c.get("exec_ms", 0) > 0)
        if len(rows) >= 2:
            n = float(len(rows))
            sx = sum(b for b, _ in rows)
            sy = sum(m for _, m in rows)
            sxx = sum(b * b for b, _ in rows)
            sxy = sum(b * m for b, m in rows)
            denom = n * sxx - sx * sx
            marginal = (n * sxy - sx * sy) / denom if denom else 0.0
            fixed = (sy - marginal * sx) / n
            # a super-linear bucket curve can drive the intercept
            # negative; clamp — a negative fixed cost would make the
            # search prefer absurdly small watermarks for free
            return cls(max(0.0, fixed), max(0.0, marginal), "bucket-rows")
        if len(rows) == 1:
            b, exec_ms = rows[0]
            flops = float((program_row or {}).get("flops", 0.0))
            flops_ms = flops / _FALLBACK_FLOPS_PER_MS if flops else 0.0
            marginal = min(exec_ms, flops_ms) / b if b else 0.0
            if marginal <= 0.0:
                marginal = exec_ms / b * 0.5 if b else 0.0
            return cls(max(0.0, exec_ms - marginal * b), marginal,
                       "bucket-rows")
        row = program_row or {}
        est = (float(row.get("flops", 0.0)) / _FALLBACK_FLOPS_PER_MS
               + float(row.get("bytes_accessed", 0.0))
               / _FALLBACK_BYTES_PER_MS)
        return cls(max(est * 0.25, 0.01), max(est * 0.75, 0.01),
                   "aot-rows" if row else "fallback")


class CostModel:
    """End-to-end cost prediction for candidate knob configs.

    Parameters
    ----------
    bucket_costs : {bucket: {"exec_ms", "flops", "bytes_accessed",
        "compile_ms"}} — serving warmup's per-bucket rows
    fit_basis : dict with the training-side measured means —
        ``step_exec_ms`` (device step), ``dispatch_ms`` (host dispatch),
        ``metric_sync_ms`` (one cadence snapshot), ``assemble_ms``
        (host batch assembly). Missing keys fall back to AOT-derived
        estimates.
    program_rows : list of AOT registry rows (``diagnostics.programs()``)
        — the per-kind flops/bytes basis used where live numbers are
        missing.
    """

    def __init__(self, bucket_costs=None, fit_basis=None,
                 program_rows=None):
        self.bucket_costs = {int(b): dict(c)
                             for b, c in (bucket_costs or {}).items()}
        self.program_rows = list(program_rows or [])
        self.fit_basis = dict(fit_basis or {})
        fwd = self._row("fwd_eval")
        self.service = ServiceLine.fit(self.bucket_costs, fwd)
        step_row = self._row("fused_step")
        if "step_exec_ms" not in self.fit_basis:
            est = (float(step_row.get("flops", 0.0))
                   / _FALLBACK_FLOPS_PER_MS
                   + float(step_row.get("bytes_accessed", 0.0))
                   / _FALLBACK_BYTES_PER_MS) if step_row else 1.0
            self.fit_basis["step_exec_ms"] = max(est, 0.01)
        self.fit_basis.setdefault(
            "dispatch_ms", self.fit_basis["step_exec_ms"] * 0.25)
        self.fit_basis.setdefault(
            "metric_sync_ms", self.fit_basis["dispatch_ms"] * 0.5)
        self.fit_basis.setdefault("assemble_ms", 0.0)

    def _row(self, kind):
        for r in reversed(self.program_rows):
            if r.get("kind") == kind:
                return r
        return {}

    # --------------------------------------------------------- serving
    def predict_request_ms(self, watermark, in_flight, buckets=(1, 8, 32,
                                                                128)):
        """Predicted steady-state per-request cost of a continuous-
        batching config, per row. Three terms:

        * **per-row service** — service(bucket(W)) / W: a higher
          watermark amortizes the fixed dispatch cost over more rows;
        * **accumulation wait** — W/2 rows' worth of marginal service
          time: the mean wait a request spends while the watermark
          fills (the cost a higher watermark ADDS);
        * **exposed overhead** — fixed / K: the dispatch overhead a
          deeper in-flight window overlaps away.

        Monotone trade-offs by construction, so the search's optimum is
        a real interior point, not a domain corner.
        """
        buckets = tuple(sorted(set(int(b) for b in buckets)))
        w = max(1, min(int(watermark), buckets[-1]))
        k = max(1, int(in_flight))
        bucket = next((b for b in buckets if w <= b), buckets[-1])
        per_row_service = self.service(bucket) / w
        accumulation_wait = 0.5 * w * self.service.marginal
        exposed_overhead = self.service.fixed / k
        return per_row_service + accumulation_wait + exposed_overhead

    # --------------------------------------------------------- training
    def predict_step_ms(self, max_in_flight, metric_sync,
                        device_prefetch=False, steps_per_epoch=1000):
        """Predicted per-step wall cost of a fit-pipeline config:

        * **dispatch** — the irreducible host cost of issuing the step;
        * **metric sync, amortized** — one device->host snapshot every
          ``metric_sync`` batches (0 = epoch-end only: amortized over
          ``steps_per_epoch``);
        * **pacing** — the host block on the oldest in-flight step;
          the exposed fraction shrinks with window depth (a deeper
          window absorbs dispatch jitter: exec - dispatch, exposed
          1/K of the time);
        * **input stall** — host batch assembly, hidden entirely by
          device prefetch.
        """
        b = self.fit_basis
        k = max(1, int(max_in_flight))
        cadence = int(metric_sync) if metric_sync else 0
        sync_every = cadence if cadence >= 1 else max(1, steps_per_epoch)
        sync_amortized = b["metric_sync_ms"] / sync_every
        pacing = max(0.0, b["step_exec_ms"] - b["dispatch_ms"]) / k
        input_stall = 0.0 if device_prefetch else b["assemble_ms"]
        return b["dispatch_ms"] + sync_amortized + pacing + input_stall

    # --------------------------------------------------------- predicted sync points
    def predict_sync_points(self, max_in_flight, metric_sync,
                            steps=100):
        """How many host<->device sync points a ``steps``-step fit pays
        under this config: pacing waits
        (``steps - K`` once the window fills) plus cadence metric syncs
        (every ``metric_sync`` batches; one epoch-end sync always)."""
        k = max(1, int(max_in_flight))
        cadence = int(metric_sync) if metric_sync else 0
        pacing_waits = max(0, steps - k)
        metric_syncs = (steps // cadence) if cadence >= 1 else 0
        return pacing_waits + metric_syncs + 1   # +1: epoch-end sync

    def to_dict(self):
        return {"service_line": self.service.to_dict(),
                "fit_basis": {k: round(float(v), 6)
                              for k, v in self.fit_basis.items()},
                "bucket_costs": {str(b): c for b, c in
                                 sorted(self.bucket_costs.items())},
                "program_rows_used": [r.get("kind")
                                      for r in self.program_rows]}
