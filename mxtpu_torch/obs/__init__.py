"""mxtpu_torch.obs — the exported observability surface.

Counterpart of ``mxtpu/obs``: the export layer over telemetry and
diagnostics.

  * :mod:`~mxtpu_torch.obs.trace` + :mod:`~mxtpu_torch.obs.trace_export`
    — a bounded lock-free ring of finished spans (armed as
    ``tracing.set_span_sink``) and a Chrome trace-event exporter merging
    it with the diagnostics flight ring onto named per-thread tracks
    with flow events. Served at ``GET /debug/trace``.
  * :mod:`~mxtpu_torch.obs.sampler` — the seeded deterministic
    per-request exemplar sampler (``MXTPU_TRACE_SAMPLE``).
  * :mod:`~mxtpu_torch.obs.corpus` — the append-only JSONL measurement
    corpus (``MXTPU_CORPUS_DIR``) in mxtpu's schema 2.
  * :mod:`~mxtpu_torch.obs.health` + :mod:`~mxtpu_torch.obs.detectors`
    — device-resident per-class training-health statistics over the
    fused train step, riding the metric-sync cadence, with the
    deterministic anomaly-detector suite (``MXTPU_HEALTH`` /
    ``fit(health=True)``).
"""
from __future__ import annotations

from . import corpus, sampler, trace, trace_export
from .sampler import TraceSampler
from .trace import SpanRing, install, ring, set_trace_enabled, trace_enabled

__all__ = [
    "trace", "trace_export", "sampler", "corpus", "health", "detectors",
    "SpanRing", "ring", "install", "set_trace_enabled", "trace_enabled",
    "TraceSampler",
]


def __getattr__(name):
    # health/detectors resolve lazily: diagnostics imports obs.trace at
    # import time, and obs.health imports diagnostics
    if name in ("health", "detectors"):
        import importlib
        mod = importlib.import_module("." + name, __name__)
        globals()[name] = mod
        return mod
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))
