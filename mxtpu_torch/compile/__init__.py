"""mxtpu_torch.compile — the program-build pipeline.

Counterpart of ``mxtpu/compile``. Every program in the process — the
executor's inference and training plans, the fused train step, metric
accumulators, serving binds — is built through ONE seam
(:mod:`~mxtpu_torch.compile.pipeline`), which owns, in order:

1. **graph transforms**: an ordered list of analysis-licensed
   :class:`~mxtpu_torch.analysis.rewrite.TransformPass` rewrites
   (``MXTPU_PIPELINE`` / :func:`configure`), each re-proven by the full
   verifier suite and certified before it may build — a rejected
   rewrite falls back to the unrewritten graph with the offending
   Finding;
2. **build notification**: the listener/counter seam the serving layer
   and telemetry watch (``executor_program_builds{kind=}``);
3. **instrumentation**: the first call's time and cost into the program
   table, the numerics sanitizer's and the int8 calibration observer's
   output hooks.

:mod:`~mxtpu_torch.compile.quant` is int8 post-training quantization's
calibration capture and scale math.
"""
from __future__ import annotations

from .pipeline import (PipelineReport, add_build_listener, configure,
                       configured, instrument_program, notify_build,
                       pipeline_scope, program_build_count,
                       record_program_build, remove_build_listener,
                       set_calib_observer, set_output_sanitizer,
                       transform_graph)
from . import quant

__all__ = [
    "PipelineReport", "transform_graph", "configure", "configured",
    "pipeline_scope",
    "add_build_listener", "remove_build_listener", "notify_build",
    "program_build_count", "record_program_build", "instrument_program",
    "set_output_sanitizer", "set_calib_observer", "quant",
]
