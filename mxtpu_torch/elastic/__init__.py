"""mxtpu_torch.elastic — async checkpointing, exact fit-resume,
preemption recovery (counterpart of ``mxtpu/elastic``).

A long ``Module.fit`` on rented cards gets preempted; without this
package a killed process loses everything since its last synchronous
checkpoint, and the hang watchdog can only *describe* a wedge. Three
layers (docs/elastic.md):

* :mod:`~mxtpu_torch.elastic.snapshot` — **async snapshots**: the fused
  step's state cloned on the card and copied to pinned host memory on a
  copy stream off the critical path, serialized/fsynced/atomically
  renamed on a writer thread while steps keep running; under a plan the
  optimizer state kept by rows is written as each replica's row block
  with the plan's spec in the manifest;
* :mod:`~mxtpu_torch.elastic.state` — **exact resume**:
  ``Module.fit(resume=...)`` restores step/epoch cursors, every RNG
  stream, optimizer state (f32 masters under ``MXTPU_PIPELINE=bf16``),
  metric accumulators and the data-iterator position — a fit killed at
  step N and resumed is bit-exact on weights against an uninterrupted
  run;
* :mod:`~mxtpu_torch.elastic.supervisor` — **supervision**: a watchdog
  wedge (or a health divergence under ``MXTPU_HEALTH_ACTION=rollback``)
  triggers checkpoint-restore-retry with bounded backoff
  (``MXTPU_ELASTIC_RETRIES``), and SIGTERM is a preemption warning that
  flushes a final snapshot before :class:`Preempted` propagates.
"""
from __future__ import annotations

from .snapshot import (SnapshotJob, SnapshotWriter, async_save_ndarrays,
                       capture_module, latest_manifest, list_generations,
                       load_arrays, prune, safe_arrays, writer)
from .state import (ElasticConfig, ElasticSession, ResumeState,
                    apply_resume, async_save_opt_states_pickle,
                    load_resume, load_sharded_opt_states,
                    save_sharded_opt_states)
from .supervisor import Preempted, Supervisor, WedgeAbort

__all__ = [
    "SnapshotWriter", "SnapshotJob", "writer", "capture_module",
    "latest_manifest", "list_generations", "load_arrays", "prune",
    "safe_arrays", "async_save_ndarrays",
    "ElasticConfig", "ElasticSession", "ResumeState", "load_resume",
    "apply_resume", "save_sharded_opt_states", "load_sharded_opt_states",
    "async_save_opt_states_pickle",
    "Supervisor", "Preempted", "WedgeAbort",
]
