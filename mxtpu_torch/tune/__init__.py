"""mxtpu_torch.tune — cost-registry-driven autotuning.

Counterpart of ``mxtpu/tune``:

* :mod:`~mxtpu_torch.tune.registry` — the **knob registry**: every
  tunable declared once (name, kind, hand-picked default, env override,
  search candidates, online safe range), mxtpu's declarations verbatim,
  so ``registry_version()`` is mxtpu's and an artifact searched for one
  package loads in the other. ``fit`` pulls its pipeline knobs through
  :func:`resolve`; with no artifact the registry is behavior-neutral.
* :mod:`~mxtpu_torch.tune.config` — the **TunedConfig artifact**: a
  versioned JSON of searched values + basis + evidence + provenance,
  consumed with precedence ``default < artifact < env < explicit
  argument`` by ``Module.fit(tuned=)``; stale artifacts (knob-registry
  mismatch) are rejected.
* :mod:`~mxtpu_torch.tune.cost` — the **cost model** over the program
  table's rows and serving's per-bucket ms: predicts step/request cost
  per candidate without running it.
* :mod:`~mxtpu_torch.tune.searcher` — the **offline search**
  (``python -m mxtpu_torch.tune search``): model-ranked candidates, the
  top-K measured with short probes on the card.
* :mod:`~mxtpu_torch.tune.online` — **online refinement**: a cadence
  controller nudging the bounded knobs (fit's in-flight window, a
  serving session's in-flight depth, refill watermark and admission
  budget) inside their certified ranges, every move in
  ``tune_adjustments{knob}``.

mxtpu's ``sweep`` re-runs ``bench.py`` with ``XLA_FLAGS`` combinations;
the port has no benchmark of its own yet, so its names raise
``AttributeError`` until the port's benchmark PR.
"""
from __future__ import annotations

from .registry import (Knob, catalog_rows, catalog_table, declare,
                       get_knob, knobs, registry_version, resolve,
                       resolve_int)
from .config import SCHEMA, TunedConfig, active, artifact, use

__all__ = [
    "Knob", "declare", "get_knob", "knobs", "registry_version",
    "resolve", "resolve_int", "catalog_rows", "catalog_table",
    "TunedConfig", "use", "active", "artifact", "SCHEMA",
    "CostModel", "search", "search_from_rows", "OnlineController",
]


_SWEEP = ("sweep", "XLA_FLAG_COMBOS", "probe_bench", "run_flag_sweep")


def __getattr__(name):
    # the heavy halves (probes import serving/models) load on demand
    if name in ("search", "search_from_rows", "probe_fit",
                "probe_serving", "candidate_space", "enumerate_candidates",
                "rank_candidates", "default_candidates"):
        from . import searcher as _searcher
        return getattr(_searcher, name)
    if name == "CostModel":
        from .cost import CostModel
        return CostModel
    if name == "OnlineController":
        from .online import OnlineController
        return OnlineController
    if name in ("online", "cost", "searcher"):
        import importlib
        return importlib.import_module("." + name, __name__)
    if name in _SWEEP:
        raise AttributeError(
            "mxtpu_torch.tune.%s is mxtpu's sweep, which re-runs "
            "bench.py under XLA_FLAGS combinations: the port gains it "
            "with its own benchmark" % name)
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))
