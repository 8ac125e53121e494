"""mxtpu_torch.tune — the knob registry and the TunedConfig artifact.

Counterpart of ``mxtpu/tune``'s registry half:

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

mxtpu's search, cost model, online controller and sweep
(``searcher``, ``cost``, ``online``, ``sweep``) read the program cost
table and the device-memory ledger of ``diagnostics``, which the port
gains with the observability slice (ROADMAP A.10); their names raise
``AttributeError`` until then.
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
]


_SEARCH_HALF = ("search", "search_from_rows", "probe_fit", "probe_serving",
                "candidate_space", "enumerate_candidates", "CostModel",
                "OnlineController", "online", "cost", "sweep", "searcher")


def __getattr__(name):
    if name in _SEARCH_HALF:
        raise AttributeError(
            "mxtpu_torch.tune.%s is mxtpu's search half, which needs "
            "diagnostics.programs() and ledger(): the port gains it with "
            "the observability slice (ROADMAP A.10)" % name)
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))
