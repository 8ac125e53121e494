"""mxtpu_torch.sharding — the mesh and the sharding plan.

Counterpart of ``mxtpu/sharding``: the axis vocabulary and name
heuristics (``spec``), ``MeshContext`` and ``ShardingPlan`` with
cross-replica weight-update sharding (``plan``). Its consumers are
``Module.fit(mesh=...)`` and the fused step (``module/fused.py``:
reduce-scatter of the gradients, the update on each replica's rows, an
all-gather of the weights) and the KVStore veneer (``kvstore.py``).
"""
from __future__ import annotations

from .spec import PartitionSpec, SpecLayout, parameter_spec_from_name
from .plan import (DISABLED, MeshContext, ShardingPlan, activate, active,
                   active_mesh, current, deactivate, from_env, naive_spec,
                   plan_for_module, resolve, spec_from_json, spec_to_json,
                   use)

__all__ = [
    "SpecLayout", "parameter_spec_from_name",
    "MeshContext", "ShardingPlan", "naive_spec", "plan_for_module",
    "activate", "deactivate", "active", "active_mesh", "current", "use",
    "resolve", "from_env", "DISABLED", "spec_to_json", "spec_from_json",
]
