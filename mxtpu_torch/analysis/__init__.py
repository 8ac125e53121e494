"""mxtpu_torch.analysis — graph verification, dataflow analyses,
transform passes, the runtime numerics sanitizer and the runtime
concurrency witness.

Counterpart of ``mxtpu/analysis/__init__.py``, with the same parts:

* **graph passes** (:mod:`~mxtpu_torch.analysis.passes`): the registry
  of :class:`GraphPass` verifiers driven by :func:`analyze`, returning
  structured :class:`Finding`\\ s. Surfaced as ``Symbol.lint()``,
  ``Module.check()`` and ``python -m mxtpu_torch.analysis model.json``.
* **dataflow analyses** (:mod:`~mxtpu_torch.analysis.dataflow`):
  :func:`precision_flow`, :func:`liveness`, :func:`conv_layout`,
  :func:`remat_reuse_plan`, :func:`update_fusion_plan` and the int8
  ``quant_plan``.
* **transform passes** (:mod:`~mxtpu_torch.analysis.rewrite`): the
  ``layout``, ``bf16``, ``quant``, ``fuse_opt`` and ``remat_reuse``
  rewrites the compile pipeline runs.
* **translation validation** (:mod:`~mxtpu_torch.analysis.equiv` and
  :mod:`~mxtpu_torch.analysis.graphgen`): every accepted rewrite is
  certified equivalent modulo its pass's declared algebra
  (``MXTPU_PIPELINE_CERT``, armed by default), and a seeded random-graph
  fuzzer tests the catalog over generated DAGs.
* **numerics sanitizer** (:mod:`~mxtpu_torch.analysis.sanitizer`):
  ``MXTPU_SANITIZE=nan|inf|all`` checks every built program's outputs.
* **concurrency witness** (:mod:`~mxtpu_torch.analysis.concurrency`
  over :mod:`~mxtpu_torch.analysis.declarations`).

``findings``, ``declarations`` and ``concurrency`` are stdlib-only and
load eagerly, so the lowest layers (telemetry, engine, faults) create
tracked locks at their own import time; the graph web loads lazily on
first attribute access (PEP 562), as mxtpu's does (:85-133).
"""
from __future__ import annotations

from .findings import ERROR, INFO, WARNING, SEVERITIES, Finding, Report
from . import declarations
from . import concurrency

__all__ = [
    "Finding", "Report", "ERROR", "WARNING", "INFO", "SEVERITIES",
    "GraphPass", "PassContext", "register_pass", "get_pass", "list_passes",
    "analyze", "analyze_json", "check_module",
    "NumericsError", "sanitizer_enable", "sanitizer_disable",
    "sanitizer_mode", "sanitize_tree", "provenance",
    "dataflow", "precision_flow", "liveness", "conv_layout",
    "remat_reuse_plan", "update_fusion_plan",
    "rewrite", "TransformPass", "register_transform", "get_transform",
    "list_transforms", "declarations", "concurrency",
    "equiv", "Certificate", "certify", "entry_key",
    "graphgen", "random_graph", "fuzz_round",
]

#: lazily-imported submodules (PEP 562): resolving any of them (or a
#: symbol below) imports the heavy graph/symbol web on first use only
_LAZY_MODULES = ("passes", "sanitizer", "provenance", "dataflow",
                 "rewrite", "equiv", "graphgen")

#: public name -> (submodule, attribute)
_LAZY_ATTRS = {
    "GraphPass": ("passes", "GraphPass"),
    "PassContext": ("passes", "PassContext"),
    "register_pass": ("passes", "register_pass"),
    "get_pass": ("passes", "get_pass"),
    "list_passes": ("passes", "list_passes"),
    "analyze": ("passes", "analyze"),
    "analyze_json": ("passes", "analyze_json"),
    "check_module": ("passes", "check_module"),
    "NumericsError": ("sanitizer", "NumericsError"),
    "sanitizer_enable": ("sanitizer", "enable"),
    "sanitizer_disable": ("sanitizer", "disable"),
    "sanitizer_mode": ("sanitizer", "mode"),
    "sanitize_tree": ("sanitizer", "sanitize_tree"),
    "precision_flow": ("dataflow", "precision_flow"),
    "liveness": ("dataflow", "liveness"),
    "conv_layout": ("dataflow", "conv_layout"),
    "remat_reuse_plan": ("dataflow", "remat_reuse_plan"),
    "update_fusion_plan": ("dataflow", "update_fusion_plan"),
    "TransformPass": ("rewrite", "TransformPass"),
    "register_transform": ("rewrite", "register_transform"),
    "get_transform": ("rewrite", "get_transform"),
    "list_transforms": ("rewrite", "list_transforms"),
    "Certificate": ("equiv", "Certificate"),
    "certify": ("equiv", "certify"),
    "entry_key": ("equiv", "entry_key"),
    "random_graph": ("graphgen", "random_graph"),
    "fuzz_round": ("graphgen", "fuzz_round"),
}


def __getattr__(name):
    import importlib
    if name in _LAZY_MODULES:
        mod = importlib.import_module("." + name, __name__)
        globals()[name] = mod
        return mod
    target = _LAZY_ATTRS.get(name)
    if target is not None:
        mod = importlib.import_module("." + target[0], __name__)
        val = getattr(mod, target[1])
        globals()[name] = val
        return val
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))


def __dir__():
    return sorted(set(__all__) | set(globals()) | set(_LAZY_MODULES))
