"""mxtpu_torch.analysis — the structured findings and the runtime
concurrency witness.

Counterpart of ``mxtpu/analysis/__init__.py``'s light half:

* **findings** (:mod:`~mxtpu_torch.analysis.findings`): the
  :class:`Finding` / :class:`Report` result type (severity, node,
  provenance, fix hint) every check returns;
* **declarations** (:mod:`~mxtpu_torch.analysis.declarations`): the
  declared lock hierarchy, the blocking-call catalog and their
  allowlists, keyed by the port's own lock owners;
* **concurrency witness** (:mod:`~mxtpu_torch.analysis.concurrency`):
  the tracked-lock factory, the runtime lock-order witness checking the
  declared hierarchy, blocking-under-lock detection and the seeded
  schedule fuzzer over the fault points. One global ``None`` check per
  acquisition when disarmed.

All three are stdlib-only and load eagerly, so the lowest layers
(telemetry, engine, faults) create tracked locks at their own import
time. mxtpu's graph-pass web (``passes``, ``dataflow``, ``rewrite``,
``equiv``, ``graphgen``, ``sanitizer``, ``provenance``) belongs to the
compile pipeline, which the port does not have yet: asking for any of
its names raises ``AttributeError`` naming the slice it waits for.
"""
from __future__ import annotations

from .findings import ERROR, INFO, WARNING, SEVERITIES, Finding, Report
from . import declarations
from . import concurrency

__all__ = [
    "Finding", "Report", "ERROR", "WARNING", "INFO", "SEVERITIES",
    "declarations", "concurrency",
]

#: mxtpu's lazily-imported pass web (mxtpu/analysis/__init__.py:63-113):
#: submodules and public names that arrive with the compile pipeline
_PASS_WEB = frozenset((
    "passes", "sanitizer", "provenance", "dataflow", "rewrite", "equiv",
    "graphgen", "GraphPass", "PassContext", "register_pass", "get_pass",
    "list_passes", "analyze", "analyze_json", "check_module",
    "NumericsError", "sanitizer_enable", "sanitizer_disable",
    "sanitizer_mode", "sanitize_tree", "precision_flow", "liveness",
    "conv_layout", "remat_reuse_plan", "update_fusion_plan",
    "TransformPass", "register_transform", "get_transform",
    "list_transforms", "Certificate", "certify", "entry_key",
    "random_graph", "fuzz_round"))


def __getattr__(name):
    if name in _PASS_WEB:
        raise AttributeError(
            "mxtpu_torch.analysis.%s is mxtpu's graph-pass web, which the "
            "port gains with the compile pipeline (ROADMAP A.9)" % name)
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))
