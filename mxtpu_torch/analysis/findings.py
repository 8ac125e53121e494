"""Finding / Report: the structured result type of every analysis pass.

A Finding is deliberately richer than an exception message: it names the
pass that produced it, the node it anchors to, the *provenance* (the
arg→node path that explains WHY the node is implicated — the thing
today's bare "insufficient information at node '%s'" error lacks), and a
concrete fix hint. Severity is a small closed enum so CI can gate on
``errors`` while leaving ``info`` advisory.
"""
from __future__ import annotations

__all__ = ["ERROR", "WARNING", "INFO", "SEVERITIES", "Finding", "Report"]

#: severity levels, most severe first (sort order relies on this)
ERROR = "error"
WARNING = "warning"
INFO = "info"
SEVERITIES = (ERROR, WARNING, INFO)
_RANK = {s: i for i, s in enumerate(SEVERITIES)}


class Finding:
    """One diagnostic produced by a :class:`~mxtpu.analysis.GraphPass`.

    Attributes
    ----------
    pass_name : the registered pass that produced it
    severity : ``error`` / ``warning`` / ``info``
    node : name of the graph node (or binding name) it anchors to, or None
    message : one-line statement of the defect
    provenance : tuple of node names, upstream→downstream, explaining how
        the defect reaches ``node`` (empty when self-evident)
    fix_hint : a concrete suggestion, or None
    details : JSON-ready extras (e.g. the partially-inferred shape dict)
    """

    __slots__ = ("pass_name", "severity", "node", "message", "provenance",
                 "fix_hint", "details")

    def __init__(self, pass_name, severity, message, node=None,
                 provenance=(), fix_hint=None, details=None):
        if severity not in _RANK:
            raise ValueError("severity must be one of %s" % (SEVERITIES,))
        self.pass_name = pass_name
        self.severity = severity
        self.node = node
        self.message = message
        self.provenance = tuple(provenance or ())
        self.fix_hint = fix_hint
        self.details = details or {}

    def to_dict(self):
        out = {"pass": self.pass_name, "severity": self.severity,
               "message": self.message}
        if self.node is not None:
            out["node"] = self.node
        if self.provenance:
            out["provenance"] = list(self.provenance)
        if self.fix_hint:
            out["fix_hint"] = self.fix_hint
        if self.details:
            out["details"] = self.details
        return out

    def __repr__(self):
        return "<Finding %s/%s %s: %s>" % (self.pass_name, self.severity,
                                           self.node or "-", self.message)

    def render(self):
        loc = (" [%s]" % self.node) if self.node else ""
        lines = ["%-7s %s%s: %s" % (self.severity.upper(), self.pass_name,
                                    loc, self.message)]
        if self.provenance:
            lines.append("        via %s" % " -> ".join(self.provenance))
        if self.fix_hint:
            lines.append("        hint: %s" % self.fix_hint)
        return "\n".join(lines)


class Report:
    """Ordered collection of Findings from one ``analyze()`` run."""

    def __init__(self, findings=(), passes_run=()):
        self.findings = sorted(findings,
                               key=lambda f: (_RANK[f.severity], f.pass_name))
        self.passes_run = tuple(passes_run)

    def __iter__(self):
        return iter(self.findings)

    def __len__(self):
        return len(self.findings)

    def __bool__(self):
        # truthiness == "has findings", so `if sym.lint():` reads naturally
        return bool(self.findings)

    @property
    def errors(self):
        return [f for f in self.findings if f.severity == ERROR]

    @property
    def warnings(self):
        return [f for f in self.findings if f.severity == WARNING]

    @property
    def ok(self):
        """True when nothing at error or warning severity fired."""
        return not self.errors and not self.warnings

    def by_pass(self, name):
        return [f for f in self.findings if f.pass_name == name]

    def to_dict(self):
        return {"passes_run": list(self.passes_run),
                "counts": {s: sum(1 for f in self.findings
                                  if f.severity == s) for s in SEVERITIES},
                "findings": [f.to_dict() for f in self.findings]}

    def render(self):
        if not self.findings:
            return "analysis: clean (%d passes)" % len(self.passes_run)
        lines = ["analysis: %d finding(s) from %d passes"
                 % (len(self.findings), len(self.passes_run))]
        lines += [f.render() for f in self.findings]
        return "\n".join(lines)

    __str__ = render
