"""Exposition: render registries as Prometheus text or JSON.

Prometheus text format 0.0.4: ``# TYPE`` headers, labeled samples,
histograms as cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count``.
Series names are ``<registry.namespace>_<series>`` sanitized to the
Prometheus grammar. ``prometheus_text``/``json_snapshot`` accept several
registries so one scrape merges the process-wide registry with a serving
session's — the single pane the ROADMAP's production north star needs.
"""
from __future__ import annotations

import json
import re

from .metrics import Counter, Gauge, Histogram

__all__ = ["prometheus_text", "json_snapshot", "dump"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_RE = re.compile(r"[^a-zA-Z0-9_]")

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _name(registry, series_name):
    base = "%s_%s" % (registry.namespace, series_name) \
        if registry.namespace else series_name
    return _NAME_RE.sub("_", base)


def _esc(v):
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _labels(labels, extra=None):
    items = dict(labels or {})
    if extra:
        items.update(extra)
    if not items:
        return ""
    inner = ",".join('%s="%s"' % (_LABEL_RE.sub("_", k), _esc(v))
                     for k, v in sorted(items.items()))
    return "{%s}" % inner


def _fmt(v):
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def prometheus_text(*registries):
    """Render registries as one Prometheus text exposition."""
    lines = []
    typed = set()  # emit each # TYPE once even across label series

    def _type_line(name, kind, help=None):
        if name in typed:
            return
        typed.add(name)
        if help:
            lines.append("# HELP %s %s" % (name, _esc(help)))
        lines.append("# TYPE %s %s" % (name, kind))

    for reg in registries:
        if reg is None:
            continue
        for m in reg.series():
            name = _name(reg, m.name)
            if isinstance(m, Counter):
                _type_line(name, "counter", m.help)
                lines.append("%s%s %s" % (name, _labels(m.labels),
                                          _fmt(m.value)))
            elif isinstance(m, Gauge):
                _type_line(name, "gauge", m.help)
                lines.append("%s%s %s" % (name, _labels(m.labels),
                                          _fmt(float(m.value))))
            elif isinstance(m, Histogram):
                _type_line(name, "histogram", m.help)
                count, total, _mn, _mx, cum = m.snapshot()
                for bound, c in zip(m.bounds, cum):
                    lines.append("%s_bucket%s %d" % (
                        name, _labels(m.labels, {"le": _fmt(float(bound))}),
                        c))
                lines.append("%s_sum%s %s" % (name, _labels(m.labels),
                                              _fmt(total)))
                lines.append("%s_count%s %d" % (name, _labels(m.labels),
                                                count))
        for sname, labels, value in reg.extra_series():
            name = _name(reg, sname)
            _type_line(name, "gauge")
            lines.append("%s%s %s" % (name, _labels(labels),
                                      _fmt(float(value))))
    return "\n".join(lines) + "\n"


def json_snapshot(*registries):
    """Merged JSON snapshot: {namespace: registry.to_dict()}."""
    out = {}
    for reg in registries:
        if reg is None:
            continue
        key = reg.namespace or "metrics"
        if key in out:  # two registries sharing a namespace: merge
            out[key].update(reg.to_dict())
        else:
            out[key] = reg.to_dict()
    return out


def dump(path, *registries, fmt="prometheus"):
    """Write an exposition to ``path`` (standalone dump — no HTTP server
    needed, e.g. at the end of a training job). Returns the path."""
    if fmt == "prometheus":
        payload = prometheus_text(*registries)
    elif fmt == "json":
        payload = json.dumps(json_snapshot(*registries), indent=2,
                             default=str)
    else:
        raise ValueError("dump: fmt must be 'prometheus' or 'json'")
    with open(path, "w") as f:
        f.write(payload)
    return path
