"""``TunedConfig``: the versioned artifact one search emits, every
subsystem consumes.

A ``TunedConfig`` is a JSON file with five blocks:

* ``values``     — ``{knob-name: value}`` over the registry catalog;
* ``registry_version`` — the knob-registry fingerprint the search ran
  against; a mismatch at load means the knob semantics moved and the
  artifact is STALE — strict loads reject it, the ambient ``MXTPU_TUNED``
  path logs and ignores it (a stale file on disk must not wedge every
  import);
* ``basis``      — the cost-model inputs the search ranked with (the
  AOT cost-registry rows, per-bucket ``exec_ms``, fixture name): the
  evidence a reviewer replays the prediction from;
* ``evidence``   — per measured candidate, the predicted cost and the
  probe measurements that decided the winner;
* ``provenance`` — an append-only event log: the offline search that
  created the artifact, then every online-controller adjustment
  (knob, from, to, reason, telemetry basis).

Precedence when a subsystem resolves a knob: default < artifact < env
< explicit argument (:func:`mxtpu.tune.registry.resolve`). The
process-active artifact is set with :func:`use` (or the ``MXTPU_TUNED``
env path); ``Module.fit(tuned=)`` / ``ServingSession(tuned=)`` /
``ElasticConfig(tuned=)`` take a per-call artifact instead.
"""
from __future__ import annotations

import json
import logging
import os
import threading

from ..analysis import concurrency as _conc
from . import registry as _registry

__all__ = ["TunedConfig", "use", "active", "artifact", "SCHEMA"]

log = logging.getLogger("mxtpu_torch.tune")

#: artifact schema revision (bumped only on incompatible JSON layout
#: changes; knob-set changes are carried by ``registry_version``)
SCHEMA = 1

_UNSET = object()


def _error(msg):
    from ..base import MXNetError   # lazy: keep this module import-light
    return MXNetError(msg)


class TunedConfig:
    """One searched configuration + the evidence that picked it."""

    def __init__(self, values=None, basis=None, evidence=None,
                 provenance=None, registry_version=None, created=None,
                 validate=True):
        self.values = dict(values or {})
        self.basis = dict(basis or {})
        self.evidence = list(evidence or [])
        self.provenance = list(provenance or [])
        self.registry_version = registry_version \
            if registry_version is not None else _registry.registry_version()
        self.created = created
        self.path = None    # set by load()/save() for provenance flushes
        if validate:
            self._validate()

    # ------------------------------------------------------------ checks
    def _validate(self):
        """Coerce every value through its knob declaration — an artifact
        naming an unknown knob, or a value outside a choice domain, is
        rejected whole (half-applied configs are worse than none)."""
        for name in sorted(self.values):
            try:
                knob = _registry.get_knob(name)
            except KeyError:
                raise _error(
                    "TunedConfig: unknown knob %r — the artifact was "
                    "searched against a different knob registry "
                    "(artifact %s, live %s)"
                    % (name, self.registry_version,
                       _registry.registry_version()))
            try:
                self.values[name] = knob.coerce(self.values[name])
            except (TypeError, ValueError) as exc:
                raise _error("TunedConfig: bad value for %r: %s"
                             % (name, exc))

    @property
    def stale(self):
        """True when the live knob registry no longer matches the one
        this artifact was searched against."""
        return self.registry_version != _registry.registry_version()

    # ------------------------------------------------------------ access
    def get(self, name, default=None):
        return self.values.get(name, default)

    def set(self, name, value):
        """Set a knob value (coerced); used by the search emitter and
        the online controller (which also logs to provenance)."""
        self.values[name] = _registry.get_knob(name).coerce(value)

    def record(self, event, **fields):
        """Append a provenance event (offline search, online adjust)."""
        entry = {"event": str(event)}
        entry.update(fields)
        self.provenance.append(entry)
        return entry

    # -------------------------------------------------------------- io
    def to_dict(self):
        return {"schema": SCHEMA,
                "registry_version": self.registry_version,
                "created": self.created,
                "values": dict(self.values),
                "basis": self.basis,
                "evidence": self.evidence,
                "provenance": self.provenance}

    def save(self, path):
        """Write the artifact atomically (tmp + rename: a reader racing
        the write must see the old file or the new one, never a torn
        JSON)."""
        tmp = "%s.tmp.%d" % (path, os.getpid())
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        self.path = path
        return path

    @classmethod
    def load(cls, path, strict=True):
        """Load + verify an artifact. ``strict`` (the default for
        explicit ``tuned=`` arguments) raises on a registry-version
        mismatch; ``strict=False`` (the ambient env path) returns None
        for a stale or unreadable artifact after logging why."""
        try:
            with open(path) as f:
                raw = json.load(f)
        except (OSError, ValueError) as exc:
            if strict:
                raise _error("TunedConfig: cannot read %r: %s"
                             % (path, exc))
            log.warning("tune: ignoring unreadable artifact %r: %s",
                        path, exc)
            return None
        if int(raw.get("schema", 0)) != SCHEMA:
            msg = ("TunedConfig %r: schema %s != supported %d"
                   % (path, raw.get("schema"), SCHEMA))
            if strict:
                raise _error(msg)
            log.warning("tune: ignoring artifact: %s", msg)
            return None
        rv = raw.get("registry_version")
        if rv != _registry.registry_version():
            msg = ("TunedConfig %r is STALE: searched against knob "
                   "registry %s, live registry is %s — re-run "
                   "`python -m mxtpu.tune search`"
                   % (path, rv, _registry.registry_version()))
            if strict:
                raise _error(msg)
            log.warning("tune: ignoring artifact: %s", msg)
            return None
        try:
            cfg = cls(values=raw.get("values"), basis=raw.get("basis"),
                      evidence=raw.get("evidence"),
                      provenance=raw.get("provenance"),
                      registry_version=rv, created=raw.get("created"))
        except Exception as exc:
            if strict:
                raise
            log.warning("tune: ignoring invalid artifact %r: %s",
                        path, exc)
            return None
        cfg.path = path
        return cfg

    def __repr__(self):
        return "TunedConfig(%d knobs, registry=%s%s)" % (
            len(self.values), self.registry_version,
            ", stale" if self.stale else "")


# ----------------------------------------------------------- active artifact
_ACTIVE = [None]        # the process-active artifact (or None)
_ENV_CHECKED = [False]  # MXTPU_TUNED consulted at most once
_LOCK = _conc.lock("config", "_LOCK")


def _warn_unread(cfg, where):
    """Name every value of ``cfg`` for a knob the port does not read:
    the artifact is accepted (it may be mxtpu's) and that value has no
    effect here."""
    for name in sorted(cfg.values):
        later = _registry.unread_by(name)
        if later is not None:
            log.warning("%s: the port does not read knob %s yet (its "
                        "reader comes with %s): its value %r has no "
                        "effect", where, name, later, cfg.values[name])
    return cfg


def _refresh_import_time_consumers():
    """Knobs resolved at module-import time (the compile pipeline's
    config snapshot) must re-resolve when the active artifact changes
    after import (mxtpu/tune/config.py:194-206). Only an already
    imported consumer needs the poke."""
    import sys
    pipeline = sys.modules.get("mxtpu_torch.compile.pipeline")
    if pipeline is not None:
        try:
            pipeline.refresh_from_knobs()
        except Exception:   # a refresh failure must not fail use()
            log.warning("tune: compile-pipeline refresh failed",
                        exc_info=True)


def use(spec):
    """Set the process-active artifact: a :class:`TunedConfig`, a path,
    or None to clear. Returns the active config. Subsystems constructed
    afterwards resolve their knobs through it (env and explicit
    arguments still win); import-time consumers (the compile pipeline's
    ``compile.pipeline`` snapshot) are re-resolved immediately."""
    with _LOCK:
        if spec is None:
            _ACTIVE[0] = None
            _ENV_CHECKED[0] = True   # an explicit clear also drops the env
        else:
            cfg = spec if isinstance(spec, TunedConfig) \
                else TunedConfig.load(spec, strict=True)
            _ACTIVE[0] = _warn_unread(cfg, "tune.use")
            _ENV_CHECKED[0] = True
    _refresh_import_time_consumers()
    return _ACTIVE[0]


def active():
    """The process-active artifact, lazily loading ``MXTPU_TUNED`` on
    first consult (non-strict: a stale/broken ambient file logs and is
    ignored — the import path must not raise on a leftover artifact)."""
    if not _ENV_CHECKED[0]:
        with _LOCK:
            if not _ENV_CHECKED[0]:
                _ENV_CHECKED[0] = True
                path = os.environ.get("MXTPU_TUNED", "").strip()
                if path:
                    _ACTIVE[0] = TunedConfig.load(path, strict=False)
                    if _ACTIVE[0] is not None:
                        _warn_unread(_ACTIVE[0], "MXTPU_TUNED")
    return _ACTIVE[0]


def _reset_for_tests():
    """Drop the active artifact AND re-arm the env probe (tests flip
    ``MXTPU_TUNED`` between cases)."""
    with _LOCK:
        _ACTIVE[0] = None
        _ENV_CHECKED[0] = False


def artifact(spec):
    """Normalize a per-call ``tuned=`` argument for ``resolve()``:

    * ``None``  → consult the process-active artifact (sentinel pass-
      through);
    * ``False`` → ignore any active artifact;
    * a path    → strict load (stale artifacts raise here — an explicit
      request for a stale config is an error, not a fallback);
    * a :class:`TunedConfig` → itself.
    """
    if spec is None or spec is False:
        return spec
    if isinstance(spec, TunedConfig):
        return _warn_unread(spec, "tuned=")
    if isinstance(spec, (str, os.PathLike)):
        return _warn_unread(TunedConfig.load(spec, strict=True), "tuned=")
    raise _error("tuned=: expected a TunedConfig, a path, None or "
                 "False, got %r" % (spec,))
