"""Runtime numerics sanitizer: device-side NaN/Inf output checks.

Counterpart of ``mxtpu/analysis/sanitizer.py``.
``MXTPU_SANITIZE=nan|inf|all`` makes the compile pipeline's build seam
check the outputs of every program it instruments (``fwd_eval`` /
``fwd_bwd`` / ``fused_step`` / ``metric_accum``): after each call one
reduction over every floating-point output tensor makes a per-tensor
flag on the device (``torch.isnan``/``torch.isinf``, bf16 and f16 upcast
to f32 first: the upcast is exact, so the flag classifies the value),
one host read pulls the flag vector, and a trip raises
:class:`NumericsError` after writing a structured postmortem
(``source="sanitizer"``) through the flight recorder
(:func:`mxtpu_torch.diagnostics.flight.postmortem`).

Unset, the cost is one module-global ``None`` check per program call;
set, every call pays the reduction and a blocking host read — a
debugging mode, priced accordingly.
"""
from __future__ import annotations

import os as _os

from .. import diagnostics as _diag
from .. import telemetry as _tel
from ..base import MXNetError, NumericsError

__all__ = ["NumericsError", "enable", "disable", "mode", "sanitize_tree",
           "trip_count"]

_VALID = ("nan", "inf", "all")

_MODE = None
_TRIPS = 0


def mode():
    """The active sanitize mode ('nan' / 'inf' / 'all') or None."""
    return _MODE


def trip_count():
    """Monotone process-wide trip counter."""
    return _TRIPS


def enable(which="all"):
    """Arm the sanitizer at runtime (the env var sets the initial state).
    Installs the build seam's output hook, so every program dispatched
    from now on — including ones built earlier — is checked."""
    global _MODE
    which = str(which).lower()
    if which not in _VALID:
        raise MXNetError("MXTPU_SANITIZE must be one of %s, got %r"
                         % ("|".join(_VALID), which))
    _MODE = which
    from ..compile import pipeline as _pipeline
    _pipeline.set_output_sanitizer(_check_outputs)
    return which


def disable():
    """Disarm: the hook is removed, dispatch is check-free."""
    global _MODE
    _MODE = None
    from ..compile import pipeline as _pipeline
    _pipeline.set_output_sanitizer(None)


def _leaves(out, path=""):
    """(path, tensor) of every tensor in a nest of lists, tuples and
    dicts, in order."""
    import torch
    if isinstance(out, torch.Tensor):
        yield path, out
    elif isinstance(out, (list, tuple)):
        for i, x in enumerate(out):
            yield from _leaves(x, "%s[%d]" % (path, i))
    elif isinstance(out, dict):
        for k, x in out.items():
            yield from _leaves(x, "%s[%r]" % (path, k))


def _flags(mode_, leaves):
    """One bool per leaf on the device: NaN and/or Inf anywhere in it."""
    import torch
    out = []
    for leaf in leaves:
        if leaf.dtype in (torch.bfloat16, torch.float16):
            leaf = leaf.to(torch.float32)
        bad = torch.zeros((), dtype=torch.bool, device=leaf.device)
        if mode_ in ("nan", "all"):
            bad = bad | torch.isnan(leaf).any()
        if mode_ in ("inf", "all"):
            bad = bad | torch.isinf(leaf).any()
        out.append(bad.to(leaves[0].device))
    return torch.stack(out)


def sanitize_tree(kind, out, precision=None):
    """Check every float tensor of ``out`` (any nest of lists, tuples
    and dicts) for NaN/Inf per the active mode; raise NumericsError
    naming the offending tensors. ``precision`` is the tripping
    program's build-time tag (``mixed_bf16``); omitted, a label is
    derived from the checked dtypes."""
    mode_ = _MODE
    if mode_ is None:
        return
    checked = [(p, t) for p, t in _leaves(out) if t.is_floating_point()]
    if not checked:
        return
    # allow-sync(the sanitizer IS a sync point by contract — one
    # blocking flag-vector read per checked program call)
    flags = _flags(mode_, [t.detach() for _, t in checked]).cpu().tolist()
    if not any(flags):
        return
    bad = [(name, t) for flag, (name, t) in zip(flags, checked) if flag]
    desc = ", ".join("%s %s%s" % (name or "<out>", _dtype_name(t),
                                  tuple(t.shape))
                     for name, t in bad[:6])
    if len(bad) > 6:
        desc += ", ... %d more" % (len(bad) - 6)
    what = {"nan": "NaN", "inf": "Inf", "all": "NaN/Inf"}[mode_]
    if not precision:
        lows = sum(1 for _, t in checked
                   if _dtype_name(t) in ("bfloat16", "float16"))
        precision = "f32" if not lows else \
            ("bf16" if lows == len(checked) else "mixed")
    reason = "sanitizer: %s in outputs of program kind '%s' " \
             "(precision=%s, %d/%d leaves): %s" \
             % (what, kind, precision, len(bad), len(checked), desc)
    global _TRIPS
    _TRIPS += 1
    # registry-direct: a numerics trip must count even with the helper-
    # mediated telemetry disabled
    _tel.registry().counter(
        "sanitizer_trips", labels={"kind": kind},
        help="program calls whose outputs tripped the numerics "
             "sanitizer").inc()
    _diag.record("sanitizer", kind, desc)
    _diag.postmortem(reason, source="sanitizer")
    err = NumericsError(reason)
    err.outputs = out
    raise err


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


def _check_outputs(kind, out, precision=None):
    """The build-seam output hook (installed by :func:`enable`)."""
    sanitize_tree(kind, out, precision=precision)


# env arming is tolerant where enable() is strict (mxtpu's convention):
# MXTPU_SANITIZE=1 means "arm everything", and an unrecognized value
# arms fully with a warning rather than failing the import
_env = _os.environ.get("MXTPU_SANITIZE", "").strip().lower()
if _env in ("", "0", "false", "no", "off"):
    pass
elif _env in _VALID:
    enable(_env)
else:
    if _env not in ("1", "true", "yes", "on"):
        import logging
        logging.getLogger(__name__).warning(
            "MXTPU_SANITIZE=%r is not one of %s; arming 'all'",
            _env, "|".join(_VALID))
    enable("all")
