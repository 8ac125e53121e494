"""int8 post-training quantization: calibration capture + scale math.

Counterpart of ``mxtpu/compile/quant.py``: the same recorder, scale
math (numpy on the host, bit for bit mxtpu's), arming seam and corpus
rows. The port has no measurement corpus module yet (ROADMAP A.10), so
this module writes and reads its ``"calib"`` rows itself, in mxtpu's
file format (``$MXTPU_CORPUS_DIR/mxtpu_corpus.<pid>.jsonl``, schema 2):
a calibration either package persists loads in the other.
``quantize_array`` returns a torch int8 tensor on the weight's device.

The ``quant`` transform pass (:mod:`mxtpu_torch.analysis.rewrite`) rewrites
inference graphs to int8 weights with activation quantize/dequantize
pairs; THIS module owns everything the rewrite needs measured first:

* **weight scales** — computed offline from the bound parameter values
  (symmetric per-output-channel: ``scale = max|w| / 127`` per slice of
  axis 0), no calibration required;
* **activation scales** — calibrated from LIVE traffic. A
  :class:`CalibRecorder` hooks the compile pipeline's output-sanitizer
  seam (``pipeline.set_calib_observer``): while armed
  (``MXTPU_QUANT_CALIB=1`` or :func:`calibration_scope`), every
  inference program is built with the quantizable activations as extra
  observation heads, and the recorder folds each batch into per-node
  abs-max / running-percentile stats. Serving warmup and the decode
  step loop already run representative batches through this seam, so
  arming during either IS the calibration pass.
* **replayable persistence** — :func:`persist_calibration` appends the
  stats as a ``"calib"`` row to the measurement corpus
  (mxtpu's ``obs.corpus``); :func:`load_calibration` reads them back
  (behind the ``quant.calibration_load`` fault point), and
  :func:`scales_from_stats` derives bit-identical scales from either
  side — calibration captured live replays offline.

Stats are deterministic by construction: ``absmax`` and ``pct`` are
running MAXES over per-batch reductions (no averaging), so replaying
the same batches in any order reproduces the same scales bit-for-bit.

Telemetry: ``quant_calib_samples`` (observed activation tensors),
``quant_rejections{reason}`` (rewrite declines, bumped by the pass),
``quant_bytes_saved`` (weight bytes removed by the applied rewrite).
See docs/compile.md (Quantization).
"""
from __future__ import annotations

import contextlib
import os as _os

import numpy as _np

from .. import telemetry as _tel
from ..analysis import concurrency as _conc

__all__ = ["CalibRecorder", "recorder", "calibrating", "arm", "disarm",
           "calibration_scope", "weight_scales", "scales_from_stats",
           "quantize_array", "persist_calibration", "load_calibration",
           "replay_scales", "TINY_SCALE"]

#: scale floor: an all-zero weight channel / dead activation must not
#: divide by zero — 1e-12 quantizes everything in it to 0 exactly
TINY_SCALE = 1e-12

_ENV = "MXTPU_QUANT_CALIB"


def _host_f32(x):
    """A tensor, NDArray or array as a host float32 numpy array."""
    x = getattr(x, "_data", x)
    if hasattr(x, "detach"):
        import torch
        return x.detach().to(torch.float32).cpu().numpy()
    return _np.asarray(x, dtype=_np.float32)


def _default_percentile():
    from ..tune import registry as _knobs
    return float(_knobs.resolve("quant.calibration_percentile"))


class CalibRecorder:
    """Per-node activation statistics, folded batch by batch.

    ``stats`` maps an observed entry name (the producing node's output
    name in the UNREWRITTEN graph) to ``{"count", "absmax", "pct"}``
    where ``pct`` is the running max of the per-batch
    ``percentile(|x|, p)`` — a deterministic, replay-stable clipping
    statistic (an average would depend on batch order)."""

    def __init__(self, percentile=None):
        self._lock = _conc.lock("CalibRecorder", "_lock")
        self.percentile = float(percentile) if percentile is not None \
            else _default_percentile()
        self._stats = {}

    @property
    def n_samples(self):
        with self._lock:
            return sum(s["count"] for s in self._stats.values())

    def observe(self, kind, named):
        """Fold one batch of observed activations (``{name: array}``)
        into the stats. Called from the pipeline's instrumented-program
        wrapper — one host transfer per observed call, priced exactly
        like the numerics sanitizer (calibration is an armed mode, not
        a steady-state path). Never raises."""
        n = 0
        for name, arr in named.items():
            try:
                # allow-sync(armed calibration mode only — the
                # host transfer IS the observation, priced like the
                # numerics sanitizer; never on the steady-state path)
                a = _np.abs(_host_f32(arr))
            except Exception:
                # allow-swallow(an unobservable head must not
                # take down the inference call it rode in on; the
                # sample simply doesn't count)
                continue
            if a.size == 0:
                continue
            # allow-sync(armed calibration mode — see above)
            amax = float(a.max())
            pct = float(_np.percentile(a, self.percentile))
            with self._lock:
                s = self._stats.get(name)
                if s is None:
                    s = {"count": 0, "absmax": 0.0, "pct": 0.0}
                    self._stats[name] = s
                s["count"] += 1
                s["absmax"] = max(s["absmax"], amax)
                s["pct"] = max(s["pct"], pct)
            n += 1
        if n:
            _tel.counter(
                "quant_calib_samples",
                help="activation tensors folded into int8 calibration "
                     "stats (armed capture only)").inc(n)

    def stats(self):
        """Snapshot: ``{name: {count, absmax, pct}}``."""
        with self._lock:
            return {k: dict(v) for k, v in self._stats.items()}

    def merge_stats(self, stats):
        """Fold a persisted stats mapping in (corpus replay): counts
        add, absmax/pct take the max — the same fold observe() does."""
        for name, s in (stats or {}).items():
            with self._lock:
                mine = self._stats.get(name)
                if mine is None:
                    mine = {"count": 0, "absmax": 0.0, "pct": 0.0}
                    self._stats[name] = mine
                mine["count"] += int(s.get("count", 0))
                mine["absmax"] = max(mine["absmax"],
                                     float(s.get("absmax", 0.0)))
                mine["pct"] = max(mine["pct"], float(s.get("pct", 0.0)))

    def scales(self):
        """Per-tensor activation scales from the folded stats:
        ``pct / 127`` (clipped at :data:`TINY_SCALE`)."""
        return scales_from_stats(self.stats())

    def clear(self):
        with self._lock:
            self._stats.clear()


def scales_from_stats(stats):
    """``{name: scale}`` from a stats mapping — THE one derivation both
    live capture and corpus replay go through, so replayed scales are
    bit-identical to live ones by construction."""
    out = {}
    for name, s in (stats or {}).items():
        out[name] = max(float(s.get("pct", 0.0)) / 127.0, TINY_SCALE)
    return out


# ------------------------------------------------------------ arming seam
#: the armed recorder; None = off. calibrating() below is the only
#: reader on build paths — one module-global read + None test (the
#: sanitizer/faults zero-overhead convention).
_RECORDER = None


def recorder():
    """The armed :class:`CalibRecorder` (None when off)."""
    return _RECORDER


def calibrating():
    """True while calibration capture is armed — the executor builds
    inference programs with observation heads only then."""
    return _RECORDER is not None


def arm(rec=None, percentile=None):
    """Arm calibration capture process-wide: install ``rec`` (or a
    fresh recorder) as the pipeline's calibration observer. Programs
    built AFTER arming carry observation heads; disarming rebuilds
    clean programs (the executor keys its program table on the calib
    flag). Returns the armed recorder."""
    global _RECORDER
    from . import pipeline as _pipeline
    rec = rec if rec is not None else CalibRecorder(percentile=percentile)
    _RECORDER = rec
    _pipeline.set_calib_observer(rec.observe)
    return rec


def disarm():
    """Disarm capture; the last recorder stays readable via the object
    :func:`arm` returned."""
    global _RECORDER
    from . import pipeline as _pipeline
    rec, _RECORDER = _RECORDER, None
    _pipeline.set_calib_observer(None)
    return rec


@contextlib.contextmanager
def calibration_scope(rec=None, percentile=None):
    """Arm calibration for a block (warmup runs, tests)::

        with quant.calibration_scope() as rec:
            pool.warmup(buckets)        # representative traffic
        quant.persist_calibration(rec)  # replayable corpus row
    """
    prev = _RECORDER
    rec = arm(rec, percentile=percentile)
    try:
        yield rec
    finally:
        if prev is None:
            disarm()
        else:
            arm(prev)


# ------------------------------------------------------------- scale math
def weight_scales(w, axis=0, per_channel=True):
    """Symmetric int8 weight scales for ``w``: per output channel
    (``max|w| / 127`` over every other axis) when ``per_channel``,
    one per-tensor scale otherwise. Returns ``(scales_tuple, axis)``
    ready for the quantize/dequantize attr."""
    # allow-sync(scale math runs once per program build / weight
    # version, on the transform path — never per step)
    a = _np.abs(_host_f32(w))
    if per_channel and a.ndim > 0:
        reduce_axes = tuple(i for i in range(a.ndim) if i != axis)
        m = a.max(axis=reduce_axes) if reduce_axes else a
        scales = _np.maximum(m / _np.float32(127.0), TINY_SCALE)
        return tuple(float(s) for s in scales.ravel()), int(axis)
    # allow-sync(once per build — see above)
    m = float(a.max()) if a.size else 0.0
    return (max(m / 127.0, TINY_SCALE),), -1


def quantize_array(arr, scale, axis=-1):
    """Quantize a live parameter tensor to int8 with the pass's recorded
    scales (the executor's prepared-argument path: computed once per
    weight version, streamed to the program as int8): ``round(w /
    scale)`` half to even, clipped to [-127, 127], as mxtpu's. Returns
    a torch int8 tensor on the weight's device."""
    import torch
    a = getattr(arr, "_data", arr)
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(_np.asarray(a, dtype=_np.float32))
    a = a.to(torch.float32)
    s = torch.as_tensor(_np.asarray(scale, dtype=_np.float32),
                        device=a.device)
    if int(axis) >= 0 and a.ndim > 0:
        shape = [1] * a.ndim
        shape[int(axis)] = s.numel()
        s = s.reshape(shape)
    q = torch.round(a / s)
    return torch.clamp(q, -127, 127).to(torch.int8)


# ------------------------------------------------------- corpus persistence
_CORPUS_ENV = "MXTPU_CORPUS_DIR"
_CORPUS_SCHEMA = 2


def _corpus_append(row):
    """One durable JSONL append to this process's corpus file (mxtpu's
    ``obs.corpus._append``). Returns True when a row landed."""
    import json
    import time
    d = _os.environ.get(_CORPUS_ENV)
    if not d:
        return False
    row = dict(row, v=_CORPUS_SCHEMA, t=round(time.time(), 6))
    path = _os.path.join(d, "mxtpu_corpus.%d.jsonl" % _os.getpid())
    try:
        _os.makedirs(d, exist_ok=True)
        with open(path, "a", encoding="utf-8") as f:
            f.write(json.dumps(row, separators=(",", ":"), default=str)
                    + "\n")
            f.flush()
            _os.fsync(f.fileno())
    except OSError:
        return False  # a bad disk must not kill the measured path
    return True


def _corpus_rows(dirpath=None):
    """Every row of the corpus dir's ``*.jsonl`` files, append order per
    file (mxtpu's ``obs.corpus.load``: a torn final line is skipped,
    mid-file garbage raises)."""
    import json
    d = dirpath or _os.environ.get(_CORPUS_ENV)
    if not d or not _os.path.isdir(d):
        return []
    rows = []
    for name in sorted(_os.listdir(d)):
        if not name.endswith(".jsonl"):
            continue
        with open(_os.path.join(d, name), encoding="utf-8",
                  errors="replace") as f:
            lines = f.read().split("\n")
        for i, ln in enumerate(lines):
            if not ln.strip():
                continue
            try:
                row = json.loads(ln)
            except ValueError:
                if i == len(lines) - 1:
                    continue  # the torn tail the contract tolerates
                raise ValueError(
                    "corpus %s: corrupt row at line %d" % (name, i + 1))
            if isinstance(row, dict):
                rows.append(row)
    return rows


def persist_calibration(rec=None):
    """Append the recorder's stats to the measurement corpus as one
    ``"calib"`` row (no-op without ``MXTPU_CORPUS_DIR``). The row is a
    complete snapshot — replay takes the latest row, it never has to
    stitch partials."""
    rec = rec if rec is not None else _RECORDER
    if rec is None:
        return False
    row = {"row": "calib",
           "stats": {str(k): dict(v) for k, v in rec.stats().items()}}
    if rec.percentile is not None:
        row["percentile"] = float(rec.percentile)
    return _corpus_append(row)


def load_calibration(dirpath=None):
    """The latest persisted calibration snapshot from the corpus:
    ``(stats, percentile)`` or ``(None, None)``. The
    ``quant.calibration_load`` fault point guards the read — a corrupt
    or injected-failing corpus must surface as a rewrite decline (the
    graph serves unquantized), never a crashed build."""
    from .. import faults as _faults
    _faults.point("quant.calibration_load")
    latest = None
    for row in _corpus_rows(dirpath):
        if row.get("row") == "calib":
            latest = row
    if latest is None:
        return None, None
    return latest.get("stats") or {}, latest.get("percentile")


def replay_scales(dirpath=None):
    """Activation scales re-derived from the persisted corpus stats —
    the offline half of the replay contract (bit-identical to the live
    recorder's :meth:`CalibRecorder.scales` for the same capture)."""
    stats, _p = load_calibration(dirpath)
    return scales_from_stats(stats) if stats is not None else {}


# env arming at import (serving deployments set MXTPU_QUANT_CALIB=1 for
# the warmup window). Tolerant parse per the sanitizer convention.
if _os.environ.get(_ENV, "").strip() in ("1", "true", "on", "arm"):
    arm()
