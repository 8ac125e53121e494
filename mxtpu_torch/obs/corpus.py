"""The persistent measurement corpus (``MXTPU_CORPUS_DIR``).

Counterpart of ``mxtpu/obs/corpus.py``, in its file format: rows written
by either package load with the other's ``load``. The process computes
what a learned cost model trains on — the flops/bytes/build-ms of each
program build, the measured service ms of each serving batch and fit
step — and this module is the append-only JSONL run ledger that keeps
it.

Schema (version :data:`SCHEMA_VERSION`, one JSON object per line):

  * **build rows** (``"row": "build"``) — appended by
    ``diagnostics.record_program`` for every captured program build:
    the ProgramRecord features (``id``, ``kind``, ``owner``,
    ``compile_ms``, ``flops``, ``bytes_accessed``, ``argument_bytes``,
    ``output_bytes``, ``temp_bytes``, ``n_devices``, ``precision``,
    ``transforms``) plus the active compile-pipeline composition and
    the full resolved tune-knob vector (``knobs``/``registry_version``)
    — the *config* half of a config→measurement pair;
  * **service rows** (``"row": "service"``) — appended at the
    measurement seams: serving batch retire (``source: "serving"``,
    keyed by ``bucket``), the fit step loop (``"fit_step"``, keyed by
    ``rows``) and the decode session (``"decode_step"``,
    ``"decode_prefill"`` and ``"decode_request"``, keyed by ``rows``),
    each with measured ``ms`` — the *measurement* half;
  * **calibration rows** (``"row": "calib"``) — appended by
    ``compile.quant.persist_calibration``: one complete snapshot of
    the int8 activation-calibration stats (per-node count / abs-max /
    running percentile, plus the percentile used), so int8 scales
    calibrated from live traffic replay bit-identically offline
    (``compile.quant.replay_scales``).

Durability contract: one file per process (``mxtpu_corpus.<pid>.jsonl``
— fleet processes never interleave), every row flushed + fsynced at
append, directory fsynced at file creation. A writer killed
mid-append leaves at most one torn trailing line, which :func:`load`
tolerates by contract — every fully-appended row survives.

The whole corpus is env-gated: without ``MXTPU_CORPUS_DIR`` the hooks
cost one dict lookup and the hot paths never touch the filesystem.

``summarize()`` folds service rows into exactly the inputs
``tune.search`` consumes — per-bucket mean exec ms (the
``bucket_costs`` shape) and the fitted
:class:`~mxtpu_torch.tune.cost.ServiceLine` — so an offline search over
a saved corpus reproduces the in-process model.
"""
from __future__ import annotations

import json
import os
import time

from ..analysis import concurrency as _conc

__all__ = ["SCHEMA_VERSION", "enabled", "corpus_path", "record_build",
           "record_service", "record_calibration", "record_health",
           "load", "summarize", "reset"]

# v2: adds the "health" row kind (training-health stats per cadence,
# obs/health.py). Readers stay version-tolerant: load() keys on the
# row kind, never the version, and the torn-tail contract is unchanged
SCHEMA_VERSION = 2
_ENV = "MXTPU_CORPUS_DIR"

_WRITER_LOCK = _conc.lock("corpus", "_WRITER_LOCK")
_FILE = None  # (path, file-object) for the current MXTPU_CORPUS_DIR


def enabled():
    """True when a corpus directory is configured (read per call — one
    dict lookup; tests flip the env var at will)."""
    return bool(os.environ.get(_ENV))


def corpus_path(dirpath=None):
    """This process's corpus file under ``dirpath`` (default: the env
    dir)."""
    d = dirpath or os.environ.get(_ENV)
    if not d:
        return None
    return os.path.join(d, "mxtpu_corpus.%d.jsonl" % os.getpid())


def _writer_file():
    """The open append handle for the current corpus dir (reopened when
    the dir changes — tests point ``MXTPU_CORPUS_DIR`` at tmp dirs)."""
    global _FILE
    path = corpus_path()
    if path is None:
        return None
    with _WRITER_LOCK:
        if _FILE is not None and _FILE[0] == path:
            return _FILE[1]
        if _FILE is not None:
            try:
                _FILE[1].close()
            except OSError:
                pass
        fresh = not os.path.exists(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        f = open(path, "a", encoding="utf-8")
        if fresh:
            _fsync_dir(path)  # the file's creation itself is durable
        _FILE = (path, f)
        return f


def _fsync_dir(path):
    """fsync the directory holding ``path`` (its new entry is durable)."""
    fd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _append(row):
    """One durable JSONL append. Returns True when a row landed."""
    f = _writer_file()
    if f is None:
        return False
    line = json.dumps(row, separators=(",", ":"), default=str) + "\n"
    with _WRITER_LOCK:
        try:
            f.write(line)
            f.flush()
            os.fsync(f.fileno())
        except (OSError, ValueError):
            return False  # a bad disk must not kill the measured path
    return True


def reset():
    """Close the writer handle (tests switching corpus dirs)."""
    global _FILE
    with _WRITER_LOCK:
        if _FILE is not None:
            try:
                _FILE[1].close()
            except OSError:
                pass
            _FILE = None


# ------------------------------------------------------------- write side
_BUILD_FEATURES = ("id", "kind", "owner", "compile_ms", "flops",
                   "bytes_accessed", "argument_bytes", "output_bytes",
                   "temp_bytes", "n_devices", "precision", "transforms")


def _knob_vector():
    """The full resolved tune-knob vector at build time (default <
    artifact < env precedence, exactly what the process runs with)."""
    from ..tune import registry as _treg
    vec = {}
    for k in _treg.knobs():
        try:
            vec[k.name] = _treg.resolve(k.name)
        except Exception:
            vec[k.name] = None  # a broken knob must not lose the row
    return {"registry_version": _treg.registry_version(), "values": vec}


def record_build(rec_dict):
    """Append one program-build row (``rec_dict`` is
    ``ProgramRecord.to_dict()``). No-op unless the corpus is enabled."""
    if not enabled():
        return False
    row = {"v": SCHEMA_VERSION, "row": "build",
           "t": round(time.time(), 6)}
    for k in _BUILD_FEATURES:
        row[k] = rec_dict.get(k)
    try:
        from ..compile import pipeline as _pipeline
        row["pipeline"] = list(_pipeline.configured())
    except Exception:
        row["pipeline"] = []
    try:
        row["knobs"] = _knob_vector()
    except Exception:
        row["knobs"] = None
    return _append(row)


def record_service(source, ms, bucket=None, rows=None, program_id=None,
                   **extra):
    """Append one measured-service row. ``source`` names the seam
    (``serving``/``decode_step``/``decode_prefill``/``fit_step``);
    ``bucket``/``rows`` key it to the program's batch shape,
    ``program_id`` to a specific build row when the caller knows it."""
    if not enabled():
        return False
    row = {"v": SCHEMA_VERSION, "row": "service",
           "t": round(time.time(), 6), "source": str(source),
           "ms": round(float(ms), 6)}
    if bucket is not None:
        row["bucket"] = int(bucket)
    if rows is not None:
        row["rows"] = int(rows)
    if program_id is not None:
        row["program_id"] = program_id
    if extra:
        row.update(extra)
    return _append(row)


def record_calibration(stats, percentile=None):
    """Append one int8-calibration snapshot row (``stats`` is
    ``CalibRecorder.stats()`` — a complete per-node mapping, so replay
    reads the LATEST row and never stitches partials). No-op unless
    the corpus is enabled."""
    if not enabled():
        return False
    row = {"v": SCHEMA_VERSION, "row": "calib",
           "t": round(time.time(), 6),
           "stats": {str(k): dict(v) for k, v in (stats or {}).items()}}
    if percentile is not None:
        row["percentile"] = float(percentile)
    return _append(row)


def record_health(cadence, stats, loss=None, anomalies=None):
    """Append one training-health row: the per-class stat dicts as of
    one metric-sync cadence (``stats`` is HealthSession's
    ``{class: {grad_norm, weight_norm, update_ratio, grad_max,
    nonfinite}}``), the window loss, and any detector firings. No-op
    unless enabled."""
    if not enabled():
        return False
    row = {"v": SCHEMA_VERSION, "row": "health",
           "t": round(time.time(), 6), "cadence": int(cadence),
           "stats": {str(k): dict(v) for k, v in (stats or {}).items()}}
    if loss is not None:
        row["loss"] = float(loss)
    if anomalies:
        row["anomalies"] = [str(a) for a in anomalies]
    return _append(row)


# -------------------------------------------------------------- read side
def load(dirpath=None, strict=False):
    """Every schema-valid row across the dir's ``*.jsonl`` files,
    append-order per file. A torn FINAL line (writer killed mid-append)
    is tolerated by contract; mid-file garbage raises unless
    ``strict=False`` would hide real corruption — it always raises."""
    d = dirpath or os.environ.get(_ENV)
    if not d or not os.path.isdir(d):
        return []
    rows = []
    for name in sorted(os.listdir(d)):
        if not name.endswith(".jsonl"):
            continue
        with open(os.path.join(d, name), encoding="utf-8",
                  errors="replace") as f:
            data = f.read()
        lines = data.split("\n")
        for i, ln in enumerate(lines):
            if not ln.strip():
                continue
            try:
                row = json.loads(ln)
            except ValueError:
                if i == len(lines) - 1 and not strict:
                    continue  # the torn tail the contract tolerates
                raise ValueError(
                    "corpus %s: corrupt row at line %d" % (name, i + 1))
            if isinstance(row, dict) and row.get("row") in (
                    "build", "service", "calib", "health"):
                rows.append(row)
            elif strict:
                raise ValueError(
                    "corpus %s: unknown row kind at line %d"
                    % (name, i + 1))
    return rows


def summarize(rows=None, dirpath=None):
    """Fold the corpus into the shapes ``tune.search`` consumes.

    Returns counts, per-bucket mean service ms in the ``bucket_costs``
    shape (``{bucket: {"exec_ms": mean}}``, serving rows), and the
    fitted ``ServiceLine`` over them — the same closed-form fit
    ``tune.cost`` runs in-process, so offline == online.
    """
    if rows is None:
        rows = load(dirpath)
    builds = [r for r in rows if r.get("row") == "build"]
    services = [r for r in rows if r.get("row") == "service"]
    per_bucket = {}
    per_source = {}
    for r in services:
        src = r.get("source", "?")
        n, s = per_source.get(src, (0, 0.0))
        per_source[src] = (n + 1, s + float(r.get("ms", 0.0)))
        b = r.get("bucket")
        if b is None:
            continue
        n, s = per_bucket.get(int(b), (0, 0.0))
        per_bucket[int(b)] = (n + 1, s + float(r.get("ms", 0.0)))
    bucket_costs = {b: {"exec_ms": s / n}
                    for b, (n, s) in sorted(per_bucket.items())}
    out = {"schema": SCHEMA_VERSION, "rows": len(rows),
           "builds": len(builds), "services": len(services),
           "bucket_costs": bucket_costs,
           "bucket_counts": {b: n for b, (n, _) in per_bucket.items()},
           "source_ms_mean": {src: s / n
                              for src, (n, s) in per_source.items()}}
    if bucket_costs:
        from ..tune.cost import ServiceLine
        out["service_line"] = ServiceLine.fit(bucket_costs).to_dict()
    return out
