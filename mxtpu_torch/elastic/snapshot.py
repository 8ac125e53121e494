"""Async snapshots: capture the fused step's state off the critical path.

Counterpart of ``mxtpu/elastic/snapshot.py``, with its names, files and
formats. The capture half runs on the TRAINING thread and never waits
for the card or the disk: ``FusedTrainStep.export_host_state`` clones the
parameters, aux states and optimizer-state leaves on the compute stream
into a reused device buffer set (one ``torch._foreach_copy_``: the next
step's in-place update cannot reach the clones), then copies them to
pinned host memory ``non_blocking`` on a dedicated copy stream and
records an event. The job goes to the :class:`SnapshotWriter` thread,
which waits on that event (the one sync of the path, on the writer),
serializes in the ``nd.save`` format, ``fsync``\\ s and **atomically
renames**: a crash at any point leaves the previous generation or the
new one, never a torn file that loads. On ``cpu()`` the capture is a
plain copy.

Durability protocol (one *generation* = one consistent train state):

1. ``<prefix>.g<GEN>.p<R>of<W>.elastic``  — per-process data file
   (tmp + fsync + rename);
2. ``<prefix>.g<GEN>.manifest.json``      — everything scalar plus the
   per-array schema and per-piece index map (tmp + fsync + rename);
3. ``<prefix>.latest``                    — pointer to the newest
   complete generation, renamed into place LAST.

``latest_manifest`` follows the pointer and *verifies* the generation
(the manifest parses, every data file exists at its recorded size); a
torn or missing generation falls back to the newest older one that
verifies. Old generations are pruned after the pointer flip (``keep``
newest retained).

Under a ``ShardingPlan`` the optimizer leaves the plan keeps by rows are
written as each data position's row block (one piece each, its global
index in the manifest beside the plan's spec); nothing is gathered. The
manifest's keys are mxtpu's; its RNG entry is the port's per-device
``torch.Generator`` states (``rng:torch/<device>``, the seed in
``rng_torch``) where mxtpu's is its JAX key (``rng:key``): mxtpu reads a
port generation's arrays, and a port resume refuses an mxtpu one.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time

import numpy as _np
import torch

from .. import telemetry as _tel
from ..analysis import concurrency as _conc
from ..faults import RetryPolicy, env_attempts
from ..faults import injection as _faults
from .durable import fsync_dir as _fsync_dir
from .durable import write_atomic as _write_atomic

log = logging.getLogger("mxtpu_torch.elastic")

FORMAT = "mxtpu-elastic-1"

#: monotonic time of the last durable generation (process-wide); the age
#: gauge below reads it. 0.0 = no snapshot yet this process.
_LAST_DURABLE_T = 0.0


def _snapshot_age():
    if _LAST_DURABLE_T == 0.0:
        return 0.0
    return round(time.monotonic() - _LAST_DURABLE_T, 3)


# registry-direct (exists under MXTPU_TELEMETRY=0, like the watchdog age)
_tel.registry().gauge(
    "elastic_snapshot_age_s", fn=_snapshot_age,
    help="seconds since the last durable elastic snapshot generation "
         "(0 before the first)")


# --------------------------------------------------------------- file layer
def _write_ndsave_atomic(path, host_arrays):
    """Serialize a {key: host array} dict in the nd.save binary format,
    fsync, atomically rename. Returns the byte count."""
    from ..ndarray.ndarray import save_host
    tmp = path + ".tmp"
    save_host(tmp, list(host_arrays.items()))
    with open(tmp, "rb+") as f:
        f.flush()
        os.fsync(f.fileno())
        nbytes = f.seek(0, 2)
    # between the tmp write and its rename: firing here IS a torn write
    _faults.point("elastic.snapshot.fsync_rename")
    os.replace(tmp, path)
    _fsync_dir(path)
    return nbytes


# ------------------------------------------------------ device -> host copy
_COPY_STREAMS = {}


def _copy_stream(device):
    """The dedicated device-to-host copy stream of ``device``."""
    s = _COPY_STREAMS.get(device)
    if s is None:
        s = _COPY_STREAMS[device] = torch.cuda.Stream(device=device)
    return s


def stage_to_host(tensors):
    """Pinned host copies of ``tensors`` started ``non_blocking`` on each
    card's copy stream, after the work queued so far on its current
    stream. Returns ``(host tensors, events)``: the host bytes are valid
    once every event has completed (the writer waits on them; the caller
    never does). Host tensors are cloned, with no event."""
    out, events = [], []
    by_dev = {}
    for i, t in enumerate(tensors):
        t = t.detach()
        if t.device.type != "cuda":
            out.append(t.clone())
            continue
        out.append(None)
        by_dev.setdefault(t.device, []).append(i)
    for dev, idxs in by_dev.items():
        stream = _copy_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for i in idxs:
                src = tensors[i].detach()
                dst = torch.empty(src.shape, dtype=src.dtype,
                                  pin_memory=True)
                dst.copy_(src, non_blocking=True)
                # the source may be freed by its owner before the copy
                # stream reaches it: the allocator must wait for it
                src.record_stream(stream)
                out[i] = dst
            ev = torch.cuda.Event()
            ev.record(stream)
        events.append(ev)
    return out, events


def _host_value(v):
    """A materialized job value as a cpu tensor or numpy array."""
    v = getattr(v, "_data", v)
    if isinstance(v, torch.Tensor):
        return v.detach()
    return _np.asarray(v)


# --------------------------------------------------------------- the writer
class SnapshotJob:
    """One unit of writer work.

    ``kind``:

    * ``"generation"`` — a full elastic generation: data file + manifest
      + pointer flip + prune (``prefix``/``generation`` set);
    * ``"ndsave"``     — a bare nd-format file at ``data_path``
      (async ``save_checkpoint`` params);
    * ``"bytes"``      — ``assemble(host_arrays) -> bytes`` written
      atomically at ``data_path`` (async optimizer ``.states``).

    ``arrays`` values are the job's own: pinned host tensors whose copy
    from the card completes with ``ready`` (CUDA events the writer waits
    on before it reads them), or host copies. ``coalescable`` periodic
    jobs queued behind an unstarted older one replace it (latest-wins —
    the writer never falls behind by more than one in-flight write).
    """

    def __init__(self, kind, arrays, prefix=None, generation=0,
                 manifest=None, data_path=None, assemble=None,
                 proc_index=0, proc_count=1, keep=2, coalescable=False,
                 on_done=None, label="snapshot", ready=()):
        self.kind = kind
        self.arrays = arrays
        self.prefix = prefix
        self.generation = generation
        self.manifest = manifest
        self.data_path = data_path
        self.assemble = assemble
        self.proc_index = proc_index
        self.proc_count = proc_count
        self.keep = keep
        self.coalescable = coalescable
        self.on_done = on_done
        self.label = label
        self.ready = list(ready or ())


def data_basename(prefix, generation, proc_index=0, proc_count=1):
    return "%s.g%06d.p%dof%d.elastic" % (os.path.basename(prefix),
                                         generation, proc_index, proc_count)


def manifest_path(prefix, generation):
    return "%s.g%06d.manifest.json" % (prefix, generation)


def pointer_path(prefix):
    return "%s.latest" % prefix


class SnapshotWriter:
    """The background writer thread. One per process (``writer()``);
    daemon so it can never hang interpreter shutdown, with an explicit
    ``flush()``/``close()`` lifecycle for callers that need durability
    (final preemption snapshot, ``wait_checkpoints``)."""

    def __init__(self, retry=None):
        self._lock = _conc.lock("SnapshotWriter", "_lock")
        self._cond = _conc.condition(self._lock)
        self._queue = []
        self._busy = False
        self._stop = False
        self._thread = None
        self.jobs_written = 0
        self.jobs_failed = 0
        self.jobs_coalesced = 0
        self.last_error = None
        self._job = None  # the job under _write (for the recover hook)
        # IO failures retry through the ONE shared policy: ENOSPC frees
        # space first (prune to keep-1) and retries at once; other IO
        # errors back off, bounded; exhaustion degrades (the failure is
        # counted and training continues), never raising into fit.
        # MXTPU_ELASTIC_WRITE_RETRIES counts the retries AFTER the first
        # attempt; both knobs parse tolerantly
        try:
            backoff = float(os.environ.get(
                "MXTPU_ELASTIC_WRITE_BACKOFF_S", "0.1"))
        except ValueError:
            backoff = 0.1
        self._retry = retry if retry is not None else RetryPolicy(
            "elastic.snapshot.write",
            max_attempts=env_attempts("MXTPU_ELASTIC_WRITE_RETRIES", 3),
            backoff_s=backoff, backoff_cap_s=5.0, retryable=OSError,
            recover=self._recover_write, logger=log)

    def _recover_write(self, exc, attempt):
        """Between write attempts: a disk-full generation write frees
        space by pruning down to keep-1 old generations (never the one
        the pointer names), then retries at once — trading history depth
        for the NEW state, which is the one a preemption needs."""
        import errno as _errno
        job = self._job
        if getattr(exc, "errno", None) == _errno.ENOSPC \
                and job is not None and job.kind == "generation":
            log.warning("elastic: ENOSPC writing g%06d — pruning to "
                        "keep=%d and retrying", job.generation,
                        max(1, job.keep - 1))
            prune(job.prefix, keep=max(1, job.keep - 1))
            return True
        return False

    # ------------------------------------------------------------ lifecycle
    def _ensure_thread(self):
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mxtpu-elastic-writer")
        self._thread.start()

    def submit(self, job):
        """Enqueue; never blocks the caller on IO."""
        with self._cond:
            if job.coalescable:
                # replace an unstarted older periodic snapshot for the
                # same prefix: a slow disk makes snapshots sparser, not
                # the queue deeper
                kept = [j for j in self._queue
                        if not (j.coalescable and j.prefix == job.prefix)]
                self.jobs_coalesced += len(self._queue) - len(kept)
                self._queue = kept
            self._queue.append(job)
            self._ensure_thread()
            self._cond.notify_all()
        return job

    def flush(self, timeout=None):
        """Block until every submitted job is durable (or timeout).
        Returns True when the queue fully drained.

        Liveness under writer death: while jobs are queued the thread
        is re-ensured on every wait slice, not just once — a thread
        killed mid-job still reads ``is_alive()`` during its unwind, so
        a single up-front check can race the death and leave the queue
        ownerless forever."""
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        with self._cond:
            while self._queue or self._busy:
                if self._queue and not self._stop:
                    self._ensure_thread()
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(0.1 if remaining is None
                                else min(0.1, remaining))
            return True

    def close(self, timeout=10.0):
        self.flush(timeout)
        with self._cond:
            self._stop = True
            self._cond.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout=timeout)

    # ------------------------------------------------------------ the loop
    def _loop(self):
        while True:
            with self._cond:
                while not self._queue and not self._stop:
                    self._cond.wait()
                if self._stop and not self._queue:
                    return
                job = self._queue.pop(0)
                self._busy = True
            try:
                self._job = job
                self._retry.call(self._write, job)
                self.jobs_written += 1
            except Exception as exc:  # a bad disk must not kill training
                # retries exhausted (or a non-IO failure): DEGRADE —
                # count it, mark the generation failed, keep training.
                # The pointer never flipped, so resume falls back to the
                # last good generation
                self.last_error = exc
                self.jobs_failed += 1
                log.error("elastic snapshot write failed (%s): %r",
                          job.label, exc)
                _tel.counter("elastic_snapshot_errors",
                             help="snapshot writer jobs that failed").inc()
                if job.kind == "generation":
                    _count_failed_generation()
            except BaseException:
                # thread death (injected kill, teardown): count the lost
                # job, then die for real — submit()/flush() respawn the
                # thread for the jobs still queued
                self.jobs_failed += 1
                if job.kind == "generation":
                    _count_failed_generation()
                raise
            finally:
                # drop the finished job now, not when the next one comes:
                # its arrays (pinned host memory, a module's state) would
                # stay alive while the thread waits
                self._job = job = None
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()

    def _write(self, job):
        with _tel.span("elastic.write", category="elastic",
                       tags={"kind": job.kind, "label": job.label,
                             "generation": job.generation}):
            self._write_inner(job)

    def _write_inner(self, job):
        global _LAST_DURABLE_T
        _faults.point("elastic.snapshot.write")
        t0 = time.perf_counter()
        for ev in job.ready:
            # mxtpu: allow-sync(writer thread: waiting for the capture's
            # device-to-host copies IS this thread's job — the training
            # thread never waits on them)
            ev.synchronize()
        host = {k: _host_value(v) for k, v in job.arrays.items()}
        nbytes = 0
        if job.kind == "generation":
            d = os.path.dirname(job.prefix)
            if d:
                os.makedirs(d, exist_ok=True)
            base = data_basename(job.prefix, job.generation,
                                 job.proc_index, job.proc_count)
            data_path = os.path.join(d or ".", base)
            nbytes += _write_ndsave_atomic(data_path, host)
            man = dict(job.manifest)
            man["data_files"] = {base: {"bytes": os.path.getsize(data_path)}}
            man_bytes = json.dumps(man, indent=1, default=str).encode()
            nbytes += _write_atomic(manifest_path(job.prefix,
                                                  job.generation), man_bytes)
            ptr = {"format": FORMAT, "generation": job.generation,
                   "manifest": os.path.basename(
                       manifest_path(job.prefix, job.generation))}
            nbytes += _write_atomic(pointer_path(job.prefix),
                                    json.dumps(ptr).encode())
            prune(job.prefix, keep=job.keep)
            _LAST_DURABLE_T = time.monotonic()
        elif job.kind == "ndsave":
            nbytes += _write_ndsave_atomic(job.data_path, host)
            if job.manifest is not None:
                man = dict(job.manifest)
                man.setdefault("data_file",
                               os.path.basename(job.data_path))
                man.setdefault("bytes", os.path.getsize(job.data_path))
                nbytes += _write_atomic(
                    job.data_path + ".manifest.json",
                    json.dumps(man, indent=1, default=str).encode())
        elif job.kind == "bytes":
            nbytes += _write_atomic(job.data_path, job.assemble(host))
        else:
            raise ValueError("unknown snapshot job kind %r" % job.kind)
        _tel.counter("elastic_snapshot_bytes",
                     help="bytes written by the snapshot writer"
                     ).inc(nbytes)
        _tel.histogram("elastic_snapshot_write_ms",
                       help="writer-thread serialize+fsync+rename time "
                            "per job").observe((time.perf_counter() - t0)
                                               * 1e3)
        if job.on_done is not None:
            try:
                job.on_done(job)
            except Exception:
                # mxtpu: allow-swallow(caller's completion hook — its
                # failure must not mark a DURABLE write as failed)
                log.exception("elastic: on_done hook of %s failed",
                              job.label)


def _count_failed_generation():
    _tel.counter("elastic_write_failures",
                 help="snapshot GENERATIONS abandoned after write retries "
                      "exhausted (training continued; resume falls back "
                      "to the last good generation)").inc()


_WRITER = None
_WRITER_LOCK = _conc.lock("snapshot", "_WRITER_LOCK")


def writer():
    """The process-wide snapshot writer (created on first use)."""
    global _WRITER
    with _WRITER_LOCK:
        if _WRITER is None:
            _WRITER = SnapshotWriter()
        return _WRITER


def flush_pending():
    """Drain the process-wide writer if one exists (no thread is made)."""
    w = _WRITER
    if w is not None:
        w.flush()


# ---------------------------------------------------------------- load side
def _manifest_intact(man, dirname):
    """Every data file the manifest names exists at its recorded size."""
    files = man.get("data_files") or {}
    if not files:
        return False
    for base, meta in files.items():
        path = os.path.join(dirname, base)
        try:
            if os.path.getsize(path) != int(meta["bytes"]):
                return False
        except (OSError, KeyError, TypeError, ValueError):
            return False
    return True


def _read_json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def list_generations(prefix):
    """Generation numbers with a manifest on disk, ascending."""
    d = os.path.dirname(prefix) or "."
    base = os.path.basename(prefix)
    out = []
    try:
        names = os.listdir(d)
    except OSError:
        return out
    for n in names:
        if n.startswith(base + ".g") and n.endswith(".manifest.json"):
            try:
                out.append(int(n[len(base) + 2:-len(".manifest.json")]))
            except ValueError:
                pass
    return sorted(out)


def latest_manifest(prefix, flush=True):
    """The newest generation that VERIFIES (manifest parses, data files
    present at recorded sizes), or None. Follows the ``.latest`` pointer
    first; a torn/incomplete generation falls back to the newest older
    one — the crash-window contract. ``flush`` drains the writer first so
    an in-flight write is never half-read."""
    if flush:
        writer().flush()
    d = os.path.dirname(prefix) or "."
    candidates = []
    ptr = _read_json(pointer_path(prefix))
    if ptr and "generation" in ptr:
        candidates.append(int(ptr["generation"]))
    for g in reversed(list_generations(prefix)):
        if g not in candidates:
            candidates.append(g)
    for gen in candidates:
        man = _read_json(manifest_path(prefix, gen))
        if man is not None and _manifest_intact(man, d):
            man["_manifest_dir"] = d
            man["_generation"] = gen
            return man
        if man is not None:
            log.warning("elastic: generation %d of %s is torn/incomplete "
                        "— falling back", gen, prefix)
    return None


def load_arrays(manifest):
    """All arrays of a verified generation as {key: numpy} (this
    process's data files; bfloat16 arrays as cpu tensors, which numpy
    cannot hold)."""
    from .. import ndarray as nd
    d = manifest.get("_manifest_dir", ".")
    out = {}
    for base in (manifest.get("data_files") or {}):
        for k, v in nd.load(os.path.join(d, base)).items():
            t = v._data
            out[k] = t if t.dtype == torch.bfloat16 else t.numpy()
    return out


def prune(prefix, keep=2):
    """Drop all but the ``keep`` newest generations (manifest + data
    files). Never touches the generation the pointer names."""
    keep = max(1, int(keep))
    gens = list_generations(prefix)
    if len(gens) <= keep:
        return
    ptr = _read_json(pointer_path(prefix)) or {}
    protected = ptr.get("generation")
    d = os.path.dirname(prefix) or "."
    base = os.path.basename(prefix)
    for g in gens[:-keep]:
        if g == protected:
            continue
        man = _read_json(manifest_path(prefix, g)) or {}
        for fname in (man.get("data_files") or {}):
            try:
                os.remove(os.path.join(d, fname))
            except OSError:
                pass
        # any stray data files of this generation (torn writes)
        g_tag = "%s.g%06d." % (base, g)
        try:
            for n in os.listdir(d):
                if n.startswith(g_tag) and n.endswith(".elastic"):
                    os.remove(os.path.join(d, n))
        except OSError:
            pass
        try:
            os.remove(manifest_path(prefix, g))
        except OSError:
            pass


# ------------------------------------------------------------- capture side
def safe_arrays(values):
    """Mutation-safe capture of a {name: NDArray/tensor/array} dict for an
    async write: ``(arrays, ready)``. Card values are cloned on their
    compute stream and copied to pinned host memory on the copy stream
    (``ready``: the events the writer waits on); host values are copied
    at once (the updater mutates them in place). Never waits for the
    card."""
    keys = list(values)
    raw = [getattr(values[k], "_data", values[k]) for k in keys]
    tensors = [(i, t) for i, t in enumerate(raw)
               if isinstance(t, torch.Tensor)]
    out = {}
    for i, v in enumerate(raw):
        if not isinstance(v, torch.Tensor):
            out[keys[i]] = _np.array(v)
    clones = [t.detach().clone() if t.device.type == "cuda" else t
              for _, t in tensors]
    host, ready = stage_to_host(clones)
    for (i, _), h in zip(tensors, host):
        out[keys[i]] = h
    return out, ready


def async_save_ndarrays(path, values, manifest=None, on_done=None,
                        label=None):
    """Write ``values`` (a {name: NDArray/tensor/array} dict) at ``path``
    in the ``nd.save`` format on the writer thread — fsynced, atomically
    renamed. ``manifest`` (optional dict) lands beside it as
    ``<path>.manifest.json`` after the data file. The call returns as
    soon as the capture is enqueued."""
    arrays, ready = safe_arrays(values)
    job = SnapshotJob("ndsave", arrays, data_path=path, manifest=manifest,
                      on_done=on_done, ready=ready,
                      label=label or os.path.basename(path))
    return writer().submit(job)


def collect_opt_arrays(fused, snap_opt):
    """Flatten a fused step's optimizer state for serialization.

    ``snap_opt`` is ``export_*_state``'s per-replica list of {name:
    state}. Returns ``(arrays, opt_manifest)``:

    * leaves the plan does not keep by rows land whole under
      ``opt:<name>/<leaf-index>``, from the first replica;
    * leaves kept by rows land as each data position's row block
      ``opt:<name>/<i>#<piece>``, with the plan's spec and each piece's
      global index recorded in the manifest — each block is written as
      its replica holds it; nothing is gathered.
    """
    from ..module.fused import state_leaves
    from ..ndarray.ndarray import dtype_name
    from ..sharding import spec_to_json
    arrays, entries = {}, {}
    sharded = set(fused.sharded_names)
    for name in fused.trainable:
        leaves = state_leaves(snap_opt[0][name])
        entry = {"leaves": len(leaves),
                 "spec": spec_to_json(fused.opt_spec(name))}
        if name not in sharded:
            for i, leaf in enumerate(leaves):
                arrays["opt:%s/%d" % (name, i)] = leaf
            entries[name] = entry
            continue
        holders = fused.row_block_replicas()
        shards = {}
        for i, leaf in enumerate(leaves):
            rows = leaf.shape[0]
            shape = [rows * len(holders)] + list(leaf.shape[1:])
            pieces = []
            for pos, r in enumerate(holders):
                block = state_leaves(snap_opt[r][name])[i]
                pkey = "opt:%s/%d#%d" % (name, i, pos)
                arrays[pkey] = block
                pieces.append({"key": pkey, "index": [
                    [pos * rows, (pos + 1) * rows]] +
                    [[0, int(s)] for s in leaf.shape[1:]]})
            shards[str(i)] = {"global_shape": shape,
                              "dtype": dtype_name(leaf.dtype),
                              "pieces": pieces}
        entry["shards"] = shards
        entries[name] = entry
    return arrays, entries


def _flatten_state_dict(state):
    """Split an iterator checkpoint dict (possibly nested) into
    (json-able scalars, numpy arrays) with '/'-joined keys."""
    scalars, arrays = {}, {}

    def walk(d, path):
        for k, v in d.items():
            p = ("%s/%s" % (path, k)) if path else str(k)
            if isinstance(v, dict):
                walk(v, p)
            elif isinstance(v, (int, float, str, bool)) or v is None:
                scalars[p] = v
            else:
                # mxtpu: allow-sync(iterator cursor state is host data —
                # numpy index arrays and ints, never device arrays)
                arrays[p] = _np.array(v)
    walk(state, "")
    return scalars, arrays


def _unflatten_state_dict(scalars, arrays):
    out = {}
    for src in (scalars, arrays):
        for key, v in src.items():
            parts = key.split("/")
            d = out
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = v
    return out


def capture_module(module, cursor, eval_metric=None, iter_state=None):
    """Capture everything a bit-exact resume needs, WITHOUT waiting on
    the card or the disk on the training thread.

    Returns ``(arrays, manifest, ready)`` for a ``generation`` writer
    job. ``cursor`` is a dict with ``epoch``/``nbatch``/``global_step``/
    ``epoch_boundary``. The caller has synced any device metric
    accumulator first (the cadence sync), so the host metric state is
    complete through the cursor step.
    """
    import pickle
    import random as _pyrandom

    from .. import random as _rnd
    from ..metric import EvalMetric, _flatten_metrics

    arrays, ready = {}, []
    manifest = {"format": FORMAT, "version": 1,
                "time": round(time.time(), 3), "cursor": dict(cursor)}
    fused = getattr(module, "_fused", None)
    if fused is not None:
        snap_p, snap_a, snap_o, ready = fused.export_host_state()
        for n, v in snap_p.items():
            arrays["arg:%s" % n] = v
        for n, v in snap_a.items():
            arrays["aux:%s" % n] = v
        opt_arrays, opt_entries = collect_opt_arrays(fused, snap_o)
        arrays.update(opt_arrays)
        manifest["opt_format"] = "leaves"
        manifest["opt_entries"] = opt_entries
        if fused._plan is not None:
            manifest["mesh"] = dict(fused._plan.mesh_ctx.axis_sizes)
    else:
        # the cold path: get_params already returns host copies
        arg_params, aux_params = module.get_params()
        for n, v in arg_params.items():
            arrays["arg:%s" % n] = v._data
        for n, v in (aux_params or {}).items():
            arrays["aux:%s" % n] = v._data
        updater = getattr(module, "_updater", None)
        if updater is not None:
            blob = updater.get_states()
            arrays["blob:updater"] = _np.frombuffer(blob,
                                                    dtype=_np.uint8).copy()
            manifest["opt_format"] = "updater_blob"
    manifest["params"] = sorted(n[4:] for n in arrays if n.startswith("arg:"))
    manifest["aux"] = sorted(n[4:] for n in arrays if n.startswith("aux:"))

    # --- RNG streams: every device generator of the port (mxtpu's is its
    # key chain), numpy's global MT state (host paths: NDArrayIter
    # shuffle) and python's `random` (bucketed iterators)
    rng = _rnd.get_state()
    manifest["rng_torch"] = {"seed": int(rng["seed"]),
                             "devices": sorted(rng["generators"])}
    for dev, st in rng["generators"].items():
        arrays["rng:torch/%s" % dev] = st.numpy().copy()
    np_state = _np.random.get_state()
    arrays["rng:numpy"] = _np.array(np_state[1], dtype=_np.uint32)
    manifest["rng_numpy"] = {"algo": str(np_state[0]), "pos": int(np_state[2]),
                             "has_gauss": int(np_state[3]),
                             "cached_gaussian": float(np_state[4])}
    arrays["rng:python"] = _np.frombuffer(
        pickle.dumps(_pyrandom.getstate()), dtype=_np.uint8).copy()

    # --- optimizer step counters (lr schedules, Adam bias correction)
    opt = getattr(module, "_optimizer", None)
    if opt is not None:
        manifest["optimizer"] = {
            "type": type(opt).__name__,
            "num_update": int(opt.num_update),
            "index_update_count": {str(k): int(v) for k, v in
                                   opt._index_update_count.items()},
        }

    # --- metric accumulators (exact: integer counts + float sums)
    if isinstance(eval_metric, EvalMetric):
        manifest["metric"] = [
            {"name": m.name, "sum_metric": float(m.sum_metric),
             "num_inst": int(m.num_inst)}
            for m in _flatten_metrics(eval_metric)]

    # --- data-iterator position
    if iter_state is not None:
        scalars, it_arrays = _flatten_state_dict(iter_state)
        manifest["iterator"] = {"supported": True, "scalars": scalars,
                                "arrays": sorted(it_arrays)}
        for k, v in it_arrays.items():
            arrays["iter:%s" % k] = v
    else:
        manifest["iterator"] = {"supported": False}

    from ..compile import pipeline as _pipeline
    manifest["pipeline"] = list(_pipeline.configured())
    manifest["process"] = {"index": 0, "count": 1}
    return arrays, manifest, ready
