"""Exact fit-resume: restore a captured generation bit for bit.

Counterpart of ``mxtpu/elastic/state.py``. A snapshot is the train
state **after step N**: weights and optimizer state (the f32 masters
under ``MXTPU_PIPELINE=bf16``: the executors' arguments ARE the
masters), every RNG stream, the optimizer's per-index update counts (lr
schedules, Adam's bias correction), metric accumulators, and the
data-iterator position. ``Module.fit(resume=...)`` applies it after
bind/init, so the resumed process replays step N+1 onward with the
numbers the uninterrupted run would have produced: weights bit-exact,
integer-summed metrics exact (float metric sums may differ in summation
order only).

The optimizer state the plan keeps by rows restores **without
gathering**: each replica takes the saved row block of its own data
position (``FusedTrainStep.stage_opt_leaves``), assembling the global
leaf on the host only when the layout changed. A generation written by
mxtpu carries its JAX key, not the port's generator states: resuming
from one raises (the streams cannot be translated).
"""
from __future__ import annotations

import json
import logging
import os
import pickle
import time

import numpy as _np

from .. import telemetry as _tel
from ..base import MXNetError
from . import snapshot as _snap

log = logging.getLogger("mxtpu_torch.elastic")


# --------------------------------------------------------------- config
class ElasticConfig:
    """Knobs for elastic checkpointing in ``Module.fit``.

    * ``prefix``        — checkpoint path prefix (directory must exist);
    * ``every_n_steps`` — mid-epoch snapshot cadence in global steps
      (0 = epoch boundaries only; env ``MXTPU_ELASTIC_EVERY_STEPS``);
    * ``epoch_period``  — epoch-boundary snapshot period (0 disables;
      env ``MXTPU_ELASTIC_EPOCH_PERIOD``, default 1);
    * ``keep``          — generations retained (``MXTPU_ELASTIC_KEEP``, 2);
    * ``sync``          — block until each snapshot is durable (tests /
      tiny models; default False = fully async);
    * ``supervisor``    — a :class:`~mxtpu_torch.elastic.Supervisor` to
      poll for wedge/preemption interrupts between steps;
    * ``tuned``         — a :class:`~mxtpu_torch.tune.TunedConfig` (or
      path) the cadence knobs pull their defaults from, with the usual
      ``default < artifact < env < explicit argument`` precedence
      (``None`` = the process-active artifact, ``False`` = ignore it).
    """

    def __init__(self, prefix, every_n_steps=None, epoch_period=None,
                 keep=None, sync=False, supervisor=None, tuned=None):
        from .. import tune as _tune
        tuned = _tune.artifact(tuned)
        self.prefix = str(prefix)
        self.every_n_steps = _tune.resolve_int(
            "elastic.every_n_steps", explicit=every_n_steps,
            artifact=tuned)
        self.epoch_period = _tune.resolve_int(
            "elastic.epoch_period", explicit=epoch_period, artifact=tuned)
        self.keep = _tune.resolve_int("elastic.keep", explicit=keep,
                                      artifact=tuned)
        self.sync = bool(sync)
        self.supervisor = supervisor

    @classmethod
    def resolve(cls, spec):
        """Normalize a ``fit(elastic=...)`` argument: None defers to the
        ``MXTPU_ELASTIC`` env prefix (unset/empty = off), a string is a
        prefix, a dict is kwargs, a config passes through."""
        if spec is None:
            prefix = os.environ.get("MXTPU_ELASTIC", "").strip()
            return cls(prefix) if prefix else None
        if spec is False:
            return None
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, str):
            return cls(spec)
        if isinstance(spec, dict):
            return cls(**spec)
        raise MXNetError("fit(elastic=...): expected a prefix string, "
                         "dict, or ElasticConfig, got %r" % (spec,))


# --------------------------------------------------------------- resume
class ResumeState:
    """A loaded, verified generation ready to apply."""

    def __init__(self, manifest, arrays):
        self.manifest = manifest
        self.arrays = arrays
        cur = manifest.get("cursor") or {}
        self.epoch = int(cur.get("epoch", 0))
        self.nbatch = int(cur.get("nbatch", -1))
        self.global_step = int(cur.get("global_step", 0))
        self.epoch_boundary = bool(cur.get("epoch_boundary", False))
        self.generation = int(manifest.get("_generation", 0))

    @property
    def begin_epoch(self):
        return self.epoch + 1 if self.epoch_boundary else self.epoch

    @property
    def start_nbatch(self):
        """First batch index the resumed epoch should RUN (mid-epoch
        resume: batches 0..nbatch already trained)."""
        return 0 if self.epoch_boundary else self.nbatch + 1

    def param_dicts(self):
        """(arg, aux) as cpu() NDArrays over the loaded arrays."""
        import torch

        from ..context import cpu
        from ..ndarray import NDArray

        def nd(v):
            if isinstance(v, _np.ndarray):
                v = torch.from_numpy(_np.ascontiguousarray(v))
            return NDArray(v, cpu())
        arg = {k[4:]: nd(v) for k, v in self.arrays.items()
               if k.startswith("arg:")}
        aux = {k[4:]: nd(v) for k, v in self.arrays.items()
               if k.startswith("aux:")}
        return arg, aux

    def iterator_state(self):
        it = self.manifest.get("iterator") or {}
        if not it.get("supported"):
            return None
        arrays = {k[5:]: v for k, v in self.arrays.items()
                  if k.startswith("iter:")}
        return _snap._unflatten_state_dict(it.get("scalars") or {}, arrays)


def load_resume(spec):
    """Resolve a ``fit(resume=...)`` argument into a :class:`ResumeState`.

    ``spec``: a prefix (newest verified generation), a manifest path, or
    an :class:`ElasticConfig`. Returns None when no verified generation
    exists yet (a supervisor retry before the first snapshot starts
    fresh)."""
    if isinstance(spec, ElasticConfig):
        spec = spec.prefix
    manifest = None
    if isinstance(spec, str) and spec.endswith(".manifest.json") \
            and os.path.exists(spec):
        manifest = _snap._read_json(spec)
        if manifest is not None:
            manifest["_manifest_dir"] = os.path.dirname(spec) or "."
            if not _snap._manifest_intact(manifest,
                                          manifest["_manifest_dir"]):
                raise MXNetError("elastic resume: %s is torn/incomplete"
                                 % spec)
    elif isinstance(spec, str):
        manifest = _snap.latest_manifest(spec)
    else:
        raise MXNetError("fit(resume=...): expected a prefix/manifest "
                         "path, ElasticConfig, or True, got %r" % (spec,))
    if manifest is None:
        return None
    arrays = _snap.load_arrays(manifest)
    if "rng:key" in arrays and "rng_torch" not in manifest:
        raise MXNetError(
            "elastic resume: generation %s was written by mxtpu: its RNG "
            "stream is a JAX key, which the port's torch generators "
            "cannot continue bit for bit; load its arrays with "
            "elastic.load_arrays instead" % manifest.get("_generation"))
    return ResumeState(manifest, arrays)


class _Pieces:
    """A leaf kept by rows, as its saved pieces: ``rows(start, stop)``
    is a saved piece when one covers exactly those rows (the same
    layout), else those rows of the leaf assembled on the host."""

    def __init__(self, pieces, shape, dtype):
        self.pieces, self.shape, self.dtype = pieces, shape, dtype

    def rows(self, start, stop):
        stop = self.shape[0] if stop is None else stop
        for index, piece in self.pieces.items():
            if index[0] == (start, stop) and all(
                    index[d] == (0, self.shape[d])
                    for d in range(1, len(self.shape))):
                return _np.asarray(piece)
        return _assemble_global(self.pieces, self.shape,
                                self.dtype)[start:stop]


def _restore_opt_leaves(fused, entries, arrays):
    """Optimizer state back onto the live fused step: whole leaves and
    leaves kept by rows (their saved pieces) through
    :meth:`FusedTrainStep.stage_opt_leaves`."""
    for name in fused.trainable:
        entry = entries.get(name)
        if entry is None:
            log.warning("elastic resume: no optimizer state for %r — "
                        "keeping the fresh init", name)
            continue
        shards = entry.get("shards") or {}
        leaves = []
        for i in range(int(entry["leaves"])):
            meta = shards.get(str(i))
            if meta is None:
                leaves.append(arrays["opt:%s/%d" % (name, i)])
                continue
            pieces = {tuple(tuple(e) for e in p["index"]): arrays[p["key"]]
                      for p in meta["pieces"]}
            leaves.append(_Pieces(pieces, tuple(meta["global_shape"]),
                                  meta["dtype"]))
        fused.stage_opt_leaves(name, leaves)


def _assemble_global(pieces, shape, dtype):
    """Host-side reassembly of a leaf from its saved pieces (the
    changed-layout fallback)."""
    out = _np.zeros(shape, dtype=_np.dtype(dtype))
    for norm, piece in pieces.items():
        out[tuple(slice(a, b) for a, b in norm)] = _np.asarray(piece)
    return out


def apply_resume(module, state, eval_metric=None, train_data=None):
    """Apply a loaded generation to a bound, optimizer-initialized
    module (+ the live metric and iterator). Returns True when the
    iterator position was restored natively (False → the fit loop must
    replay-and-discard the first ``state.start_nbatch`` batches)."""
    import random as _pyrandom

    import torch

    from .. import random as _rnd
    from ..metric import EvalMetric, _flatten_metrics

    arg, aux = state.param_dicts()
    module.set_params(arg, aux, force_init=True, allow_missing=False)

    fused = getattr(module, "_fused", None)
    if state.manifest.get("opt_format") == "leaves" and fused is not None:
        _restore_opt_leaves(fused, state.manifest.get("opt_entries") or {},
                            state.arrays)
    elif state.manifest.get("opt_format") == "leaves":
        log.warning("elastic resume: snapshot holds fused opt-state "
                    "leaves but the fused step is not armed — optimizer "
                    "state NOT restored")
    elif "blob:updater" in state.arrays:
        blob = state.arrays["blob:updater"].tobytes()
        updater = getattr(module, "_updater", None)
        if updater is not None:
            updater.set_states(blob)
        elif getattr(module, "_update_on_kvstore", False) and \
                getattr(module._kvstore, "_updater", None) is not None:
            module._kvstore._updater.set_states(blob)

    opt_meta = state.manifest.get("optimizer")
    opt = getattr(module, "_optimizer", None)
    if opt is not None and opt_meta:
        opt.num_update = int(opt_meta.get("num_update", opt.num_update))
        opt._index_update_count = {
            int(k): int(v) for k, v in
            (opt_meta.get("index_update_count") or {}).items()}

    # RNG streams LAST (init_params/initializer above consumed draws)
    rng = state.manifest.get("rng_torch")
    if rng is not None:
        _rnd.set_state({"seed": int(rng["seed"]), "generators": {
            dev: torch.from_numpy(_np.ascontiguousarray(
                state.arrays["rng:torch/%s" % dev], dtype=_np.uint8))
            for dev in rng.get("devices") or ()}})
    np_meta = state.manifest.get("rng_numpy")
    if np_meta and "rng:numpy" in state.arrays:
        _np.random.set_state((np_meta.get("algo", "MT19937"),
                              _np.asarray(state.arrays["rng:numpy"],
                                          dtype=_np.uint32),
                              int(np_meta["pos"]),
                              int(np_meta["has_gauss"]),
                              float(np_meta["cached_gaussian"])))
    if "rng:python" in state.arrays:
        _pyrandom.setstate(pickle.loads(
            state.arrays["rng:python"].tobytes()))

    if isinstance(eval_metric, EvalMetric) and not state.epoch_boundary:
        saved = state.manifest.get("metric") or []
        children = _flatten_metrics(eval_metric)
        if len(saved) == len(children):
            for child, meta in zip(children, saved):
                child.sum_metric = float(meta["sum_metric"])
                child.num_inst = int(meta["num_inst"])
        elif saved:
            log.warning("elastic resume: metric shape changed (%d saved "
                        "vs %d live) — accumulators NOT restored",
                        len(saved), len(children))

    restored_iter = False
    if train_data is not None:
        # mid-epoch: the cursor inside the interrupted epoch. Epoch
        # boundary: the POST-reset state — a reshuffling iterator's
        # next-epoch schedule was drawn before the snapshot, and the
        # resumed epoch must replay it, not a fresh construction-time
        # shuffle.
        it_state = state.iterator_state()
        if it_state is not None:
            restored_iter = bool(train_data.restore_state(it_state))
    _tel.counter("elastic_restores",
                 help="generations applied by fit(resume=...)").inc()
    log.info("elastic: resumed generation %d (epoch %d, batch %d, "
             "step %d%s)", state.generation, state.epoch, state.nbatch,
             state.global_step,
             ", iterator cursor restored" if restored_iter else
             ", replaying epoch head" if not state.epoch_boundary else "")
    return restored_iter


# ---------------------------------------------------- sharded .states files
OPT_STATES_FORMAT = "mxtpu-opt-states-sharded-1"


def save_sharded_opt_states(fname, fused, async_write=False):
    """Optimizer ``.states`` under a plan that keeps state by rows: a JSON
    manifest at ``fname`` (specs + per-piece index map) plus an nd-format
    data file at ``fname + ".data"`` holding each row block as its
    replica holds it; nothing is gathered. Restore hands each replica
    its block (``stage_opt_leaves``)."""
    _p, _a, snap_o, ready = fused.export_host_state()
    arrays, entries = _snap.collect_opt_arrays(fused, snap_o)
    data_name = os.path.basename(fname) + ".data"
    manifest = {"format": OPT_STATES_FORMAT, "version": 1,
                "data_file": data_name, "entries": entries,
                "mesh": dict(fused._plan.mesh_ctx.axis_sizes)
                if fused._plan is not None else None,
                "process": {"index": 0, "count": 1}}
    w = _snap.writer()
    # FIFO writer: data lands (fsync+rename) strictly before the
    # manifest that names it — a crash in between leaves a manifest-less
    # data file, never a manifest pointing at nothing
    w.submit(_snap.SnapshotJob("ndsave", arrays, data_path=fname + ".data",
                               ready=ready,
                               label=os.path.basename(fname) + ".data"))
    w.submit(_snap.SnapshotJob(
        "bytes", {}, data_path=fname,
        assemble=lambda host, _m=manifest: json.dumps(
            _m, indent=1, default=str).encode(),
        label=os.path.basename(fname)))
    if not async_write:
        w.flush()


def async_save_opt_states_pickle(fname, fused):
    """The ``.states`` pickle written asynchronously: the capture on the
    caller (clones + the copy to pinned memory started), the pickle in
    the Updater's ``{index: numpy state}`` scheme (``export_opt_state``'s,
    which both packages load) assembled on the writer — the training
    thread never waits for the transfer."""
    from ..module.fused import state_leaves, unflatten_state
    _p, _a, snap_o, ready = fused.export_host_state()
    arrays, entries = _snap.collect_opt_arrays(fused, snap_o)
    templates = {n: fused.opt_state[0][n] for n in fused.trainable}
    name_indices = {}
    for idx, n in fused.optimizer.idx2name.items():
        if n in templates:
            name_indices.setdefault(n, []).append(idx)

    def assemble(host):
        out = {}
        for n, tmpl in templates.items():
            shards = entries[n].get("shards") or {}
            leaves = []
            for i in range(len(state_leaves(tmpl))):
                meta = shards.get(str(i))
                if meta is None:
                    leaves.append(_np.asarray(host["opt:%s/%d" % (n, i)]))
                    continue
                leaves.append(_assemble_global(
                    {tuple(tuple(e) for e in p["index"]): host[p["key"]]
                     for p in meta["pieces"]},
                    tuple(meta["global_shape"]), meta["dtype"]))
            tree = unflatten_state(tmpl, leaves)
            for idx in name_indices.get(n, []):
                out[idx] = tree
        return pickle.dumps(out)

    _snap.writer().submit(_snap.SnapshotJob(
        "bytes", arrays, data_path=fname, assemble=assemble, ready=ready,
        label=os.path.basename(fname)))


def load_sharded_opt_states(fname, fused):
    """Restore a :func:`save_sharded_opt_states` manifest onto the live
    fused step, each replica its row block."""
    _snap.writer().flush()
    with open(fname) as f:
        manifest = json.load(f)
    if manifest.get("format") != OPT_STATES_FORMAT:
        raise MXNetError("%s: not a %s manifest" % (fname,
                                                    OPT_STATES_FORMAT))
    from .. import ndarray as nd
    data_path = os.path.join(os.path.dirname(fname) or ".",
                             manifest["data_file"])
    arrays = {k: v._data.numpy() for k, v in nd.load(data_path).items()}
    _restore_opt_leaves(fused, manifest.get("entries") or {}, arrays)


# --------------------------------------------------------------- session
class ElasticSession:
    """The fit-loop hook: owns the generation counter, decides when a
    step triggers a snapshot, and turns supervisor flags (wedge
    detection, SIGTERM preemption) into in-loop interrupts. One per
    ``fit`` call; created by ``BaseModule.fit`` when ``elastic=`` (or
    ``MXTPU_ELASTIC``) is armed."""

    def __init__(self, module, cfg, logger=None, resume_state=None):
        self.module = module
        self.cfg = cfg
        self.logger = logger or log
        gens = _snap.list_generations(cfg.prefix)
        self.generation = (gens[-1] + 1) if gens else 1
        self.global_step = resume_state.global_step \
            if resume_state is not None else 0
        self._it_state = None
        self._epoch = 0
        self._nbatch = -1

    # ------------------------------------------------------------ hooks
    def pre_lookahead(self, train_data, epoch, nbatch):
        """Called right after ``update()`` and BEFORE the fit loop's
        lookahead ``next()`` — the only point where the iterator cursor
        still reads 'batches 0..nbatch consumed'. Cheap: a couple of
        ints and array references — and skipped entirely when no
        mid-epoch snapshot can ever consume it (epoch-only cadence with
        no supervisor)."""
        self._epoch = epoch
        self._nbatch = nbatch
        if not self.cfg.every_n_steps and self.cfg.supervisor is None:
            self._it_state = None
            return
        self._it_state = _checkpoint_state(train_data)

    def on_step(self, eval_metric, accum, train_data):
        """After the step's metrics accumulated, before batch callbacks.
        Raises Preempted/WedgeAbort on supervisor interrupts; takes the
        cadence snapshot."""
        self.global_step += 1
        sup = self.cfg.supervisor
        if sup is not None:
            from .supervisor import Preempted, WedgeAbort
            if sup.preempted():
                # the handler only set a flag (async-signal-safe); the
                # counter and log belong here, on a normal thread
                _tel.counter("elastic_preemptions",
                             help="SIGTERM preemption warnings received"
                             ).inc()
                self.logger.warning(
                    "elastic: SIGTERM preemption warning — flushing a "
                    "final snapshot")
                # the warning is CONSUMED here — if the process survives
                # (reclaim canceled), the next fit must not die on the
                # stale flag
                self.snapshot(eval_metric, accum, final=True)
                sup.clear_preemption()
                raise Preempted("SIGTERM preemption warning: final "
                                "snapshot g%06d flushed"
                                % (self.generation - 1))
            reason = sup.wedge_reason()
            if reason is not None:
                # no snapshot: the wedge postmortem already fired and
                # the wedged state is suspect — retry resumes from the
                # last GOOD generation
                raise WedgeAbort(reason)
        if self.cfg.every_n_steps and \
                self.global_step % self.cfg.every_n_steps == 0:
            self.snapshot(eval_metric, accum)

    def on_epoch(self, epoch, eval_metric, train_data):
        """After ``train_data.reset()`` at the epoch boundary. The
        iterator state is captured POST-reset: a reshuffling iterator
        (BucketSentenceIter) has already drawn the next epoch's
        schedule, and a boundary resume must replay THAT schedule."""
        self._epoch = epoch
        self._nbatch = -1
        self._it_state = _checkpoint_state(train_data)
        if self.cfg.epoch_period and \
                (epoch + 1) % self.cfg.epoch_period == 0:
            self.snapshot(eval_metric, None, epoch_boundary=True)
        self._it_state = None

    # ------------------------------------------------------------ capture
    def snapshot(self, eval_metric=None, accum=None, epoch_boundary=False,
                 final=False):
        """Capture + enqueue one generation. The training thread pays
        only the device-side clones, the enqueued copy to the host and
        (at most) one cadence metric sync; serialization and IO happen
        on the writer thread."""
        t0 = time.perf_counter()
        if accum is not None:
            accum.sync()  # fold device sums so the manifest is complete
        cursor = {"epoch": self._epoch, "nbatch": self._nbatch,
                  "global_step": self.global_step,
                  "epoch_boundary": bool(epoch_boundary)}
        arrays, manifest, ready = _snap.capture_module(
            self.module, cursor, eval_metric=eval_metric,
            iter_state=self._it_state)
        gen = self.generation
        self.generation += 1
        job = _snap.SnapshotJob(
            "generation", arrays, prefix=self.cfg.prefix, generation=gen,
            manifest=manifest, keep=self.cfg.keep,
            coalescable=not final and not self.cfg.sync,
            label="g%06d" % gen, ready=ready)
        _snap.writer().submit(job)
        kind = "final" if final else \
            "epoch" if epoch_boundary else "step"
        _tel.counter("elastic_snapshots", labels={"kind": kind},
                     help="snapshot generations captured").inc()
        if final or self.cfg.sync:
            _snap.writer().flush()
        _tel.histogram(
            "elastic_snapshot_stall_ms",
            help="training-thread cost of a snapshot capture (device "
                 "clones + enqueue; excludes the async write)"
            ).observe((time.perf_counter() - t0) * 1e3)
        return gen


def _checkpoint_state(train_data):
    """The iterator's cursor, or None where it has none or fails to say."""
    try:
        return train_data.checkpoint_state()
    except Exception:
        # mxtpu: allow-swallow(an iterator that cannot name its position
        # resumes by replaying the epoch head, as mxtpu's does)
        return None
