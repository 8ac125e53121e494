"""Device-resident training-health statistics over the fused step.

Counterpart of ``mxtpu/obs/health.py``. Per parameter class (the
``fuse_opt`` update classes, and each ungrouped trainable on its own),
the fused step computes on the device, after its update:

  * grad L2 norm                  (vanishing/exploding gradients)
  * weight L2 norm                (weight blow-up)
  * update ratio ‖Δw‖/‖w‖         (lr too high/low)
  * grad max-abs                  (bf16 overflow precursor)
  * nonfinite element count       (grads AND fresh weights — an LR bomb
                                   is caught on the step that fired it)

as an f32 (C, 4) sum matrix [grad_sq, weight_sq, update_sq, nonfinite]
and a (C,) grad max-abs vector (``FusedTrainStep.arm_health``). They are
folded on the device every step (:class:`HealthAccum`) and reach the
host only at the existing metric-sync cadence: the session is a *rider*
on the fit loop's :class:`~mxtpu_torch.metric.DeviceMetricAccum`, whose
``sync()`` copies the metric sums and every rider's tensors in ONE
``.cpu()`` transfer — health adds zero host round trips.

On the host side of each cadence the deterministic
:class:`~mxtpu_torch.obs.detectors.DetectorSuite` turns the stats and the
metric's window loss into Findings, ``health_anomalies{kind}`` counters,
flight events and a postmortem on divergence. ``MXTPU_HEALTH_ACTION=
rollback`` also fires the watchdog's action seam: an elastic
``Supervisor`` aborts the fit before it snapshots the diverged state and
retries from the last good generation (``elastic/``).

Arm with ``Module.fit(health=True)`` or ``MXTPU_HEALTH=1``; tune via
``health.cadence`` / ``health.window`` / ``health.spike_k``. Surfaces:
``train_health{layer_class,stat}`` gauges, the ``training_health`` block
of ``/debug/state``, corpus ``health`` rows.
"""
from __future__ import annotations

import logging
import os

from .. import telemetry as _tel
from ..analysis import concurrency as _conc
from .detectors import DetectorSuite, HealthPolicy

__all__ = ["HealthAccum", "HealthSession", "HealthPolicy",
           "DetectorSuite", "class_label", "armed_by_env", "panel",
           "STATS", "SUM_COLS", "tree_to_host"]

log = logging.getLogger("mxtpu_torch.obs.health")

#: the stat columns of one class row, in device layout order
SUM_COLS = ("grad_sq", "weight_sq", "update_sq", "nonfinite")
#: the derived per-cadence stats the gauges/panel/corpus expose
STATS = ("grad_norm", "weight_norm", "update_ratio", "grad_max",
         "nonfinite")

_PANEL_LOCK = _conc.lock("health", "_PANEL_LOCK")
_ACTIVE = None        # the live fit's HealthSession
_LAST_PANEL = None    # the closed fit's final panel (postmortem reads)


def armed_by_env():
    """True when ``MXTPU_HEALTH`` requests the health stats."""
    v = os.environ.get("MXTPU_HEALTH", "").strip().lower()
    return v not in ("", "0", "false", "no", "off")


def class_label(names):
    """Stable display label for a parameter class: the members' common
    prefix when they share one (``fc*[3]``), else the (single) name."""
    names = list(names)
    if len(names) == 1:
        return names[0]
    prefix = os.path.commonprefix(names).rstrip("_.:")
    return "%s*[%d]" % (prefix or names[0], len(names))


def panel():
    """The ``training_health`` block for ``diagnostics.debug_state()``:
    the live session's snapshot, or the most recently closed fit's final
    panel (marked ``armed: False``). None when health never armed."""
    s = _ACTIVE
    if s is None:
        return _LAST_PANEL
    return s.panel_snapshot()


def _leaves(tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    else:
        out.append(tree)
    return out


def _rebuild(tree, it):
    import numpy as np
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    flat = next(it)
    return np.asarray(flat, dtype=np.float32).reshape(tuple(tree.shape))


def flatten_tree(tree):
    """(one float64 vector of every tensor of a rider tree, rebuild): the
    vector joins a transfer, and ``rebuild(host_vector)`` gives the tree
    back as f32 numpy arrays (f32 -> f64 -> f32 is exact)."""
    import torch
    leaves = _leaves(tree, [])
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64)
                      for t in leaves]) if leaves else None
    sizes = [t.numel() for t in leaves]

    def rebuild(host):
        parts, o = [], 0
        for n in sizes:
            parts.append(host[o:o + n])
            o += n
        return _rebuild(tree, iter(parts))
    return flat, rebuild


def tree_to_host(tree):
    """A rider tree on the host in ONE ``.cpu()`` transfer."""
    flat, rebuild = flatten_tree(tree)
    return rebuild(flat.cpu().numpy() if flat is not None else [])


class HealthAccum:
    """Device-resident accumulator over the fused step's per-class stat
    rows — the health twin of :class:`~mxtpu_torch.metric.
    DeviceMetricAccum`. ``update`` folds one step's (C,4) sums / (C,)
    maxes on the device (nothing transferred); ``pull`` hands the device
    tree to whoever owns the cadence's ONE host round trip."""

    def __init__(self, n_classes):
        self.n_classes = int(n_classes)
        self._sums = None   # device (C, 4) after the first step
        self._max = None    # device (C,)
        self._taps = None   # latest sampled step's monitor taps (device)
        self._steps = 0

    def update(self, hstats):
        """Fold one fused step's stat rows in (device-only)."""
        import torch
        sums, mx = hstats.get("sums"), hstats.get("max")
        if sums is not None:
            if self._sums is None:
                self._sums, self._max = sums, mx
            else:
                self._sums = self._sums + sums
                self._max = torch.maximum(self._max, mx)
            self._steps += 1
        self._taps = hstats.get("taps", self._taps)

    def pull(self):
        """The pending device tree for the cadence's bulk host read, or
        None when nothing accumulated."""
        if self._steps == 0 and self._taps is None:
            return None
        tree = {}
        if self._steps:
            tree["sums"], tree["max"] = self._sums, self._max
        if self._taps is not None:
            tree["taps"] = self._taps
        return tree

    def finish(self):
        """Close the window after its host values landed: returns the
        step count and zeroes the device state."""
        steps = self._steps
        self._sums = self._max = self._taps = None
        self._steps = 0
        return steps


# loss-like metric children: the detector baselines need a loss, not an
# accuracy — a metric with no loss-like child runs the nonfinite/stat
# detectors only
_LOSSY = ("entropy", "loss", "mse", "mae", "rmse", "perplex",
          "likelihood")


class HealthSession:
    """One fit's health pipeline: arms the fused step's stat rows,
    accumulates per step, rides the metric-sync cadence, runs the
    detector suite, and owns every surface (gauges, flight, corpus,
    panel, postmortem)."""

    def __init__(self, fused, monitor=None, detect=True, logger=None):
        from ..tune import registry as _knobs
        self.policy = HealthPolicy.from_env()
        self.fused = fused
        self.monitor = monitor
        self.detect = bool(detect)
        self.logger = logger or log
        taps = monitor.re_prog.pattern if monitor is not None else None
        self.classes = fused.arm_health(
            taps=taps, tap_active=(lambda: monitor.activated)
            if monitor is not None else None)
        self.labels = [lbl for lbl, _ in self.classes]
        self.accum = HealthAccum(len(self.labels))
        self.window = _knobs.resolve_int("health.window", floor=2)
        self.spike_k = float(_knobs.resolve("health.spike_k"))
        self.cadence = _knobs.resolve_int("health.cadence", floor=1)
        self.suite = DetectorSuite(window=self.window,
                                   spike_k=self.spike_k)
        self.cadences = 0
        self.detections = 0
        self.findings = []
        self._delivered = None
        self._loss_prev = None
        self._last = {}
        self._last_steps = None
        self._last_loss = None
        self._panel = None
        self._san_trips = self._sanitizer_trips()
        global _ACTIVE
        _ACTIVE = self

    def close(self):
        global _ACTIVE, _LAST_PANEL
        if _ACTIVE is self:
            _ACTIVE = None
        with _PANEL_LOCK:
            if self._panel:
                _LAST_PANEL = dict(self._panel, armed=False)

    # ------------------------------------------------------- per step
    def on_step(self):
        """Fold the step the module just ran (device-only)."""
        h = self.fused.last_health
        if h is not None:
            self.accum.update(h)
            self.fused.last_health = None   # never double-count a step

    # ------------------------------------------------- cadence plumbing
    # rider protocol (DeviceMetricAccum.add_rider): pull() hands the
    # device tree into the accum's ONE cadence transfer; deliver()
    # receives the host values from that same transfer
    def pull(self):
        return self.accum.pull()

    def deliver(self, host_tree):
        self._delivered = (host_tree, self.accum.finish())

    def sync_direct(self):
        """The cadence pull when no DeviceMetricAccum exists to ride
        (``device_metrics=False``): health owns the cadence's single
        round trip itself."""
        tree = self.pull()
        if tree is None:
            return
        self.deliver(tree_to_host(tree))

    # ---------------------------------------------------- the cadence
    def on_cadence(self, eval_metric=None):
        """Consume the delivered window: derive stats, emit gauges, run
        detectors at the ``health.cadence`` stride, act."""
        if self._delivered is None:
            return None
        host, steps = self._delivered
        self._delivered = None
        self.cadences += 1
        taps = host.get("taps")
        if taps is not None and self.monitor is not None:
            self.monitor._deliver_taps(taps)
        if steps <= 0:
            return None
        self._last_steps = steps
        stats = self._derive(host, steps)
        self._emit_gauges(stats)
        self._last = stats
        loss = self._window_loss(eval_metric)
        findings = []
        if self.detect and self.cadences % self.cadence == 0:
            findings = self.suite.observe(loss, stats)
            for f in findings:
                self._surface(f)
        from . import corpus as _corpus
        if _corpus.enabled():
            _corpus.record_health(
                self.cadences, stats, loss=loss,
                anomalies=[f.details.get("kind")
                           for f in findings] or None)
        div = [f for f in findings
               if f.details.get("kind") == "divergence"]
        if div:
            self._act(div[0])
        self._san_trips = self._sanitizer_trips()
        self._refresh_panel(stats, loss)
        return findings

    # ------------------------------------------------------- internals
    def _derive(self, host, steps):
        import numpy as np
        sums = np.asarray(host["sums"], dtype=np.float32)
        gmax = np.asarray(host["max"], dtype=np.float32)
        stats = {}
        inv = 1.0 / float(steps)
        for i, label in enumerate(self.labels):
            g2, w2, u2, nf = (float(sums[i, 0]), float(sums[i, 1]),
                              float(sums[i, 2]), float(sums[i, 3]))
            stats[label] = {
                "grad_norm": float(np.sqrt(max(0.0, g2 * inv))),
                "weight_norm": float(np.sqrt(max(0.0, w2 * inv))),
                # ratio of window sums == ratio of window means
                "update_ratio": float(np.sqrt(u2 / w2)) if w2 > 0
                else 0.0,
                "grad_max": float(gmax[i]),
                "nonfinite": int(nf),
            }
        return stats

    def _emit_gauges(self, stats):
        for label, s in stats.items():
            for stat in STATS:
                try:
                    _tel.gauge(
                        "train_health",
                        labels={"layer_class": label, "stat": stat},
                        help="per-parameter-class training-health stat "
                             "as of the latest metric-sync cadence "
                             "(obs/health.py)").set(float(s[stat]))
                except (TypeError, ValueError):
                    continue

    def _window_loss(self, eval_metric):
        """Mean loss over the cadence window from the metric's own sums
        (exact deltas of (sum_metric, num_inst)). None when the metric
        has no loss-like child or the window is empty."""
        child = self._loss_child(eval_metric)
        if child is None:
            self._last_loss = None
            return None
        cur = (float(child.sum_metric), int(child.num_inst))
        prev = self._loss_prev
        self._loss_prev = cur
        if prev is None or cur[1] <= prev[1]:
            return None   # first window, or an epoch reset in between
        loss = (cur[0] - prev[0]) / float(cur[1] - prev[1])
        self._last_loss = loss
        return loss

    def _loss_child(self, eval_metric):
        if eval_metric is None:
            return None
        from ..metric import _flatten_metrics
        for c in _flatten_metrics(eval_metric):
            name = str(getattr(c, "name", "")).lower()
            if any(t in name for t in _LOSSY):
                return c
        return None

    def _surface(self, finding):
        kind = finding.details.get("kind", "unknown")
        self.detections += 1
        _tel.counter(
            "health_anomalies", labels={"kind": kind},
            help="training-health detector firings by anomaly kind "
                 "(obs/detectors.py)").inc()
        from .. import diagnostics as _diag
        _diag.record("health", kind, finding.message)
        self.logger.warning("training health: %s", finding.message)
        self.findings.append(finding)
        del self.findings[:-16]

    def _sanitizer_trips(self):
        from ..analysis import sanitizer as _san
        return _san.trip_count()

    def _act(self, finding):
        """The divergence action: a postmortem (unless the sanitizer
        already captured one for the same nonfinite this window), then
        the rollback seam if armed (mxtpu :372-390): the supervisor's
        watchdog action flags a wedge, and the fit aborts at this step's
        ``ElasticSession.on_step``, before its snapshot."""
        from .. import diagnostics as _diag
        if self._sanitizer_trips() == self._san_trips:
            _diag.postmortem("health: %s" % finding.message,
                             source="health")
        else:
            self.logger.info(
                "training health: sanitizer already captured this "
                "window's nonfinite — skipping the duplicate postmortem")
        if self.policy.action == "rollback":
            reason = "health divergence: %s" % finding.message
            self.logger.warning(
                "training health: rollback armed — firing the "
                "supervisor action seam (%s)", reason)
            _diag.fire_actions(reason)

    def _refresh_panel(self, stats, loss):
        anomalies = {}
        for f in self.findings:
            k = f.details.get("kind", "unknown")
            anomalies[k] = anomalies.get(k, 0) + 1
        snap = {
            "armed": True,
            "detect": self.detect,
            "action": self.policy.action,
            "cadences": self.cadences,
            "steps_per_cadence": self._last_steps,
            "window_loss": loss,
            "classes": [dict(stats[lbl], **{"class": lbl})
                        for lbl in self.labels if lbl in stats],
            "anomalies": anomalies,
            "recent": [f.message for f in self.findings[-4:]],
        }
        with _PANEL_LOCK:
            self._panel = snap

    def panel_snapshot(self):
        with _PANEL_LOCK:
            return dict(self._panel) if self._panel else {
                "armed": True, "detect": self.detect,
                "action": self.policy.action, "cadences": 0,
                "classes": [], "anomalies": {}, "recent": []}
