"""Training-health anomaly detectors over the device-resident stat
stream (:mod:`mxtpu_torch.obs.health`).

Counterpart of ``mxtpu/obs/detectors.py``: pure Python, verbatim in its
rules, so the same streams give the same findings in the same order.

Every detector here is **pure and deterministic**: state is explicit
(rolling windows, consecutive-cadence counters), inputs arrive as plain
floats per cadence, and nothing reads a clock or an RNG — the tier-1
units drive them with seeded synthetic streams and frozen windows and
assert *exactly which* cadence fires. Detections are 
:class:`~mxtpu_torch.analysis.findings.Finding`\\ s (``pass_name="health"``),
so they render, serialize and gate like every other analysis result in
the repo.

The four detectors cover the failure taxonomy the fused bf16/int8
training path actually has:

* **loss spike** — window loss exceeds the rolling median by
  ``spike_k`` MADs (robust to the noisy early-training regime a
  mean+stddev baseline false-positives on);
* **divergence** — nonfinite loss, any nonfinite grad/weight element,
  or loss beyond ``diverge_k``× the rolling median: the unrecoverable
  class, and the one :class:`HealthPolicy` may act on;
* **dead layer** — a parameter class's grad norm ≈ 0 for N consecutive
  cadences (broken stop-gradient, dead relu collapse, lr 0 by mistake);
* **exploding update ratio** — ‖Δw‖/‖w‖ above threshold: the step is
  rewriting the weights wholesale (lr too high) even while the loss
  still looks plausible.

"""
from __future__ import annotations

import os as _os

from ..analysis.findings import ERROR, WARNING, Finding

__all__ = ["HealthPolicy", "DetectorSuite", "LossSpikeDetector",
           "DivergenceDetector", "DeadLayerDetector",
           "ExplodingUpdateDetector"]


def _median(vals):
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def _finite(x):
    return x is not None and x == x and x not in (float("inf"),
                                                  float("-inf"))


class HealthPolicy:
    """What a confirmed divergence does. ``warn`` (default) emits the
    Finding / counter / flight event and moves on; ``rollback`` — armed
    by ``MXTPU_HEALTH_ACTION=rollback`` — additionally fires the
    watchdog's action seam (``diagnostics.fire_actions``), so an attached
    elastic ``Supervisor`` aborts the fit before it snapshots the
    diverged state and restores the last good generation."""

    ACTIONS = ("warn", "rollback")

    def __init__(self, action="warn"):
        action = str(action or "warn").lower()
        if action not in self.ACTIONS:
            import logging
            logging.getLogger(__name__).warning(
                "MXTPU_HEALTH_ACTION=%r not in %s; using 'warn'",
                action, "|".join(self.ACTIONS))
            action = "warn"
        self.action = action

    @classmethod
    def from_env(cls):
        return cls(_os.environ.get("MXTPU_HEALTH_ACTION", "warn"))


class LossSpikeDetector:
    """Window loss > rolling median + ``spike_k`` × MAD.

    The window must be FULL before anything can fire (no baseline, no
    verdict), and the MAD is floored at ``eps`` × max(1, |median|) so a
    perfectly flat loss stream (synthetic tests, converged tails) does
    not turn numerical dust into spikes. The tripping loss is NOT pushed
    into the window — one spike must not poison its own baseline."""

    kind = "loss_spike"

    def __init__(self, window=8, spike_k=8.0, eps=1e-8):
        self.window = max(2, int(window))
        self.spike_k = float(spike_k)
        self.eps = float(eps)
        self.losses = []

    def observe(self, loss, stats):
        if loss is None or not _finite(loss):
            return None   # divergence territory, not a spike
        fired = None
        if len(self.losses) >= self.window:
            med = _median(self.losses)
            mad = _median([abs(x - med) for x in self.losses])
            floor = self.eps * max(1.0, abs(med))
            thresh = med + self.spike_k * max(mad, floor)
            if loss > thresh:
                fired = Finding(
                    "health", WARNING,
                    "loss spike: window loss %.6g exceeds rolling "
                    "median %.6g + %.3gxMAD (threshold %.6g)"
                    % (loss, med, self.spike_k, thresh),
                    details={"kind": self.kind, "loss": loss,
                             "median": med, "mad": mad,
                             "threshold": thresh})
        if fired is None:
            self.losses.append(loss)
            if len(self.losses) > self.window:
                self.losses.pop(0)
        return fired


class DivergenceDetector:
    """Nonfinite anywhere, or loss > ``diverge_k`` × rolling median.

    Shares the spike detector's windowing discipline for the ratio arm
    (full window required); the nonfinite arms need no baseline — a NaN
    loss or a nonfinite grad/weight element is divergence on cadence
    one. Fires at most once per recovery (hysteresis): a wedged
    trajectory emits ONE divergence, not one per cadence until the
    supervisor reacts."""

    kind = "divergence"

    def __init__(self, window=8, diverge_k=1e3):
        self.window = max(2, int(window))
        self.diverge_k = float(diverge_k)
        self.losses = []
        self._tripped = False

    def observe(self, loss, stats):
        nonfinite = sum(int(s.get("nonfinite", 0) or 0)
                        for s in stats.values())
        reason = None
        details = {"kind": self.kind, "nonfinite": nonfinite}
        if nonfinite > 0:
            reason = ("%d nonfinite grad/weight element(s) in the fused "
                      "step" % nonfinite)
            bad = sorted(c for c, s in stats.items()
                         if s.get("nonfinite", 0))
            details["classes"] = bad[:8]
        elif loss is not None and not _finite(loss):
            reason = "window loss is nonfinite (%r)" % loss
            details["loss"] = str(loss)
        elif loss is not None and len(self.losses) >= self.window:
            med = _median(self.losses)
            if med > 0 and loss > self.diverge_k * med:
                reason = ("window loss %.6g is %.3gx the rolling median "
                          "%.6g (k=%.3g)" % (loss, loss / med, med,
                                             self.diverge_k))
                details.update({"loss": loss, "median": med})
        if reason is None:
            self._tripped = False
            if loss is not None and _finite(loss):
                self.losses.append(loss)
                if len(self.losses) > self.window:
                    self.losses.pop(0)
            return None
        if self._tripped:
            return None   # hysteresis: one Finding per excursion
        self._tripped = True
        return Finding("health", ERROR, "divergence: " + reason,
                       details=details)


class DeadLayerDetector:
    """A class's grad norm below ``eps`` for ``n_cadences`` consecutive
    cadences. Per-class hysteresis: fires once when the run-length
    crosses the threshold, re-arms only after the gradient comes back."""

    kind = "dead_layer"

    def __init__(self, n_cadences=4, eps=1e-12):
        self.n_cadences = max(1, int(n_cadences))
        self.eps = float(eps)
        self._runs = {}     # class -> consecutive dead cadences
        self._fired = set()

    def observe(self, loss, stats):
        fired = None
        for cls, s in stats.items():
            g = s.get("grad_norm")
            if g is not None and _finite(g) and g <= self.eps:
                self._runs[cls] = self._runs.get(cls, 0) + 1
                if self._runs[cls] >= self.n_cadences \
                        and cls not in self._fired:
                    self._fired.add(cls)
                    f = Finding(
                        "health", WARNING,
                        "dead layer: grad norm of %r <= %.3g for %d "
                        "consecutive cadences" % (cls, self.eps,
                                                  self._runs[cls]),
                        node=cls,
                        details={"kind": self.kind, "class": cls,
                                 "cadences": self._runs[cls]})
                    fired = f if fired is None else fired
            else:
                self._runs[cls] = 0
                self._fired.discard(cls)
        return fired


class ExplodingUpdateDetector:
    """‖Δw‖/‖w‖ above ``threshold`` for ``n_cadences`` CONSECUTIVE
    cadences: the optimizer is rewriting the weights wholesale, and not
    just transiently — a zero-initialized parameter's first updates
    have ‖w‖ ≈ ‖Δw‖ by construction (the ratio is meaningless at cold
    start), so a single-cadence excursion must not warn, and the
    cold-start TAIL (a bias sitting above threshold while ‖w‖ catches
    up) decays cadence over cadence, so only a holding-or-growing run
    accumulates. Per-class run-length + hysteresis like the dead-layer
    detector."""

    kind = "exploding_update"

    # a run only accumulates while the ratio holds or GROWS: a zero-init
    # parameter (bias, embedding row) can sit above the threshold for
    # many cadences while ‖w‖ catches up, but that tail decays ~1/t —
    # a genuine lr-too-high trajectory does not shrink cadence over
    # cadence. 2% slack tolerates window-sum rounding.
    DECAY_SLACK = 0.98

    def __init__(self, threshold=0.5, n_cadences=3):
        self.threshold = float(threshold)
        self.n_cadences = max(1, int(n_cadences))
        self._runs = {}     # class -> consecutive above-threshold cadences
        self._prev = {}     # class -> last cadence's ratio
        self._fired = set()

    def observe(self, loss, stats):
        fired = None
        for cls, s in stats.items():
            r = s.get("update_ratio")
            if r is not None and _finite(r) and r > self.threshold:
                prev = self._prev.get(cls)
                self._prev[cls] = r
                if prev is not None and r < prev * self.DECAY_SLACK:
                    self._runs[cls] = 1     # decaying cold-start tail
                    continue
                self._runs[cls] = self._runs.get(cls, 0) + 1
                if self._runs[cls] >= self.n_cadences \
                        and cls not in self._fired:
                    self._fired.add(cls)
                    f = Finding(
                        "health", WARNING,
                        "exploding update: |dw|/|w| of %r = %.4g exceeds "
                        "%.3g for %d consecutive cadences"
                        % (cls, r, self.threshold, self._runs[cls]),
                        node=cls,
                        details={"kind": self.kind, "class": cls,
                                 "update_ratio": r,
                                 "cadences": self._runs[cls]})
                    fired = f if fired is None else fired
            else:
                self._runs[cls] = 0
                self._prev.pop(cls, None)
                self._fired.discard(cls)
        return fired


class DetectorSuite:
    """The default detector stack over one cadence's (loss, per-class
    stats). ``observe`` returns the cadence's Findings, most severe
    first — the caller (HealthSession) owns counters, flight events,
    and the policy action."""

    def __init__(self, window=8, spike_k=8.0, diverge_k=1e3,
                 dead_cadences=4, dead_eps=1e-12, update_ratio_max=0.5):
        self.detectors = [
            DivergenceDetector(window=window, diverge_k=diverge_k),
            LossSpikeDetector(window=window, spike_k=spike_k),
            DeadLayerDetector(n_cadences=dead_cadences, eps=dead_eps),
            ExplodingUpdateDetector(threshold=update_ratio_max),
        ]

    def observe(self, loss, stats):
        """``loss``: the cadence window's mean loss (or None when the
        metric has no loss-like child); ``stats``: {class ->
        {grad_norm, weight_norm, update_ratio, grad_max, nonfinite}}."""
        findings = []
        for det in self.detectors:
            f = det.observe(loss, dict(stats))
            if f is not None:
                findings.append(f)
        findings.sort(key=lambda f: 0 if f.severity == ERROR else 1)
        return findings
