"""Evaluation metrics (parity: python/mxnet/metric.py).

Counterpart of ``mxtpu/metric.py``: ``EvalMetric``, ``Accuracy``,
``TopKAccuracy``, ``F1``, ``Perplexity``, ``MAE``, ``MSE``, ``RMSE``,
``CrossEntropy``, ``PearsonCorrelation``, ``Loss`` (with ``Torch`` and
``Caffe``), ``CustomMetric`` and ``np``, ``CompositeEvalMetric``,
``create``/``register``, and ``DeviceMetricAccum`` (:471-600), which
keeps a fit's partial sums on the device. A per-batch ``asnumpy()`` of
the LM's output (B*T x vocab f32, 823 MB at B = 4, T = 1024) would make
the device->host copy most of a training step; the accumulator instead
folds each batch into one f32 scalar per metric with torch ops queued on
the device, and ``sync`` brings all of them to the host in one copy at
the fit's metric-sync cadence. Instance counts are shape arithmetic,
kept on the host as exact integers.
"""
from __future__ import annotations

import math

import numpy as _np
import torch

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "F1", "CrossEntropy",
           "Perplexity", "MAE", "MSE", "RMSE", "PearsonCorrelation", "Loss",
           "Torch", "Caffe", "CustomMetric", "np",
           "CompositeEvalMetric", "DeviceKernel", "DeviceMetricAccum",
           "create", "register", "check_label_shapes"]

_REG = {}
_ALIASES = {"Accuracy": ("acc",),
            "TopKAccuracy": ("top_k_acc", "top_k_accuracy"),
            "CrossEntropy": ("ce", "cross-entropy"),
            "PearsonCorrelation": ("pearsonr",),
            "CompositeEvalMetric": ("composite",),
            "CustomMetric": ("custom",)}


def check_label_shapes(labels, preds, shape=0):
    if shape == 0:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError("Shape of labels %s does not match shape of "
                         "predictions %s" % (label_shape, pred_shape))


def _host(x):
    return x.asnumpy() if isinstance(x, NDArray) else _np.asarray(x)


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = name
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def device_kernel(self):
        """A ``DeviceKernel`` computing this metric's per-batch partial
        sum in torch ops on the device, or None (numpy path only)."""
        return None

    def update_dict(self, label, pred):
        """``update`` with the outputs and labels given by name, those of
        ``output_names``/``label_names`` when set."""
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names if name in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names
                     if name in label]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))


def register(klass):
    _REG[klass.__name__.lower()] = klass
    for alias in _ALIASES.get(klass.__name__, ()):
        _REG[alias] = klass
    return klass


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """A ``CustomMetric`` over ``numpy_feval(label, pred)`` on numpy
    arrays."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = name or numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


def create(metric, *args, **kwargs):
    """A metric by name or alias, a list of them (a composite), an
    EvalMetric as is, or a ``feval(label, pred)`` as a CustomMetric."""
    if callable(metric) and not isinstance(metric, EvalMetric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    klass = _REG.get(str(metric).lower())
    if klass is None:
        raise MXNetError("unknown metric %r (have %s)" % (metric,
                                                         sorted(_REG)))
    return klass(*args, **kwargs)


@register
class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()
        super().reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            if isinstance(name, str):
                name = [name]
            if isinstance(value, (float, int)):
                value = [value]
            names.extend(name)
            values.extend(value)
        return (names, values)


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.axis = axis

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            pred, lab = _host(pred_label), _host(label)
            if pred.shape != lab.shape:
                pred = _np.argmax(pred, axis=self.axis)
            pred = pred.astype("int32").flatten()
            lab = lab.astype("int32").flatten()
            check_label_shapes(lab, pred, shape=1)
            self.sum_metric += float((pred == lab).sum())
            self.num_inst += len(pred)

    def device_kernel(self):
        axis = self.axis

        def sum_fn(label, pred):
            if pred.shape != label.shape:
                pred = torch.argmax(pred, dim=axis)
            pred = pred.to(torch.int32).reshape(-1)
            lab = label.to(torch.int32).reshape(-1)
            return (pred == lab).sum().to(torch.float32)

        return DeviceKernel(sum_fn, lambda label, pred: label.numel(),
                            key=("Accuracy", axis))


@register
class TopKAccuracy(EvalMetric):
    """The share of samples whose label is among the ``top_k`` highest
    scores (parity metric.py TopKAccuracy). Ties rank as numpy's and
    torch's stable ascending sorts rank them: the later index higher."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.top_k = top_k
        assert self.top_k > 1, "Please use Accuracy if top_k is no more than 1"
        self.name += "_%d" % self.top_k

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            pred = _np.argsort(_host(pred_label).astype("float32"), axis=1,
                               kind="stable")
            lab = _host(label).astype("int32").flatten()
            num_samples, num_classes = pred.shape[:2]
            for j in range(min(num_classes, self.top_k)):
                self.sum_metric += float(
                    (pred[:, num_classes - 1 - j].flatten() == lab).sum())
            self.num_inst += num_samples

    def device_kernel(self):
        want_k = self.top_k

        def sum_fn(label, pred):
            order = torch.argsort(pred.to(torch.float32), dim=1,
                                  stable=True)
            lab = label.to(torch.int32).reshape(-1)
            num_classes = pred.shape[1]
            k = min(num_classes, want_k)
            top = order[:, num_classes - k:].to(torch.int32)
            return (top == lab[:, None]).sum().to(torch.float32)

        return DeviceKernel(sum_fn, lambda label, pred: int(pred.shape[0]),
                            key=("TopKAccuracy", want_k))


@register
class F1(EvalMetric):
    """F1 of a binary classifier, averaged over batches."""

    def __init__(self, name="f1", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred_label = _np.argmax(_host(pred), axis=1)
            label = _host(label).astype("int32")
            check_label_shapes(label, pred_label)
            if len(_np.unique(label)) > 2:
                raise ValueError("F1 currently only supports binary "
                                 "classification.")
            tp = fp = fn = 0.0
            for y_pred, y_true in zip(pred_label, label):
                if y_pred == 1 and y_true == 1:
                    tp += 1.0
                elif y_pred == 1 and y_true == 0:
                    fp += 1.0
                elif y_pred == 0 and y_true == 1:
                    fn += 1.0
            precision = tp / (tp + fp) if tp + fp > 0 else 0.0
            recall = tp / (tp + fn) if tp + fn > 0 else 0.0
            if precision + recall > 0:
                self.sum_metric += 2 * precision * recall / (precision +
                                                             recall)
            self.num_inst += 1


def _column(label):
    """A 1-D label as a column, against (n, k) predictions."""
    return label.reshape(label.shape[0], 1) if len(label.shape) == 1 \
        else label


class _Regression(EvalMetric):
    """A per-batch mean of ``err(label - pred)``, averaged over batches
    (MAE, MSE, RMSE); ``device_err`` is the same on tensors. ``err`` and
    ``device_err`` are the subclass's."""

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            self.sum_metric += float(self.err(_column(_host(label)) -
                                              _host(pred)))
            self.num_inst += 1

    def device_kernel(self):
        err = self.device_err

        def sum_fn(label, pred):
            return err(_column(label) - pred).to(torch.float32)

        return DeviceKernel(sum_fn, lambda label, pred: 1,
                            key=(type(self).__name__,))


@register
class MAE(_Regression):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    @staticmethod
    def err(diff):
        return _np.abs(diff).mean()

    @staticmethod
    def device_err(diff):
        return torch.mean(torch.abs(diff))


@register
class MSE(_Regression):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    @staticmethod
    def err(diff):
        return (diff ** 2.0).mean()

    @staticmethod
    def device_err(diff):
        return torch.mean(torch.square(diff))


@register
class RMSE(_Regression):
    """The mean over batches of each batch's root mean square error (not
    one root of the whole set's mean), as mxtpu and the reference."""

    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    @staticmethod
    def err(diff):
        return _np.sqrt((diff ** 2.0).mean())

    @staticmethod
    def device_err(diff):
        return torch.sqrt(torch.mean(torch.square(diff)))


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            self.sum_metric += float(_np.corrcoef(
                _host(pred).ravel(), _host(label).ravel())[0, 1])
            self.num_inst += 1


@register
class Loss(EvalMetric):
    """The mean of the outputs themselves (a loss head's); labels are not
    read."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        for pred in preds:
            self.sum_metric += float(_host(pred).sum())
            self.num_inst += int(_np.prod(pred.shape))

    def device_kernel(self):
        return DeviceKernel(lambda label, pred: torch.sum(pred).to(
            torch.float32), lambda label, pred: pred.numel(),
            needs_label=False, key=("Loss",))


@register
class Torch(Loss):
    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Loss):
    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    """A metric from ``feval(label, pred)`` on numpy arrays, returning a
    value (one instance) or a (sum, count) pair."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name, output_names, label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            reval = self._feval(_host(label), _host(pred))
            if isinstance(reval, tuple):
                (sum_metric, num_inst) = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


@register
class Perplexity(EvalMetric):
    def __init__(self, ignore_label, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        assert len(labels) == len(preds)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            probs = _host(pred)
            lab = _host(label).astype("int32").reshape(-1)
            probs = probs.reshape(-1, probs.shape[-1])
            picked = probs[_np.arange(lab.shape[0]), lab]
            if self.ignore_label is not None:
                ignore = (lab == self.ignore_label)
                num -= int(ignore.sum())
                picked = _np.where(ignore, 1.0, picked)
            loss -= float(_np.sum(_np.log(_np.maximum(1e-10, picked))))
            num += lab.shape[0]
        self.sum_metric += loss
        self.num_inst += max(1, num)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _host(label).ravel(), _host(pred)
            assert label.shape[0] == pred.shape[0]
            prob = pred[_np.arange(label.shape[0]), _np.int64(label)]
            self.sum_metric += float((-_np.log(prob + self.eps)).sum())
            self.num_inst += label.shape[0]

    def device_kernel(self):
        eps = self.eps

        def sum_fn(label, pred):
            lab = label.reshape(-1).to(torch.int64)
            prob = pred.gather(1, lab[:, None])[:, 0].to(torch.float32)
            return torch.sum(-torch.log(prob + eps))

        return DeviceKernel(sum_fn, lambda label, pred: label.numel(),
                            key=("CrossEntropy", eps))


class DeviceKernel:
    """One metric's device recipe: ``sum_fn(label, pred)`` returns the
    batch's partial sum as a 0-d f32 tensor on the pred's device (queued,
    not waited for); ``count_fn(label, pred)`` the matching instance
    count, from shapes, on the host. A metric that reads no labels
    (``Loss``) sets ``needs_label=False`` and gets None for them.
    ``key`` names the recipe (mxtpu's, metric.py:471-491): accumulators
    whose kernels all have keys share one built program process-wide."""

    __slots__ = ("sum_fn", "count_fn", "needs_label", "key")

    def __init__(self, sum_fn, count_fn, needs_label=True, key=None):
        self.sum_fn = sum_fn
        self.count_fn = count_fn
        self.needs_label = needs_label
        self.key = key


_ACCUM_FN_CACHE = {}  # kernel-recipe keys -> the built accumulate program


def _flatten_metrics(metric):
    if isinstance(metric, CompositeEvalMetric):
        out = []
        for child in metric.metrics:
            out.extend(_flatten_metrics(child))
        return out
    return [metric]


class DeviceMetricAccum:
    """Device-resident accumulator over an EvalMetric (or composite).

    ``update`` folds a batch's (labels, outputs) into per-metric f32
    scalars on the device and never waits for it; ``sync`` (at the fit's
    metric-sync cadence and at epoch end) copies all of them to the host
    in one transfer, adds them to the wrapped metrics' ``sum_metric`` /
    ``num_inst`` and zeroes the device sums. ``last_snapshot`` holds the
    name/value pairs of the latest sync for callbacks (Speedometer)."""

    def __init__(self, metric, children, kernels):
        self.metric = metric
        self.children = children
        self.kernels = kernels
        self.last_snapshot = None
        self.syncs = 0  # host transfers made, for tests and reports
        self._zero()

    @classmethod
    def wrap(cls, metric):
        """An accumulator for ``metric``, or None when a component has no
        device kernel (it then stays on the numpy path)."""
        if not isinstance(metric, EvalMetric):
            return None
        children = _flatten_metrics(metric)
        kernels = [c.device_kernel() for c in children]
        if not children or any(k is None for k in kernels):
            return None
        return cls(metric, children, kernels)

    def _zero(self):
        self._fn = getattr(self, "_fn", None)
        self._sums = [{} for _ in self.children]  # device -> sum
        self._counts = [0] * len(self.children)
        self._pending = False

    def reset(self):
        self._zero()
        self.last_snapshot = None

    def update(self, labels, preds):
        """Fold one batch (or one context's rows of it) in;
        ``labels``/``preds`` are tensors or NDArrays on one device, whose
        own sum they join. Nothing is copied to the host."""
        labels = [getattr(x, "_data", x) for x in (labels or [])]
        preds = [getattr(x, "_data", x) for x in (preds or [])]
        if any(k.needs_label for k in self.kernels):
            check_label_shapes(labels, preds)
        if self._fn is None:
            self._fn = self._build_fn()
        with torch.no_grad():
            parts = self._fn(labels, preds)
            for i, k in enumerate(self.kernels):
                sums = self._sums[i]
                pairs = zip(labels, preds) if k.needs_label else \
                    ((None, p) for p in preds)
                for (lab, p), part in zip(pairs, parts[i]):
                    sums[p.device] = part if p.device not in sums \
                        else sums[p.device] + part
                    self._counts[i] += int(k.count_fn(lab, p))
        self._pending = True

    def _build_fn(self):
        """The accumulate program (each kernel's partial sums of a batch),
        built through the compile pipeline's build seam as
        ``metric_accum``, once per kernel recipe process-wide when every
        kernel has a key (mxtpu :574-600)."""
        from .compile import pipeline as _pipeline
        cache_key = tuple(k.key for k in self.kernels)
        cacheable = all(k.key is not None for k in self.kernels)
        if cacheable and cache_key in _ACCUM_FN_CACHE:
            return _ACCUM_FN_CACHE[cache_key]
        kernels = self.kernels

        def accumulate(labels, preds):
            out = []
            for k in kernels:
                pairs = zip(labels, preds) if k.needs_label else \
                    ((None, p) for p in preds)
                out.append([k.sum_fn(None if lab is None else
                                     lab.to(p.device, non_blocking=True), p)
                            for lab, p in pairs])
            return out

        fn = _pipeline.record_program_build("metric_accum", self,
                                            accumulate)
        if cacheable:
            _ACCUM_FN_CACHE[cache_key] = fn
        return fn

    def sync(self):
        """The one host round trip: fold the device sums (each device's
        added on the first one's) into the wrapped metrics and refresh
        ``last_snapshot``; returns it."""
        if self._pending:
            live = [(c, list(s.values()), n) for c, s, n in
                    zip(self.children, self._sums, self._counts) if s]
            if live:
                dev = live[0][1][0].device
                vals = torch.stack([
                    sum(p.to(dev, torch.float64) for p in parts)
                    for _, parts, _ in live]).cpu().tolist()
                self.syncs += 1
                for (child, _, n), v in zip(live, vals):
                    child.sum_metric += float(v)
                    child.num_inst += n
            self._zero()
        self.last_snapshot = self.metric.get_name_value()
        return self.last_snapshot
