"""Weight initializers (parity: python/mxnet/initializer.py).

The port's own copy of the parts of ``mxtpu/initializer.py`` that Module
uses: ``InitDesc``, the name-suffix dispatch of ``Initializer.__call__``
(bias/beta -> 0, gamma -> 1, weight -> the rule, moving statistics ->
0/1), ``Zero``, ``One``, ``Constant``, ``Uniform``, ``Normal`` and
``Xavier``, ``LSTMBias`` and ``FusedRNN`` (mxtpu/initializer.py:210-285),
plus ``create``/``register``. Random draws come from numpy's
global RNG, so ``numpy.random.seed`` fixes the initial weights run to
run. (The JAX package draws Uniform/Normal/Xavier from its threefry key
chain, so the two packages' weights differ for the same seed; tests that
compare them copy one package's weights into the other.) An ``__init__``
attribute on a variable (a JSON ``[name, kwargs]``) picks that
variable's initializer, as in mxtpu.
"""
from __future__ import annotations

import json

import numpy as _np

from .base import MXNetError

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Constant", "Uniform",
           "Normal", "Xavier", "LSTMBias", "FusedRNN", "register", "create"]

_REG = {}


class InitDesc(str):
    """Name + attrs descriptor handed to an initializer."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


class Initializer:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, str):
            raise TypeError("desc must be str/InitDesc")
        name = str(desc)
        init_attr = getattr(desc, "attrs", {}).get("__init__", "")
        if init_attr:
            klass, kwargs = json.loads(init_attr)
            create(klass, **kwargs)._init_weight(name, arr)
            return
        if name.endswith("bias"):
            self._init_bias(name, arr)
        elif name.endswith("gamma"):
            self._init_gamma(name, arr)
        elif name.endswith("beta"):
            self._init_beta(name, arr)
        elif name.endswith("weight"):
            self._init_weight(name, arr)
        elif name.endswith("parameters"):
            # a fused RNN's flat vector: a structured initializer sees one
            # 1-D blob here; FusedRNNCell's variable carries FusedRNN,
            # which initializes each matrix of the blob
            self._init_weight(name, arr)
        elif name.endswith("moving_mean") or name.endswith("running_mean"):
            self._init_zero(name, arr)
        elif name.endswith("moving_var") or name.endswith("running_var"):
            self._init_one(name, arr)
        else:
            self._init_default(name, arr)

    def _init_zero(self, name, arr):
        arr[:] = 0.0

    def _init_one(self, name, arr):
        arr[:] = 1.0

    def _init_bias(self, name, arr):
        arr[:] = 0.0

    def _init_gamma(self, name, arr):
        arr[:] = 1.0

    def _init_beta(self, name, arr):
        arr[:] = 0.0

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def _init_default(self, name, arr):
        arr[:] = 0.0


def register(klass):
    _REG[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An initializer instance by (case-insensitive) class name."""
    if isinstance(name, Initializer):
        return name
    klass = _REG.get(str(name).lower())
    if klass is None:
        raise MXNetError("unknown initializer %r (have %s)"
                         % (name, sorted(_REG)))
    return klass(**kwargs)


@register
class Zero(Initializer):
    def _init_weight(self, name, arr):
        arr[:] = 0.0


@register
class One(Initializer):
    def _init_weight(self, name, arr):
        arr[:] = 1.0


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, arr):
        arr[:] = self.value


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr):
        arr[:] = _np.random.uniform(-self.scale, self.scale,
                                    arr.shape).astype(_np.float32)


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr):
        arr[:] = _np.random.normal(0.0, self.sigma,
                                   arr.shape).astype(_np.float32)


@register
class Xavier(Initializer):
    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        hw_scale = 1.0
        if len(shape) < 2:
            raise MXNetError("Xavier requires >=2d weight %s" % name)
        if len(shape) > 2:
            hw_scale = _np.prod(shape[2:])
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = _np.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            w = _np.random.uniform(-scale, scale, shape)
        else:
            w = _np.random.normal(0.0, scale, shape)
        arr[:] = w.astype(_np.float32)


@register
class LSTMBias(Initializer):
    """Zeros with the forget gate's quarter set to ``forget_bias``."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        a = _np.zeros(arr.shape, dtype="float32")
        num_hidden = arr.shape[0] // 4
        a[num_hidden:2 * num_hidden] = self.forget_bias
        arr[:] = a

    _init_bias = _init_weight


@register
class FusedRNN(Initializer):
    """A FusedRNNCell's flat ``parameters`` vector, initialized as mxtpu
    does it: unpacked into per-gate matrices, the wrapped initializer run
    on each weight matrix (so Xavier sees each matrix's fans), the biases
    zero but the LSTM's i2h forget bias ``forget_bias``, and repacked."""

    def __init__(self, init=None, num_hidden=0, num_layers=0, mode="lstm",
                 bidirectional=False, forget_bias=1.0):
        if isinstance(init, str):
            klass, kwargs = json.loads(init)
            init = create(klass, **kwargs)
        self._init = init or Uniform(0.07)
        super().__init__(init=self._init.dumps(), num_hidden=int(num_hidden),
                         num_layers=int(num_layers), mode=mode,
                         bidirectional=bool(bidirectional),
                         forget_bias=float(forget_bias))
        self._num_hidden = int(num_hidden)
        self._num_layers = int(num_layers)
        self._mode = mode
        self._bidirectional = bool(bidirectional)
        self._forget_bias = float(forget_bias)

    def _init_weight(self, name, arr):
        from .ops.rnn import (rnn_infer_input_size, rnn_pack_weights,
                              rnn_unpack_weights)
        if not (self._num_hidden and self._num_layers):
            self._init._init_weight(name, arr)
            return
        h, L = self._num_hidden, self._num_layers
        size = int(_np.prod(arr.shape))
        num_input = rnn_infer_input_size(size, L, h, self._mode,
                                         self._bidirectional)
        pieces = rnn_unpack_weights(_np.zeros(size, _np.float32), L,
                                    num_input, h, self._mode,
                                    self._bidirectional)
        for k, v in pieces.items():
            if k.endswith("_weight"):
                tmp = _np.zeros(v.shape, "float32")
                self._init._init_weight(k, tmp)
                pieces[k] = tmp
            elif "i2h_f_bias" in k and self._mode == "lstm":
                pieces[k] = _np.full(v.shape, self._forget_bias, "float32")
            else:
                pieces[k] = _np.zeros(v.shape, "float32")
        arr[:] = rnn_pack_weights(pieces, L, num_input, h, self._mode,
                                  self._bidirectional).reshape(arr.shape)
