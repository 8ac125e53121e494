"""Gluon convolution and pooling layers.

Counterpart of ``mxtpu/gluon/nn/conv_layers.py``: ``Conv1D``/``2D``/``3D``
over the port's ``Convolution``, and the max, average and global pooling
layers in 1, 2 and 3 dimensions over its ``Pooling``. The
``Conv*Transpose`` layers need the ``Deconvolution`` op, not ported yet
(ROADMAP A.7): constructing one raises.
"""
from __future__ import annotations

from ...base import MXNetError
from ..block import HybridBlock


def _pair(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 **kwargs):
        super().__init__(**kwargs)
        from .basic_layers import Activation, _init_of
        with self.name_scope():
            self._channels = channels
            self._in_channels = in_channels
            self._kwargs = {
                "kernel": kernel_size, "stride": strides, "dilate": dilation,
                "pad": padding, "num_filter": channels, "num_group": groups,
                "no_bias": not use_bias}
            wshape = (channels, in_channels // groups
                      if in_channels else 0) + kernel_size
            self.weight = self.params.get("weight", shape=wshape,
                                          init=weight_initializer,
                                          allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get("bias", shape=(channels,),
                                            init=_init_of(bias_initializer),
                                            allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def hybrid_forward(self, F, x, weight, bias=None):
        if bias is None:
            act = F.Convolution(x, weight, **self._kwargs)
        else:
            act = F.Convolution(x, weight, bias, **self._kwargs)
        if self.act is not None:
            act = self.act(act)
        return act

    def __repr__(self):
        s = "{name}({mapping}, kernel_size={kernel}, stride={stride})"
        mapping = ("{0} -> {1}".format(self._in_channels, self._channels)
                   if self._in_channels else str(self._channels))
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self._kwargs)


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0, dilation=1,
                 groups=1, layout="NCW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _pair(kernel_size, 1), _pair(strides, 1),
                         _pair(padding, 1), _pair(dilation, 1), groups, layout,
                         in_channels, activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _pair(kernel_size, 2), _pair(strides, 2),
                         _pair(padding, 2), _pair(dilation, 2), groups, layout,
                         in_channels, activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _pair(kernel_size, 3), _pair(strides, 3),
                         _pair(padding, 3), _pair(dilation, 3), groups, layout,
                         in_channels, activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


def _needs_deconvolution(name):
    """A ``Conv*Transpose`` layer: it needs the Deconvolution op (ROADMAP
    A.7), so constructing one raises."""
    def __init__(self, *args, **kwargs):
        raise MXNetError("%s needs the Deconvolution op, which is not "
                         "ported yet (ROADMAP A.7)" % name)
    return type(name, (_Conv,), {"__init__": __init__})


Conv1DTranspose = _needs_deconvolution("Conv1DTranspose")
Conv2DTranspose = _needs_deconvolution("Conv2DTranspose")
Conv3DTranspose = _needs_deconvolution("Conv3DTranspose")


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def __repr__(self):
        s = "{name}(size={kernel}, stride={stride}, padding={pad})"
        return s.format(name=self.__class__.__name__, **self._kwargs)


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(_pair(pool_size, 1),
                         _pair(strides, 1) if strides is not None else None,
                         _pair(padding, 1), ceil_mode, False, "max", **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_pair(pool_size, 2),
                         _pair(strides, 2) if strides is not None else None,
                         _pair(padding, 2), ceil_mode, False, "max", **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(_pair(pool_size, 3),
                         _pair(strides, 3) if strides is not None else None,
                         _pair(padding, 3), ceil_mode, False, "max", **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(_pair(pool_size, 1),
                         _pair(strides, 1) if strides is not None else None,
                         _pair(padding, 1), ceil_mode, False, "avg", **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_pair(pool_size, 2),
                         _pair(strides, 2) if strides is not None else None,
                         _pair(padding, 2), ceil_mode, False, "avg", **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(_pair(pool_size, 3),
                         _pair(strides, 3) if strides is not None else None,
                         _pair(padding, 3), ceil_mode, False, "avg", **kwargs)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, (0,), True, True, "max", **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, True, "max", **kwargs)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, (0, 0, 0), True, True, "max",
                         **kwargs)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, (0,), True, True, "avg", **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, True, "avg", **kwargs)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, (0, 0, 0), True, True, "avg",
                         **kwargs)
