"""Gluon basic layers.

Counterpart of ``mxtpu/gluon/nn/basic_layers.py``: ``Sequential``,
``HybridSequential``, ``Dense``, ``Activation``, ``Dropout``,
``BatchNorm``, ``LayerNorm``, ``LeakyReLU``, ``Embedding``, ``Flatten``,
``Lambda`` and ``HybridLambda``, each over the port's registered op of
the same name, with mxtpu's parameter names, shapes and initializers.
"""
from __future__ import annotations

from ... import ndarray as nd_mod
from ... import symbol as sym_mod
from ..block import Block, HybridBlock


class Sequential(Block):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._layers = []

    def add(self, *blocks):
        for block in blocks:
            self._layers.append(block)
            self.register_child(block)

    def forward(self, x):
        for block in self._children:
            x = block(x)
        return x

    def __repr__(self):
        s = "{name}(\n{modstr}\n)"
        modstr = "\n".join(["  ({key}): {block}".format(
            key=key, block=repr(block).replace("\n", "\n  "))
            for key, block in enumerate(self._children)])
        return s.format(name=self.__class__.__name__, modstr=modstr)

    def __getitem__(self, i):
        return self._children[i]

    def __len__(self):
        return len(self._children)


class HybridSequential(HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        for block in self._children:
            x = block(x)
        return x

    def __getitem__(self, i):
        return self._children[i]

    def __len__(self):
        return len(self._children)


class Dense(HybridBlock):
    """Fully-connected layer (parity basic_layers.py:104)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._flatten = flatten
        with self.name_scope():
            self._units = units
            self._in_units = in_units
            self.weight = self.params.get("weight", shape=(units, in_units),
                                          init=weight_initializer,
                                          allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get("bias", shape=(units,),
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
            act = F.FullyConnected(x, weight, no_bias=True,
                                   num_hidden=self._units,
                                   flatten=self._flatten)
        else:
            act = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                                   flatten=self._flatten)
        if self.act is not None:
            act = self.act(act)
        return act

    def __repr__(self):
        s = "{name}({layout}, {act})"
        return s.format(name=self.__class__.__name__,
                        act=self.act if self.act else "linear",
                        layout="{0} -> {1}".format(
                            self._in_units, self._units)
                        if self._in_units else self._units)


def _init_of(initializer):
    from ...initializer import Zero, One
    if initializer == "zeros":
        return Zero()
    if initializer == "ones":
        return One()
    return initializer


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def __repr__(self):
        return "{name}({_act_type})".format(name=self.__class__.__name__,
                                            **self.__dict__)


class Dropout(HybridBlock):
    def __init__(self, rate, **kwargs):
        super().__init__(**kwargs)
        self._rate = rate

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate)

    def __repr__(self):
        return "{name}(p = {_rate})".format(name=self.__class__.__name__,
                                            **self.__dict__)


class BatchNorm(HybridBlock):
    """Batch normalization (parity basic_layers.py:267)."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        self._axis = axis
        if in_channels != 0:
            self.in_channels = in_channels
        self.gamma = self.params.get("gamma",
                                     grad_req="write" if scale else "null",
                                     shape=(in_channels,),
                                     init=_init_of(gamma_initializer),
                                     allow_deferred_init=True,
                                     differentiable=scale)
        self.beta = self.params.get("beta",
                                    grad_req="write" if center else "null",
                                    shape=(in_channels,),
                                    init=_init_of(beta_initializer),
                                    allow_deferred_init=True,
                                    differentiable=center)
        self.running_mean = self.params.get("running_mean", grad_req="null",
                                            shape=(in_channels,),
                                            init=_init_of(
                                                running_mean_initializer),
                                            allow_deferred_init=True,
                                            differentiable=False)
        self.running_var = self.params.get("running_var", grad_req="null",
                                           shape=(in_channels,),
                                           init=_init_of(
                                               running_variance_initializer),
                                           allow_deferred_init=True,
                                           differentiable=False)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           **self._kwargs)

    def __repr__(self):
        s = "{name}({content}"
        in_channels = self.gamma.shape[0] if self.gamma.shape else 0
        s += ", in_channels={0}".format(in_channels)
        s += ")"
        return s.format(name=self.__class__.__name__,
                        content=", ".join(
                            ["=".join([k, v.__repr__()])
                             for k, v in self._kwargs.items()]))


class LayerNorm(HybridBlock):
    """Layer normalization over the last axis (the transformer family's
    norm; the reference Gluon gained nn.LayerNorm post-0.11 —
    python/mxnet/gluon/nn/basic_layers.py in later MXNet)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"axis": axis, "eps": epsilon}
        self.gamma = self.params.get("gamma",
                                     grad_req="write" if scale else "null",
                                     shape=(in_channels,),
                                     init=_init_of(gamma_initializer),
                                     allow_deferred_init=True,
                                     differentiable=scale)
        self.beta = self.params.get("beta",
                                    grad_req="write" if center else "null",
                                    shape=(in_channels,),
                                    init=_init_of(beta_initializer),
                                    allow_deferred_init=True,
                                    differentiable=center)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, **self._kwargs)

    def __repr__(self):
        s = "{name}({content}"
        in_channels = self.gamma.shape[0] if self.gamma.shape else 0
        s += ", in_channels={0})".format(in_channels)
        return s.format(name=self.__class__.__name__,
                        content=", ".join(
                            ["=".join([k, v.__repr__()])
                             for k, v in self._kwargs.items()]))


class LeakyReLU(HybridBlock):
    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)

    def __repr__(self):
        return "{name}({_alpha})".format(name=self.__class__.__name__,
                                         **self.__dict__)


class Embedding(HybridBlock):
    """Embedding lookup (parity basic_layers.py:387)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype}
        self.weight = self.params.get("weight", shape=(input_dim, output_dim),
                                      init=weight_initializer,
                                      allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, **self._kwargs)

    def __repr__(self):
        s = "{name}({input_dim} -> {output_dim}, {dtype})"
        return s.format(name=self.__class__.__name__, **self._kwargs)


class Flatten(HybridBlock):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)

    def hybrid_forward(self, F, x):
        return F.Flatten(x)

    def __repr__(self):
        return self.__class__.__name__


class Lambda(Block):
    """Wrap a function as a Block (later-reference parity convenience)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            assert hasattr(nd_mod, function), \
                "Function name %s is not found in ndarray." % function
            self._func_impl = getattr(nd_mod, function)
        else:
            self._func_impl = function

    def forward(self, *args):
        return self._func_impl(*args)


class HybridLambda(HybridBlock):
    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            assert hasattr(nd_mod, function) and hasattr(sym_mod, function), \
                "Function name %s is not found in ndarray/symbol." % function
            self._func_name = function
        else:
            self._func_name = None
            self._func_impl = function

    def hybrid_forward(self, F, x, *args):
        if self._func_name is not None:
            return getattr(F, self._func_name)(x, *args)
        return self._func_impl(F, x, *args)
