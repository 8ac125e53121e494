"""Gluon fused recurrent layers RNN/LSTM/GRU.

Counterpart of ``mxtpu/gluon/rnn/rnn_layer.py`` (parity: python/mxnet/
gluon/rnn/rnn_layer.py:233-433): forward calls the fused ``nd.RNN`` op
(``rnn_layer.py:139``), cuDNN's RNN on the card. Per-(layer, direction)
parameters are gate-stacked matrices; forward concatenates them into the
flat vector of ``ops/rnn.py`` at each call.
"""
from __future__ import annotations

from ... import ndarray
from ...initializer import One, Zero
from ...ops.rnn import GATE_COUNT
from ..block import Block
from ..parameter import DeferredInitializationError

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(Block):
    """Shared implementation of the fused recurrent layers."""

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, **kwargs):
        super().__init__(**kwargs)
        assert layout in ("TNC", "NTC"), \
            "Invalid layout %s; must be one of ['TNC' or 'NTC']" % layout
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._i2h_weight_initializer = i2h_weight_initializer
        self._h2h_weight_initializer = h2h_weight_initializer
        self._i2h_bias_initializer = i2h_bias_initializer
        self._h2h_bias_initializer = h2h_bias_initializer
        self._gates = GATE_COUNT[mode]

        ng, ni, nh = self._gates, input_size, hidden_size
        for i in range(num_layers):
            for j in (["l", "r"] if self._dir == 2 else ["l"]):
                self._register_param("%s%d_i2h_weight" % (j, i),
                                     shape=(ng * nh, ni),
                                     init=i2h_weight_initializer)
                self._register_param("%s%d_h2h_weight" % (j, i),
                                     shape=(ng * nh, nh),
                                     init=h2h_weight_initializer)
                self._register_param("%s%d_i2h_bias" % (j, i),
                                     shape=(ng * nh,),
                                     init=_init_of(i2h_bias_initializer))
                self._register_param("%s%d_h2h_bias" % (j, i),
                                     shape=(ng * nh,),
                                     init=_init_of(h2h_bias_initializer))
            ni = nh * self._dir

    def _register_param(self, name, shape, init):
        p = self.params.get(name, shape=shape, init=init,
                            allow_deferred_init=True)
        setattr(self, name, p)

    def __repr__(self):
        s = "{name}({mapping}, {_layout}"
        if self._num_layers != 1:
            s += ", num_layers={_num_layers}"
        if self._dropout != 0:
            s += ", dropout={_dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        s += ")"
        mapping = ("{_input_size} -> {_hidden_size}"
                   if self._input_size else "{_hidden_size}")
        mapping = mapping.format(**self.__dict__)
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=ndarray.zeros, **kwargs):
        states = []
        for i, info in enumerate(self.state_info(batch_size)):
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            states.append(func(name="%sh0_%d" % (self.prefix, i), **info))
        return states

    def forward(self, inputs, states=None):
        batch_size = inputs.shape[self._layout.find("N")]
        skip_states = states is None
        if skip_states:
            states = self.begin_state(batch_size, ctx=inputs.context)
        if isinstance(states, ndarray.NDArray):
            states = [states]
        for state, info in zip(states, self.state_info(batch_size)):
            if state.shape != info["shape"]:
                raise ValueError(
                    "Invalid recurrent state shape. Expecting %s, got %s." % (
                        str(info["shape"]), str(state.shape)))
        if self._input_size == 0:
            # deferred input size: resolve from the data's feature axis
            self._infer_input_size(inputs)
        out = self._forward_kernel(inputs, states)
        return out[0] if skip_states else out

    def _infer_input_size(self, inputs):
        ni = inputs.shape[2] if self._layout == "TNC" else inputs.shape[-1]
        self._input_size = ni
        for j in (["l", "r"] if self._dir == 2 else ["l"]):
            p = getattr(self, "%s0_i2h_weight" % j)
            if 0 in p.shape:
                p.shape = (self._gates * self._hidden_size, ni)
        for _, p in self.params.items():
            try:
                p._finish_deferred_init()
            except DeferredInitializationError:
                pass

    def _flat_params(self, ctx):
        """Pack per-layer params into the ops/rnn.py flat blob order."""
        parts = []
        for i in range(self._num_layers):
            for j in (["l", "r"] if self._dir == 2 else ["l"]):
                for kind in ("i2h_weight", "h2h_weight", "i2h_bias",
                             "h2h_bias"):
                    p = getattr(self, "%s%d_%s" % (j, i, kind))
                    parts.append(p.data(ctx).reshape((-1,)))
        return ndarray.concat(*parts, dim=0)

    def _forward_kernel(self, inputs, states):
        ctx = inputs.context
        if self._layout == "NTC":
            inputs = ndarray.swapaxes(inputs, dim1=0, dim2=1)
        params = self._flat_params(ctx)
        rnn_args = [inputs, params] + list(states)
        rnn = ndarray.RNN(*rnn_args, state_size=self._hidden_size,
                          num_layers=self._num_layers,
                          bidirectional=self._dir == 2, p=self._dropout,
                          state_outputs=True, mode=self._mode)
        if self._mode == "lstm":
            outputs, states = rnn[0], [rnn[1], rnn[2]]
        else:
            outputs, states = rnn[0], [rnn[1]]
        if self._layout == "NTC":
            outputs = ndarray.swapaxes(outputs, dim1=0, dim2=1)
        return outputs, states


class RNN(_RNNLayer):
    """Multi-layer Elman RNN (relu or tanh) layer (rnn_layer.py:233)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """Multi-layer LSTM layer (rnn_layer.py:233-340)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "lstm", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"},
                {"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """Multi-layer GRU layer (rnn_layer.py:363-433)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


def _init_of(initializer):
    if initializer == "zeros":
        return Zero()
    if initializer == "ones":
        return One()
    return initializer
