"""Gluon recurrent cells (parity python/mxnet/gluon/rnn/rnn_cell.py:277-741).

Counterpart of ``mxtpu/gluon/rnn/rnn_cell.py``. Cells are HybridBlocks:
a step runs imperatively on NDArrays or, hybridized, as its traced
Symbol through the executor's walk; both run the same torch ops.
"""
from __future__ import annotations

from ... import ndarray, symbol
from ...base import MXNetError
from ...initializer import One, Zero
from ..block import Block, HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ModifierCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _get_begin_state(cell, F, begin_state, inputs, batch_size):
    if begin_state is None:
        if F is ndarray:
            ctx = inputs.context if isinstance(inputs, ndarray.NDArray) \
                else inputs[0].context
            with ctx:
                begin_state = cell.begin_state(func=F.zeros,
                                               batch_size=batch_size)
        else:
            begin_state = cell.begin_state(func=F.zeros,
                                           batch_size=batch_size)
    return begin_state


def _format_sequence(length, inputs, layout, merge, in_layout=None):
    assert layout in ("NTC", "TNC"), "unsupported layout %s" % layout
    axis = layout.find("T")
    batch_axis = layout.find("N")
    batch_size = 0
    in_axis = in_layout.find("T") if in_layout is not None else axis
    if isinstance(inputs, symbol.Symbol):
        F = symbol
        if merge is False:
            assert length is not None
            inputs = list(symbol.SliceChannel(inputs, axis=in_axis,
                                              num_outputs=length,
                                              squeeze_axis=1))
    elif isinstance(inputs, ndarray.NDArray):
        F = ndarray
        batch_size = inputs.shape[batch_axis]
        if merge is False:
            assert length is None or length == inputs.shape[in_axis]
            inputs = ndarray.split(inputs, axis=in_axis,
                                   num_outputs=inputs.shape[in_axis],
                                   squeeze_axis=1)
            if not isinstance(inputs, (list, tuple)):
                inputs = [inputs]
    else:
        assert length is None or len(inputs) == length
        if isinstance(inputs[0], symbol.Symbol):
            F = symbol
        else:
            F = ndarray
            batch_size = inputs[0].shape[batch_axis]
        if merge is True:
            inputs = [F.expand_dims(i, axis=axis) for i in inputs]
            inputs = F.Concat(*inputs, dim=axis)
    if isinstance(inputs, (symbol.Symbol, ndarray.NDArray)) and \
            axis != in_axis:
        inputs = F.swapaxes(inputs, dim1=axis, dim2=in_axis)
    return inputs, axis, F, batch_size


class RecurrentCell(Block):
    """Abstract base for gluon recurrent cells."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=ndarray.zeros, **kwargs):
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called "\
            "directly. Call the modifier cell instead."
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            state = func(name="%sbegin_state_%d" % (self._prefix,
                                                    self._init_counter),
                         **info)
            states.append(state)
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, _, F, batch_size = _format_sequence(length, inputs, layout,
                                                    False)
        begin_state = _get_begin_state(self, F, begin_state, inputs,
                                       batch_size)
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        outputs, _, _, _ = _format_sequence(length, outputs, layout,
                                            merge_outputs)
        return outputs, states

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    def forward(self, inputs, states):
        self._counter += 1
        return super().forward(inputs, states)


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """Recurrent cell that supports hybridize."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, inputs, states):
        self._counter += 1
        return HybridBlock.forward(self, inputs, states)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class RNNCell(HybridRecurrentCell):
    """Elman RNN cell: h' = act(i2h(x) + h2h(h))."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(hidden_size,),
            init=_init_of(i2h_bias_initializer), allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(hidden_size,),
            init=_init_of(h2h_bias_initializer), allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prefix = "t%d_" % self._counter
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size,
                               name=prefix + "i2h")
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size,
                               name=prefix + "h2h")
        output = self._get_activation(F, i2h + h2h, self._activation,
                                      name=prefix + "out")
        return output, [output]


class LSTMCell(HybridRecurrentCell):
    """LSTM cell, gate order i,f,c,o."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(4 * hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_size,),
            init=_init_of(i2h_bias_initializer), allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_size,),
            init=_init_of(h2h_bias_initializer), allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prefix = "t%d_" % self._counter
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size * 4,
                               name=prefix + "i2h")
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size * 4,
                               name=prefix + "h2h")
        gates = i2h + h2h
        slice_gates = F.SliceChannel(gates, num_outputs=4,
                                     name=prefix + "slice")
        in_gate = F.Activation(slice_gates[0], act_type="sigmoid")
        forget_gate = F.Activation(slice_gates[1], act_type="sigmoid")
        in_transform = F.Activation(slice_gates[2], act_type="tanh")
        out_gate = F.Activation(slice_gates[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(HybridRecurrentCell):
    """GRU cell, gate order r,z,n."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(3 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(3 * hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(3 * hidden_size,),
            init=_init_of(i2h_bias_initializer), allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(3 * hidden_size,),
            init=_init_of(h2h_bias_initializer), allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prefix = "t%d_" % self._counter
        prev_state_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size * 3,
                               name=prefix + "i2h")
        h2h = F.FullyConnected(prev_state_h, h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size * 3,
                               name=prefix + "h2h")
        i2h_r, i2h_z, i2h = list(F.SliceChannel(
            i2h, num_outputs=3, name=prefix + "i2h_slice"))
        h2h_r, h2h_z, h2h = list(F.SliceChannel(
            h2h, num_outputs=3, name=prefix + "h2h_slice"))
        reset_gate = F.Activation(i2h_r + h2h_r, act_type="sigmoid",
                                  name=prefix + "r_act")
        update_gate = F.Activation(i2h_z + h2h_z, act_type="sigmoid",
                                   name=prefix + "z_act")
        next_h_tmp = F.Activation(i2h + reset_gate * h2h, act_type="tanh",
                                  name=prefix + "h_act")
        next_h = next_h_tmp + update_gate * (prev_state_h - next_h_tmp)
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Sequential stacking of cells."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children, batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children, **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._children:
            assert not isinstance(cell, BidirectionalCell)
            n = len(cell.state_info())
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, _, F, batch_size = _format_sequence(length, inputs, layout,
                                                    None)
        num_cells = len(self._children)
        begin_state = _get_begin_state(self, F, begin_state, inputs,
                                       batch_size)
        p = 0
        next_states = []
        for i, cell in enumerate(self._children):
            n = len(cell.state_info())
            states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs)
            next_states.extend(states)
        return inputs, next_states

    def __getitem__(self, i):
        return self._children[i]

    def __len__(self):
        return len(self._children)

    def forward(self, *args, **kwargs):
        raise NotImplementedError


class DropoutCell(HybridRecurrentCell):
    """Dropout on step outputs."""

    def __init__(self, rate, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        assert isinstance(rate, (int, float))
        self.rate = rate

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self.rate > 0:
            inputs = F.Dropout(inputs, p=self.rate)
        return inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, _, F, _ = _format_sequence(length, inputs, layout,
                                           merge_outputs)
        if isinstance(inputs, (ndarray.NDArray, symbol.Symbol)):
            return self.hybrid_forward(F, inputs, [])
        return super().unroll(length, inputs, begin_state=begin_state,
                              layout=layout, merge_outputs=merge_outputs)


class ModifierCell(HybridRecurrentCell):
    """Base for cells wrapping another cell."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "Cell %s is already modified." % base_cell.name
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=ndarray.zeros, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def hybrid_forward(self, F, inputs, states):
        raise NotImplementedError


class ZoneoutCell(ModifierCell):
    """Zoneout on cell output/states."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, BidirectionalCell)
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self.prev_output = None

    def hybrid_forward(self, F, inputs, states):
        cell = self.base_cell
        next_output, next_states = cell(inputs, states)
        mask = lambda p, like: F.Dropout(F.ones_like(like), p=p)  # noqa: E731
        prev_output = self.prev_output
        if prev_output is None:
            prev_output = F.zeros_like(next_output)
        output = F.where(mask(self.zoneout_outputs, next_output),
                         next_output, prev_output) \
            if self.zoneout_outputs > 0 else next_output
        states = [F.where(mask(self.zoneout_states, new_s), new_s, old_s)
                  for new_s, old_s in zip(next_states, states)] \
            if self.zoneout_states > 0 else next_states
        self.prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """Adds residual connection around the base cell."""

    def __init__(self, base_cell):
        super().__init__(base_cell)

    def _alias(self):
        return "residual"

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = output + inputs
        return output, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs)
        self.base_cell._modified = True
        merge_outputs = isinstance(outputs, (symbol.Symbol,
                                             ndarray.NDArray)) \
            if merge_outputs is None else merge_outputs
        inputs, _, F, _ = _format_sequence(length, inputs, layout,
                                           merge_outputs)
        if merge_outputs:
            outputs = outputs + inputs
        else:
            outputs = [o + i for o, i in zip(outputs, inputs)]
        return outputs, states


class BidirectionalCell(HybridRecurrentCell):
    """Bidirectional wrapper over two cells; use via unroll only."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell)
        self.register_child(r_cell)
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise MXNetError("Bidirectional cannot be stepped. Please use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children, batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis, F, batch_size = _format_sequence(length, inputs,
                                                       layout, False)
        begin_state = _get_begin_state(self, F, begin_state, inputs,
                                       batch_size)
        states = begin_state
        l_cell, r_cell = self._children
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs,
            begin_state=states[:len(l_cell.state_info())], layout=layout,
            merge_outputs=merge_outputs)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=states[len(l_cell.state_info()):], layout=layout,
            merge_outputs=False)
        r_outputs = list(reversed(r_outputs))
        if merge_outputs is None:
            merge_outputs = isinstance(l_outputs, (symbol.Symbol,
                                                   ndarray.NDArray))
        if not isinstance(l_outputs, (list, tuple)):
            l_outputs, _, _, _ = _format_sequence(length, l_outputs, layout,
                                                  False)
        outputs = [F.Concat(l_o, r_o, dim=1,
                            name="%st%d" % (self._output_prefix, i))
                   for i, (l_o, r_o) in enumerate(zip(l_outputs, r_outputs))]
        if merge_outputs:
            outputs, _, _, _ = _format_sequence(length, outputs, layout,
                                                merge_outputs)
        states = l_states + r_states
        return outputs, states


def _init_of(initializer):
    if initializer == "zeros":
        return Zero()
    if initializer == "ones":
        return One()
    return initializer
