"""Symbolic RNN cells: compose recurrent networks as Symbols.

Counterpart of ``mxtpu/rnn/rnn_cell.py`` (parity: the reference's
python/mxnet/rnn/rnn_cell.py): ``RNNParams``, ``BaseRNNCell`` (unroll in
both layouts, ``begin_state``, ``merge_outputs``, ``unpack_weights``/
``pack_weights``), ``RNNCell``, ``LSTMCell``, ``GRUCell``,
``FusedRNNCell`` (one ``RNN`` op, cuDNN's RNN on the card, with
``unfuse()``), ``SequentialRNNCell``, ``DropoutCell``, ``ZoneoutCell``,
``ResidualCell``, ``BidirectionalCell`` and the conv cells (:752-893),
over the port's Symbol. An unfused unroll is one graph node per op and
timestep, which the executor walks eagerly. The initial states are
batch-1 ``_zeros`` that broadcast against the batch, as in mxtpu.
Unpacked and packed weights are cpu() NDArrays.
"""
from __future__ import annotations

import numpy as _np

from .. import symbol
from ..base import MXNetError
from ..context import cpu
from ..initializer import FusedRNN as _FusedRNNInit
from ..initializer import LSTMBias, Xavier as _Xavier
from ..ndarray import array as _nd_array
from ..ops.rnn import (GATE_COUNT, rnn_infer_input_size, rnn_pack_weights,
                       rnn_unpack_weights)

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell",
           "BaseConvRNNCell", "ConvRNNCell", "ConvLSTMCell", "ConvGRUCell"]


class RNNParams(object):
    """Container for hold-and-reuse of cell weight Symbols (rnn_cell.py:60)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell(object):
    """Abstract recurrent cell: ``(output, states) = cell(input, states)``."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError

    @property
    def state_shape(self):
        return [ele["shape"] for ele in self.state_info]

    def state_spec(self, batch_size, dtype="float32"):
        """Per-state ``{"name", "shape", "dtype"}`` specs at ``batch_size``
        (the batch wildcard 0 resolved), as mxtpu's (rnn_cell.py:74): what
        the decode arenas size their device state from."""
        specs = []
        for i, info in enumerate(self.state_info):
            if info is None or "shape" not in info:
                raise MXNetError(
                    "%s.state_spec: state %d has no declared shape"
                    % (type(self).__name__, i))
            shape = tuple(int(batch_size) if d == 0 else int(d)
                          for d in info["shape"])
            specs.append({"name": "%sstate_%d" % (self._prefix, i),
                          "shape": shape, "dtype": dtype})
        return specs

    def begin_state_arrays(self, batch_size, dtype="float32"):
        """Zero numpy state arrays shaped by :meth:`state_spec`."""
        import numpy as _np
        return [_np.zeros(s["shape"], dtype=s["dtype"])
                for s in self.state_spec(batch_size, dtype=dtype)]

    @property
    def _gate_names(self):
        return ("",)

    def begin_state(self, func=symbol.zeros, **kwargs):
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called directly."
        states = []
        for info in self.state_info:
            self._init_counter += 1
            if info is None:
                state = func(name="%sbegin_state_%d" % (self._prefix,
                                                        self._init_counter),
                             **kwargs)
            else:
                kw = dict(kwargs)
                kw.update(info)
                # the reference uses 0 as an infer-me wildcard for the batch
                # dim, resolved by its bidirectional shape pass; here the
                # init state is batch-1 and broadcasts against the data
                # batch (identical math for constant initial states)
                if "shape" in kw:
                    kw["shape"] = tuple(1 if s == 0 else s
                                        for s in kw["shape"])
                kw.pop("__layout__", None)
                state = func(name="%sbegin_state_%d" % (self._prefix,
                                                        self._init_counter),
                             **kw)
            states.append(state)
        return states

    def unpack_weights(self, args):
        """Split packed gate weights into per-gate entries (rnn_cell.py:168)."""
        args = dict(args)
        if not self._gate_names or self._gate_names == ("",):
            return args
        h = self._num_hidden
        for group in ("i2h", "h2h"):
            for t in ("weight", "bias"):
                name = "%s%s_%s" % (self._prefix, group, t)
                if name not in args:
                    continue
                arr = args.pop(name)
                for i, g in enumerate(self._gate_names):
                    args["%s%s%s_%s" % (self._prefix, group, g, t)] = \
                        arr[i * h:(i + 1) * h].copy()
        return args

    def pack_weights(self, args):
        args = dict(args)
        if not self._gate_names or self._gate_names == ("",):
            return args
        for group in ("i2h", "h2h"):
            for t in ("weight", "bias"):
                pieces = []
                ok = True
                for g in self._gate_names:
                    name = "%s%s%s_%s" % (self._prefix, group, g, t)
                    if name not in args:
                        ok = False
                        break
                    pieces.append(args.pop(name))
                if ok and pieces:
                    cat = _np.concatenate([p.asnumpy() for p in pieces])
                    args["%s%s_%s" % (self._prefix, group, t)] = \
                        _nd_array(cat, ctx=cpu())
        return args

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Unroll the cell ``length`` steps. inputs: a (N,T,C)/(T,N,C) Symbol
        or a list of ``length`` (N,C) Symbols (rnn_cell.py:254)."""
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs)
        return outputs, states

    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return symbol.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)


def _normalize_sequence(length, inputs, layout, merge, in_layout=None):
    """list-of-symbols <-> merged (axis-stacked) symbol conversion."""
    assert layout in ("NTC", "TNC"), "unsupported layout %s" % layout
    axis = layout.find("T")
    in_axis = in_layout.find("T") if in_layout is not None else axis
    if isinstance(inputs, symbol.Symbol):
        if merge is False:
            assert length is not None
            inputs = symbol.SliceChannel(inputs, axis=in_axis,
                                         num_outputs=length,
                                         squeeze_axis=1)
            inputs = list(inputs)
        elif axis != in_axis:
            inputs = symbol.swapaxes(inputs, dim1=axis, dim2=in_axis)
    else:
        assert length is None or len(inputs) == length
        if merge is True:
            inputs = [symbol.expand_dims(i, axis=axis) for i in inputs]
            inputs = symbol.Concat(*inputs, dim=axis)
    return inputs, axis


class RNNCell(BaseRNNCell):
    """Vanilla RNN cell: h' = act(W_x x + b_x + W_h h + b_h) (rnn_cell.py:408)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(data=states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden,
                                    name="%sh2h" % name)
        output = self._get_activation(i2h + h2h, self._activation,
                                      name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell, gate order i,f,c,o (rnn_cell.py:408)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        self._iB = self.params.get(
            "i2h_bias", init=LSTMBias(forget_bias=forget_bias))
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(data=states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%sh2h" % name)
        gates = i2h + h2h
        slices = symbol.SliceChannel(gates, num_outputs=4,
                                     name="%sslice" % name)
        in_gate = symbol.Activation(slices[0], act_type="sigmoid")
        forget_gate = symbol.Activation(slices[1], act_type="sigmoid")
        in_transform = symbol.Activation(slices[2], act_type="tanh")
        out_gate = symbol.Activation(slices[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * symbol.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell, gate order r,z,n (rnn_cell.py:470)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        prev_h = states[0]
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(data=prev_h, weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%sh2h" % name)
        i2h_r, i2h_z, i2h_n = list(symbol.SliceChannel(
            i2h, num_outputs=3, name="%si2h_slice" % name))
        h2h_r, h2h_z, h2h_n = list(symbol.SliceChannel(
            h2h, num_outputs=3, name="%sh2h_slice" % name))
        reset_gate = symbol.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update_gate = symbol.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = symbol.Activation(i2h_n + reset_gate * h2h_n,
                                       act_type="tanh")
        next_h = next_h_tmp + update_gate * (prev_h - next_h_tmp)
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Multi-layer (optionally bidirectional) fused cell: unroll emits ONE
    ``RNN`` op, cuDNN's RNN on the card (mxtpu rnn_cell.py:335)."""

    def __init__(self, num_hidden, num_layers=1, bidirectional=False,
                 mode="lstm", prefix=None, params=None, forget_bias=1.0,
                 get_next_state=False, dropout=0.0):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._forget_bias = forget_bias
        self._directions = ["l", "r"] if bidirectional else ["l"]
        if mode not in GATE_COUNT:
            raise MXNetError("invalid fused RNN mode %s" % mode)
        # the flat blob carries its own structured initializer as the
        # Variable's __init__ attr, which wins over fit's initializer: a
        # plain Xavier would see one 1-D vector
        self._parameter = self.params.get(
            "parameters", init=_FusedRNNInit(
                _Xavier(factor_type="in", magnitude=2.34),
                num_hidden=num_hidden, num_layers=num_layers, mode=mode,
                bidirectional=bidirectional, forget_bias=forget_bias))

    @property
    def state_info(self):
        b = self._bidirectional + 1
        n = (self._mode == "lstm") + 1
        return [{"shape": (b * self._num_layers, 0, self._num_hidden),
                 "__layout__": "LNC"} for _ in range(n)]

    @property
    def _gate_names(self):
        return {"rnn_relu": [""], "rnn_tanh": [""],
                "lstm": ["_i", "_f", "_c", "_o"],
                "gru": ["_r", "_z", "_o"]}[self._mode]

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def unpack_weights(self, args):
        args = dict(args)
        arr = args.pop(self._parameter.name)
        h = self._num_hidden
        num_input = rnn_infer_input_size(arr.size, self._num_layers, h,
                                         self._mode, self._bidirectional)
        for k, v in rnn_unpack_weights(arr.asnumpy(), self._num_layers,
                                       num_input, h, self._mode,
                                       self._bidirectional).items():
            args[self._prefix + k] = _nd_array(v, ctx=cpu())
        return args

    def pack_weights(self, args):
        args = dict(args)
        b = self._bidirectional
        w = {}
        for k in list(args):
            if k.startswith(self._prefix) and ("i2h" in k or "h2h" in k):
                w[k[len(self._prefix):]] = args.pop(k)
        if w:
            l0 = w["l0_i2h%s_weight" % self._gate_names[0]]
            num_input = l0.shape[1] if hasattr(l0, "shape") else \
                _np.asarray(l0).shape[1]
            flat = rnn_pack_weights(
                {k: (v.asnumpy() if hasattr(v, "asnumpy") else v)
                 for k, v in w.items()},
                self._num_layers, num_input, self._num_hidden, self._mode, b)
            args[self._parameter.name] = _nd_array(flat, ctx=cpu())
        return args

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, True)
        if axis == 1:  # NTC -> TNC for the fused op
            inputs = symbol.swapaxes(inputs, dim1=0, dim2=1)
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        if self._mode == "lstm":
            states = {"state": states[0], "state_cell": states[1]}
        else:
            states = {"state": states[0]}
        rnn = symbol.RNN(data=inputs, parameters=self._parameter,
                         state_size=self._num_hidden,
                         num_layers=self._num_layers,
                         bidirectional=self._bidirectional,
                         p=self._dropout,
                         state_outputs=self._get_next_state,
                         mode=self._mode, name=self._prefix + "rnn",
                         **states)
        if not self._get_next_state:
            outputs, states = rnn, []
        elif self._mode == "lstm":
            outputs, states = rnn[0], [rnn[1], rnn[2]]
        else:
            outputs, states = rnn[0], [rnn[1]]
        if axis == 1:
            outputs = symbol.swapaxes(outputs, dim1=0, dim2=1)
        if merge_outputs is False:
            outputs, _ = _normalize_sequence(length, outputs, layout, False,
                                             in_layout=layout)
        return outputs, states

    def unfuse(self):
        """Equivalent SequentialRNNCell of unfused cells (rnn_cell.py:700)."""
        stack = SequentialRNNCell()
        get_cell = {
            "rnn_relu": lambda p: RNNCell(self._num_hidden, activation="relu",
                                          prefix=p),
            "rnn_tanh": lambda p: RNNCell(self._num_hidden, activation="tanh",
                                          prefix=p),
            "lstm": lambda p: LSTMCell(self._num_hidden, prefix=p),
            "gru": lambda p: GRUCell(self._num_hidden, prefix=p),
        }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell("%sl%d_" % (self._prefix, i)),
                    get_cell("%sr%d_" % (self._prefix, i)),
                    output_prefix="%sbi_%s_%d" % (self._prefix, self._mode,
                                                  i)))
            else:
                stack.add(get_cell("%sl%d_" % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix="%s_dropout%d_" % (self._prefix,
                                                                i)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Stack of cells applied in order each step (rnn_cell.py:741)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            assert cell._own_params
            cell.params._params.update(self.params._params)
            self.params._params.update(cell.params._params)

    @property
    def state_info(self):
        return _cells_state_info(self._cells)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._cells, **kwargs)

    def unpack_weights(self, args):
        return _cells_unpack_weights(self._cells, args)

    def pack_weights(self, args):
        return _cells_pack_weights(self._cells, args)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_info)
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        num_cells = len(self._cells)
        if begin_state is None:
            begin_state = self.begin_state()
        p = 0
        next_states = []
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs)
            next_states.extend(states)
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    """Dropout on step outputs (rnn_cell.py:795)."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(data=inputs, p=self.dropout)
        return inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, merge_outputs)
        if isinstance(inputs, symbol.Symbol):
            return self(inputs, [])
        return super().unroll(length, inputs, begin_state=begin_state,
                              layout=layout, merge_outputs=merge_outputs)


class ModifierCell(BaseRNNCell):
    """Base for cells that wrap another cell (rnn_cell.py:832)."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=symbol.zeros, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (rnn_cell.py:877)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, FusedRNNCell), \
            "FusedRNNCell does not support zoneout; unfuse() first"
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell = self.base_cell
        next_output, next_states = cell(inputs, states)
        mask = (lambda p, like: symbol.Dropout(
            symbol.ones_like(like), p=p))
        prev_output = self.prev_output if self.prev_output is not None \
            else symbol.zeros_like(next_output)
        output = symbol.where(mask(self.zoneout_outputs, next_output),
                              next_output, prev_output) \
            if self.zoneout_outputs > 0 else next_output
        states = [symbol.where(mask(self.zoneout_states, new_s), new_s,
                               old_s)
                  for new_s, old_s in zip(next_states, states)] \
            if self.zoneout_states > 0 else next_states
        self.prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """Adds the input to the cell output (rnn_cell.py:922)."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = symbol.elemwise_add(output, inputs,
                                     name="%s_plus_residual" % output.name)
        return output, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs)
        self.base_cell._modified = True
        merge_outputs = isinstance(outputs, symbol.Symbol) \
            if merge_outputs is None else merge_outputs
        inputs, _ = _normalize_sequence(length, inputs, layout, merge_outputs)
        if merge_outputs:
            outputs = symbol.elemwise_add(outputs, inputs)
        else:
            outputs = [symbol.elemwise_add(o, i)
                       for o, i in zip(outputs, inputs)]
        return outputs, states


class BidirectionalCell(BaseRNNCell):
    """Runs l_cell forward and r_cell on the reversed sequence, concatenating
    step outputs (rnn_cell.py:277). Only usable via unroll."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__("", params=params)
        self._output_prefix = output_prefix
        self._override_cell_params = params is not None
        if self._override_cell_params:
            assert l_cell._own_params and r_cell._own_params
            l_cell.params._params.update(self.params._params)
            r_cell.params._params.update(self.params._params)
        self.params._params.update(l_cell.params._params)
        self.params._params.update(r_cell.params._params)
        self._cells = [l_cell, r_cell]

    def unpack_weights(self, args):
        return _cells_unpack_weights(self._cells, args)

    def pack_weights(self, args):
        return _cells_pack_weights(self._cells, args)

    def __call__(self, inputs, states):
        raise MXNetError("BidirectionalCell cannot be stepped; use unroll")

    @property
    def state_info(self):
        return _cells_state_info(self._cells)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._cells, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        l_cell, r_cell = self._cells
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs,
            begin_state=states[:len(l_cell.state_info)],
            layout=layout, merge_outputs=merge_outputs)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=states[len(l_cell.state_info):],
            layout=layout, merge_outputs=merge_outputs)
        if merge_outputs is None:
            merge_outputs = isinstance(l_outputs, symbol.Symbol) and \
                isinstance(r_outputs, symbol.Symbol)
            l_outputs, _ = _normalize_sequence(length, l_outputs, layout,
                                               merge_outputs)
            r_outputs, _ = _normalize_sequence(length, r_outputs, layout,
                                               merge_outputs)
        if merge_outputs:
            r_outputs = symbol.reverse(r_outputs, axis=axis)
            outputs = symbol.Concat(l_outputs, r_outputs, dim=2,
                                    name="%sout" % self._output_prefix)
        else:
            outputs = [symbol.Concat(l_o, r_o, dim=1,
                                     name="%st%d" % (self._output_prefix, i))
                       for i, (l_o, r_o) in enumerate(
                           zip(l_outputs, reversed(r_outputs)))]
        states = l_states + r_states
        return outputs, states


def _cells_state_info(cells):
    return sum([c.state_info for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _cells_unpack_weights(cells, args):
    for cell in cells:
        args = cell.unpack_weights(args)
    return args


def _cells_pack_weights(cells, args):
    for cell in cells:
        args = cell.pack_weights(args)
    return args


class BaseConvRNNCell(BaseRNNCell):
    """Convolutional recurrent cells: states are NCHW feature maps and the
    i2h/h2h transforms are Convolutions (mxtpu rnn_cell.py:752; the
    ConvRNN/ConvLSTM/ConvGRU family)."""

    def __init__(self, input_shape, num_hidden, h2h_kernel=(3, 3),
                 h2h_dilate=(1, 1), i2h_kernel=(3, 3), i2h_stride=(1, 1),
                 i2h_pad=(1, 1), i2h_dilate=(1, 1), activation="tanh",
                 prefix="", params=None):
        super().__init__(prefix=prefix, params=params)
        if h2h_kernel[0] % 2 != 1 or h2h_kernel[1] % 2 != 1:
            raise MXNetError("h2h_kernel must be odd, got %s"
                             % (h2h_kernel,))
        self._h2h_kernel = tuple(h2h_kernel)
        self._h2h_dilate = tuple(h2h_dilate)
        self._h2h_pad = (h2h_dilate[0] * (h2h_kernel[0] - 1) // 2,
                         h2h_dilate[1] * (h2h_kernel[1] - 1) // 2)
        self._i2h_kernel = tuple(i2h_kernel)
        self._i2h_stride = tuple(i2h_stride)
        self._i2h_pad = tuple(i2h_pad)
        self._i2h_dilate = tuple(i2h_dilate)
        self._num_hidden = num_hidden
        self._input_shape = tuple(input_shape)  # (C, H, W) per sample
        self._activation = activation
        # state spatial dims from the i2h conv geometry
        c, h, w = self._input_shape
        oh = (h + 2 * i2h_pad[0] - i2h_dilate[0] * (i2h_kernel[0] - 1)
              - 1) // i2h_stride[0] + 1
        ow = (w + 2 * i2h_pad[1] - i2h_dilate[1] * (i2h_kernel[1] - 1)
              - 1) // i2h_stride[1] + 1
        self._state_hw = (oh, ow)
        self._iW = self.params.get("i2h_weight")
        self._ib = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hb = self.params.get("h2h_bias")

    @property
    def _gates(self):
        return 1

    @property
    def state_info(self):
        oh, ow = self._state_hw
        return [{"shape": (0, self._num_hidden, oh, ow),
                 "__layout__": "NCHW"}]

    def _conv_sums(self, inputs, state, name):
        """i2h(inputs) + h2h(state), num_filter = gates * num_hidden."""
        nf = self._gates * self._num_hidden
        i2h = symbol.Convolution(inputs, self._iW, self._ib,
                                 kernel=self._i2h_kernel,
                                 stride=self._i2h_stride,
                                 pad=self._i2h_pad,
                                 dilate=self._i2h_dilate,
                                 num_filter=nf, name="%si2h" % name)
        h2h = symbol.Convolution(state, self._hW, self._hb,
                                 kernel=self._h2h_kernel,
                                 pad=self._h2h_pad,
                                 dilate=self._h2h_dilate,
                                 num_filter=nf, name="%sh2h" % name)
        return i2h, h2h


class ConvRNNCell(BaseConvRNNCell):
    """Plain conv recurrence: h' = act(i2h(x) + h2h(h)) (rnn_cell.py:1176)."""

    def __init__(self, input_shape, num_hidden, prefix="ConvRNN_", **kw):
        super().__init__(input_shape, num_hidden, prefix=prefix, **kw)

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h, h2h = self._conv_sums(inputs, states[0], name)
        out = self._get_activation(i2h + h2h, self._activation,
                                   name="%sout" % name)
        return out, [out]


class ConvLSTMCell(BaseConvRNNCell):
    """Conv LSTM (Shi et al. 2015; rnn_cell.py:1249): the four gates are
    channel slices of one i2h+h2h conv pair."""

    def __init__(self, input_shape, num_hidden, prefix="ConvLSTM_",
                 forget_bias=1.0, **kw):
        super().__init__(input_shape, num_hidden, prefix=prefix, **kw)
        self._forget_bias = forget_bias

    @property
    def _gates(self):
        return 4

    @property
    def state_info(self):
        oh, ow = self._state_hw
        return [{"shape": (0, self._num_hidden, oh, ow),
                 "__layout__": "NCHW"}] * 2

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h, h2h = self._conv_sums(inputs, states[0], name)
        gates = i2h + h2h
        sl = symbol.SliceChannel(gates, num_outputs=4, axis=1,
                                 name="%sslice" % name)
        i = symbol.Activation(sl[0], act_type="sigmoid")
        f = symbol.Activation(sl[1] + self._forget_bias,
                              act_type="sigmoid")
        c_in = self._get_activation(sl[2], self._activation)
        o = symbol.Activation(sl[3], act_type="sigmoid")
        c = f * states[1] + i * c_in
        h = o * self._get_activation(c, self._activation,
                                     name="%sout" % name)
        return h, [h, c]


class ConvGRUCell(BaseConvRNNCell):
    """Conv GRU (rnn_cell.py:1339): reset/update/candidate gates as
    channel slices."""

    def __init__(self, input_shape, num_hidden, prefix="ConvGRU_", **kw):
        super().__init__(input_shape, num_hidden, prefix=prefix, **kw)

    @property
    def _gates(self):
        return 3

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h, h2h = self._conv_sums(inputs, states[0], name)
        i_sl = symbol.SliceChannel(i2h, num_outputs=3, axis=1,
                                   name="%si_slice" % name)
        h_sl = symbol.SliceChannel(h2h, num_outputs=3, axis=1,
                                   name="%sh_slice" % name)
        r = symbol.Activation(i_sl[0] + h_sl[0], act_type="sigmoid")
        z = symbol.Activation(i_sl[1] + h_sl[1], act_type="sigmoid")
        cand = self._get_activation(i_sl[2] + r * h_sl[2],
                                    self._activation)
        out = z * states[0] + (1 - z) * cand
        return out, [out]
