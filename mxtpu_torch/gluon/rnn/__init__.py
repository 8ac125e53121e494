"""gluon.rnn: recurrent cells and fused layers (counterpart of
``mxtpu/gluon/rnn/``; parity gluon/rnn/)."""
from .rnn_cell import (BidirectionalCell, DropoutCell, GRUCell,
                       HybridRecurrentCell, LSTMCell, ModifierCell,
                       RecurrentCell, ResidualCell, RNNCell,
                       SequentialRNNCell, ZoneoutCell)
from .rnn_layer import GRU, LSTM, RNN
