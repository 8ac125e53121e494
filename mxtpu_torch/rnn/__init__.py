"""mx.rnn: symbolic recurrent cells, bucketed iterators, RNN checkpoints.

Counterpart of ``mxtpu/rnn/`` (parity: python/mxnet/rnn/)."""
from .rnn_cell import (BaseConvRNNCell, BaseRNNCell, BidirectionalCell,
                       ConvGRUCell, ConvLSTMCell, ConvRNNCell, DropoutCell,
                       FusedRNNCell, GRUCell, LSTMCell, ModifierCell,
                       ResidualCell, RNNCell, RNNParams, SequentialRNNCell,
                       ZoneoutCell)
from .io import BucketSentenceIter, encode_sentences
from .rnn import (do_rnn_checkpoint, load_rnn_checkpoint, rnn_unroll,
                  save_rnn_checkpoint)
