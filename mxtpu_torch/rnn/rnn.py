"""RNN checkpoint helpers (parity python/mxnet/rnn/rnn.py).

Counterpart of ``mxtpu/rnn/rnn.py``: the files are ``model``'s, which
load in either package; a fused cell's flat vector is stored as mxtpu
stores it.
"""
from __future__ import annotations

import warnings

from .. import model as _model

__all__ = ["save_rnn_checkpoint", "load_rnn_checkpoint", "do_rnn_checkpoint",
           "rnn_unroll"]


def _cells_of(cells):
    return cells if isinstance(cells, (list, tuple)) else [cells]


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    """Save checkpoint with cell weights packed into fused blobs."""
    for cell in _cells_of(cells):
        arg_params = cell.pack_weights(arg_params)
    _model.save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """Load checkpoint, unpacking fused blobs into per-gate cell weights."""
    sym, arg, aux = _model.load_checkpoint(prefix, epoch)
    for cell in _cells_of(cells):
        arg = cell.unpack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch-end callback mirroring callback.do_checkpoint (rnn/rnn.py:56)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)
    return _callback


def rnn_unroll(cell, length, inputs=None, begin_state=None,
               input_prefix="", layout="NTC"):
    """Deprecated alias for cell.unroll (parity rnn/rnn.py:26)."""
    del input_prefix
    warnings.warn("rnn_unroll is deprecated; call cell.unroll directly.")
    return cell.unroll(length=length, inputs=inputs,
                       begin_state=begin_state, layout=layout)
