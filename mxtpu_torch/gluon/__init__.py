"""Gluon: the imperative and hybridizable frontend (counterpart of
``mxtpu/gluon/``): Parameter, Block/HybridBlock/SymbolBlock, the nn
layers, losses, Trainer, data and the ResNet model zoo. ``gluon.rnn``
comes with the RNN ops (ROADMAP A.6) and raises until then."""
from ..base import MXNetError
from .parameter import DeferredInitializationError, Parameter, ParameterDict
from .block import Block, HybridBlock, SymbolBlock
from .trainer import Trainer
from . import nn
from . import loss
from . import data
from . import model_zoo
from . import utils
from .utils import split_and_load, split_data


def __getattr__(name):
    if name == "rnn":
        raise MXNetError("gluon.rnn needs the RNN ops, which are not ported "
                         "yet (ROADMAP A.6)")
    raise AttributeError(name)
