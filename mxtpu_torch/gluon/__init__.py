"""Gluon: the imperative and hybridizable frontend (counterpart of
``mxtpu/gluon/``): Parameter, Block/HybridBlock/SymbolBlock, the nn
layers, the recurrent cells and layers (``rnn``), losses, Trainer, data
and the ResNet model zoo."""
from .parameter import DeferredInitializationError, Parameter, ParameterDict
from .block import Block, HybridBlock, SymbolBlock
from .trainer import Trainer
from . import nn
from . import rnn
from . import loss
from . import data
from . import model_zoo
from . import utils
from .utils import split_and_load, split_data

