"""The port's operators: registry plus the op modules that register into it."""
from . import registry
from . import collective
from . import tensor
from . import epilogue
from . import nn
from . import attention
from . import rnn
from . import contrib
from . import random_ops

__all__ = ["registry", "collective", "tensor", "epilogue", "nn",
           "attention", "rnn", "contrib", "random_ops"]
