"""The port's operators: registry plus the op modules that register into it."""
from . import registry
from . import collective
from . import tensor
from . import epilogue
from . import nn
from . import attention
from . import rnn

__all__ = ["registry", "collective", "tensor", "epilogue", "nn",
           "attention", "rnn"]
