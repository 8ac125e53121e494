"""The port's operators: registry plus the op modules that register into it."""
from . import registry
from . import tensor
from . import nn
from . import attention

__all__ = ["registry", "tensor", "nn", "attention"]
