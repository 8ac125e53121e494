"""Module API: a symbol bound on one device with its parameters and
optimizer (``Module``), and the fused update it arms."""
from .base_module import BaseModule, BatchEndParam
from .fused import FusedTrainStep
from .module import Module

__all__ = ["BaseModule", "BatchEndParam", "FusedTrainStep", "Module"]
