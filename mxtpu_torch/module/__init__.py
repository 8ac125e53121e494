"""Module API: a symbol bound on a list of device contexts with its
parameters and optimizer (``Module``), the executor group it runs
(``DataParallelExecutorGroup``), and the fused update it arms."""
from .base_module import BaseModule, BatchEndParam
from .executor_group import DataParallelExecutorGroup
from .fused import FusedTrainStep
from .module import Module

__all__ = ["BaseModule", "BatchEndParam", "DataParallelExecutorGroup",
           "FusedTrainStep", "Module"]
