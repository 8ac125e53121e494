"""Module API: a symbol bound on a list of device contexts with its
parameters and optimizer (``Module``), the executor group it runs
(``DataParallelExecutorGroup``), the fused update it arms, and
``BucketingModule``, one Module per bucket over shared parameters."""
from .base_module import BaseModule, BatchEndParam
from .executor_group import DataParallelExecutorGroup
from .fused import FusedTrainStep
from .module import Module
from .bucketing_module import BucketingModule

__all__ = ["BaseModule", "BatchEndParam", "DataParallelExecutorGroup",
           "FusedTrainStep", "Module", "BucketingModule"]
