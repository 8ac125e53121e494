"""Module API: a symbol bound on a list of device contexts with its
parameters and optimizer (``Module``), the executor group it runs
(``DataParallelExecutorGroup``), the fused update it arms, and
``BucketingModule``, one Module per bucket over shared parameters;
``SequentialModule`` chains modules, and ``PythonModule`` /
``PythonLossModule`` are modules written in plain Python."""
from .base_module import BaseModule, BatchEndParam
from .executor_group import DataParallelExecutorGroup
from .fused import FusedTrainStep
from .module import Module
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule
from .python_module import PythonModule, PythonLossModule

__all__ = ["BaseModule", "BatchEndParam", "DataParallelExecutorGroup",
           "FusedTrainStep", "Module", "BucketingModule", "SequentialModule",
           "PythonModule", "PythonLossModule"]
