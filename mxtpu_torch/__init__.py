"""mxtpu_torch — the PyTorch/CUDA port of mxtpu.

A second package beside ``mxtpu`` (the JAX reference), mirroring its
module layout and public names. It imports torch and numpy, never JAX
or ``mxtpu``. Its TPU kernels become hand-written CUDA kernels for Hopper
(``csrc/``, built on first use by ``build.py``), each with a plain
PyTorch version beside it: a CPU tensor takes the plain version, a CUDA
tensor the kernel, and nothing falls back. Entry points default to the
card (``gpu(0)``) and raise without one unless given ``cpu()``.

Ported so far: the transformer LM's serving path (Symbol, NDArray,
Executor, Predictor, ServingSession) with the flash-attention forward
kernel.
"""
from . import base
from .base import MXNetError
from . import context
from .context import Context, cpu, current_context, gpu, num_gpus
from . import ops
from . import symbol
from . import symbol as sym
from . import ndarray
from . import ndarray as nd
from . import executor
from . import predict
from .predict import Predictor
from . import serving
from . import models
from . import convert
from . import build

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context",
           "num_gpus", "ops", "symbol", "sym", "ndarray", "nd", "executor",
           "predict", "Predictor", "serving", "models", "convert", "build"]
