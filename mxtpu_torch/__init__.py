"""mxtpu_torch — the PyTorch/CUDA port of mxtpu.

A second package beside ``mxtpu`` (the JAX reference), mirroring its
module layout and public names. It imports torch and numpy, never JAX
or ``mxtpu``. Its TPU kernels become hand-written CUDA kernels for Hopper
(``csrc/``, built on first use by ``build.py``), each with a plain
PyTorch version beside it: a CPU tensor takes the plain version, a CUDA
tensor the kernel, and nothing falls back. Entry points default to the
card (``gpu(0)``) and raise without one unless given ``cpu()``.

Ported so far: serving (Symbol, NDArray, Executor, Predictor,
ServingSession) of the transformer LM and the image-classification zoo,
with the flash-attention forward and BN-apply+ReLU epilogue kernels;
training through ``Module`` (``fit``, the fused update, optimizers,
metrics, ``NDArrayIter``) with the flash-attention backward kernel, and
of the conv nets with BatchNorm on batch statistics; the device
prefetcher; checkpoints in mxtpu's file formats (``model``); and the
imperative frontends: ``autograd`` on torch's tape, the NDArray and
``nd.<op>`` surface, and ``gluon`` (blocks, hybridize through the
executor's walk, Trainer, losses, DataLoader, the ResNet zoo).
"""
from . import base
from .base import MXNetError
from . import context
from .context import Context, cpu, current_context, gpu, num_gpus
from . import ops
from . import symbol
from . import symbol as sym
from . import autograd
from . import ndarray
from . import ndarray as nd
from . import executor
from . import predict
from .predict import Predictor
from . import serving
from . import models
from . import convert
from . import build
from . import random
from . import initializer
from . import initializer as init
from . import lr_scheduler
from . import optimizer
from . import metric
from . import io
from . import model
from . import callback
from . import module
from . import module as mod
from . import gluon

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context",
           "num_gpus", "ops", "symbol", "sym", "ndarray", "nd", "executor",
           "predict", "Predictor", "serving", "models", "convert", "build",
           "random", "initializer", "init", "lr_scheduler", "optimizer",
           "metric", "io", "model", "callback", "module", "mod",
           "autograd", "gluon"]
