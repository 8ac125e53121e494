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
executor's walk, Trainer, losses, DataLoader, the ResNet zoo); data
parallelism: ``kvstore`` (local/device and dist_sync over
``torch.distributed``), Module over a context list (one executor per
context, BatchNorm over the whole batch on the fused step) and Gluon's
Parameter and Trainer over several contexts; the mesh: ``sharding``
(``MeshContext``, ``ShardingPlan``; ``Module.fit(mesh=...)`` with
cross-replica weight-update sharding) and ``parallel`` (ring and Ulysses
attention on the flash kernels, mixture of experts, pipelines,
``DataParallelTrainer``); ``elastic`` (async snapshots of a fit,
``fit(elastic=..., resume=...)`` exact to the bit, the ``Supervisor``'s
restore-retry and SIGTERM preemption); RNNs and bucketing (``rnn``,
``BucketingModule``); the SSD detector (``models.ssd``, the MultiBox ops
of ``ops/contrib.py`` with the suppression sweep as a CUDA kernel,
``MakeLoss``, ``smooth_l1``) with ``models.ssd_data``'s synthetic boxes
and metrics, and ``test_utils.default_context``; the inference and
inspection surface: ``Module.predict``/``iter_predict``, ``monitor``
(``Monitor`` over the executors' per-op walk), ``SequentialModule``,
``PythonLossModule``, ``model.FeedForward``, ``Symbol.get_internals``
and its kin, and ``Predictor.partial_forward``/``forward_batch``/
``reshaped`` with ``predict.create`` and ``load_checkpoint_predictor``;
the record pipeline: ``recordio`` and its native reader over
``src/core`` (``_native``, built with g++ on first use), ``image`` (cv2
decode, the augmenters, ``ImageIter``, ``ImageDetIter``),
``image_record`` (``ImageRecordIter`` and its kin over the native
prefetch thread), the rest of ``io`` and ``metric.TopKAccuracy``; the
rest of the Python frontend's names: every metric, optimizer and
initializer of mxtpu, ``callback.ProgressBar`` and
``LogValidationMetricsCallback``, ``context.num_devices``, ``random``'s
samplers with their 15 ops (``ops/random_ops.py``), ``visualization``,
``executor_manager``, ``libinfo`` and ``symbol_doc``; the op library's
spatial, custom and update ops (``ops/spatial.py`` with ROIPooling as a
CUDA kernel, ``ops/custom.py`` over ``operator``'s ``CustomOp`` and
``CustomOpProp``, ``ops/optimizer_ops.py``) and the Faster R-CNN
(``models.rcnn``); the scaffolding under all of it: ``telemetry``
(metrics, correlated spans, Prometheus and JSON exposition under mxtpu's
series names), ``faults`` (seeded injection points, ``RetryPolicy``),
``tune`` (the knob registry and ``TunedConfig``, read by
``Module.fit(tuned=...)``), ``engine`` (the native dependency engine),
``profiler`` (chrome trace + a ``torch.profiler`` session),
``analysis`` (findings and the concurrency witness), ``diagnostics``'
flight recorder, ``log``, ``name`` and ``registry``; and the compile
pipeline: ``compile`` (the one build seam, graph rewrites by name:
``layout``, ``bf16``, ``quant``, ``fuse_opt``, ``remat_reuse``;
``compile.quant``'s calibration), ``analysis``' pass web (the verifier
passes behind ``Symbol.lint``/``Module.check``, the dataflow analyses,
certification, the fuzzer, the numerics sanitizer) and ``diagnostics``'
program table.
"""
from .libinfo import __version__
from . import base
from .base import MXNetError
# the scaffolding layer first: every later module may emit into it
from . import analysis
from . import telemetry
from . import diagnostics
from . import obs
from . import faults
from . import tune
from . import profiler
from . import log
from . import registry
from . import context
from .context import Context, cpu, current_context, gpu, num_gpus
from . import attribute
from .attribute import AttrScope
from . import ops
from . import operator
from . import symbol
from . import symbol as sym
from . import name
from . import autograd
from . import ndarray
from . import ndarray as nd
from . import executor
from . import compile  # noqa: A004  (mxtpu's name)
from .analysis import sanitizer as _sanitizer  # MXTPU_SANITIZE arming
from . import predict
from .predict import Predictor
from . import serving
from . import models
from . import convert
from . import build
from . import random
from . import random as rnd
from . import symbol_doc
from . import libinfo
from . import initializer
from . import initializer as init
from . import lr_scheduler
from . import optimizer
from . import metric
from . import io
from . import recordio
from . import engine
from . import image
from . import image_record
from . import kvstore
from . import kvstore as kv
from . import model
from . import callback
from . import monitor
from . import module
from . import module as mod
from . import rnn
from . import gluon
from . import sharding
from . import parallel
from . import elastic
from . import visualization
from . import visualization as viz
from . import executor_manager
from . import test_utils

__all__ = ["__version__", "MXNetError", "AttrScope", "attribute", "Context",
           "cpu", "gpu", "current_context", "num_gpus", "ops", "operator",
           "symbol", "sym", "ndarray", "nd", "executor",
           "predict", "Predictor", "serving", "models", "convert", "build",
           "random", "rnd", "symbol_doc", "libinfo", "initializer", "init",
           "lr_scheduler", "optimizer",
           "metric", "io", "recordio", "image", "image_record", "kvstore",
           "kv", "model", "callback", "monitor", "module", "mod",
           "autograd", "gluon", "sharding", "parallel", "elastic", "rnn",
           "visualization", "viz", "executor_manager", "test_utils",
           "analysis", "telemetry", "diagnostics", "obs", "faults", "tune",
           "profiler", "log", "registry", "name", "engine"]
