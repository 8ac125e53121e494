"""mxtpu_torch.parallel — execution over device meshes.

Counterpart of ``mxtpu/parallel``: meshes of port contexts
(``make_mesh``, ``current_mesh``) and process identity over
``torch.distributed``; ``DataParallelTrainer`` over the Module's fused
step; sequence parallelism (``ring_attention``, ``ulysses_attention``)
on the hand-written flash kernels; expert parallelism (``moe_apply``,
``moe_apply_topk``) and pipeline parallelism (``pipeline_apply``) over
the collectives of ``ops.collective``.
"""
from .mesh import (current_mesh, host_barrier, make_mesh, process_count,
                   process_index)
from .dp import DataParallelTrainer, shard_params_spec
from .ring_attention import (ring_attention, blockwise_attention,
                             ulysses_attention)
from .moe import load_balancing_loss, moe_apply, moe_apply_topk
from .pipeline import pipeline_apply, stack_stage_params

__all__ = ["make_mesh", "current_mesh", "host_barrier", "process_index",
           "process_count", "DataParallelTrainer", "shard_params_spec",
           "ring_attention", "blockwise_attention", "ulysses_attention",
           "moe_apply", "moe_apply_topk", "load_balancing_loss",
           "pipeline_apply", "stack_stage_params"]
