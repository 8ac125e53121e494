"""Pipeline parallelism over a mesh axis (GPipe-style microbatching).

Counterpart of ``mxtpu/parallel/pipeline.py``: ``stack_stage_params``
(:29) and ``pipeline_apply`` (:35). Device s of the ``axis_name`` axis
holds stage s's slice of the stacked parameters; the batch splits into
microbatches and runs mxtpu's tick schedule: ``n_micro + n_stages - 1``
ticks, at each every stage runs ``stage_fn(params, x)`` on the activation
it holds (stage 0 on the next microbatch, zeros after the last), the last
stage emits microbatch ``t - n_stages + 1`` once that is >= 0, and the
activations move one stage on (``PPermute``, i -> i+1). Each stage's
launches go to its own device, so after the fill the stages compute at
once. With ``batch_axis`` (dp x pp on a 2-D mesh) each row of that axis
runs its own pipeline on its contiguous block of the batch, the stage
parameters copied to every row. ``stage_fn`` maps a dict of tensors and
a (microbatch, ...) tensor to one of the same shape. Gradients reach the
input and the stacked parameters through autograd.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..ops.collective import PPermute
from .mesh import axis_devices, axis_size, current_mesh

__all__ = ["pipeline_apply", "stack_stage_params"]


def stack_stage_params(stage_params_list):
    """Per-stage dicts of tensors stacked on a new leading stage axis."""
    keys = stage_params_list[0].keys()
    return {k: torch.stack([p[k] for p in stage_params_list])
            for k in keys}


def _run_row(stage_fn, stacked, xl, devs, n_micro):
    """One pipeline over ``devs`` on ``xl`` (this row's batch); returns
    the last stage's outputs, microbatches in order."""
    n_stages = len(devs)
    mb = xl.shape[0] // n_micro
    params = [{k: v[s].to(dev) for k, v in stacked.items()}
              for s, dev in enumerate(devs)]
    micro = xl.to(devs[0]).reshape(n_micro, mb, *xl.shape[1:])
    acts = [xl.new_zeros((mb,) + tuple(xl.shape[1:]), device=dev)
            for dev in devs]
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    emitted = []
    for t in range(n_micro + n_stages - 1):
        acts[0] = micro[t] if t < n_micro else torch.zeros_like(micro[0])
        outs = [stage_fn(p, a) for p, a in zip(params, acts)]
        if t >= n_stages - 1:
            emitted.append(outs[-1])
        acts = list(PPermute.apply(perm, *outs))
    return torch.cat(emitted)


def pipeline_apply(stage_fn, stacked_params, x, mesh=None,
                   axis_name="pipe", num_microbatches=None,
                   batch_axis=None):
    """``x`` (batch, ...) through the n_stages stages of
    ``stacked_params`` (leading stage axis) pipelined over the mesh axis
    ``axis_name``; ``batch_axis`` composes data parallelism. Returns the
    last stage's (batch, ...) output on ``x``'s device."""
    if mesh is None:
        mesh = current_mesh()
    n_stages = axis_size(mesh, axis_name)
    n_micro = num_microbatches if num_microbatches is not None \
        else n_stages
    dp = axis_size(mesh, batch_axis) if batch_axis else 1
    batch = x.shape[0]
    if n_micro < 1 or batch % (n_micro * dp):
        raise MXNetError("batch %d must divide into %d microbatches on "
                         "every one of %d data-parallel rows"
                         % (batch, n_micro, dp))
    rows = batch // dp
    outs = []
    for row in range(dp):
        devs = [c.torch_device for c in axis_devices(
            mesh, axis_name, {batch_axis: row} if batch_axis else None)]
        outs.append(_run_row(stage_fn, stacked_params,
                             x[row * rows:(row + 1) * rows], devs,
                             n_micro).to(x.device))
    return torch.cat(outs)
