"""Collectives over replicas: one value per replica (each mesh device's
copy), in mesh order.

``sum_replicas`` sums in place with one collective: the in-process NCCL
all-reduce (``torch.cuda.nccl``) across distinct CUDA devices, every
replica then holding the same bits; on the CPU, where contexts share the
host, the replicas added in order and the total copied back.
``ReplicaSum`` is the same sum under autograd (its gradient is the sum of
the replicas' gradients, the same collective again): the executor's
replica walk reduces a coupled op's partial results with it (BatchNorm's
statistics), and the fused step sums the replicas' gradients with
``sum_replicas``.

The mesh adds four more, each a single call over all replicas:

- ``reduce_scatter_replicas``: replica r gets the r-th of n equal chunks
  of the sum (NCCL reduce-scatter); the fused step's weight-update
  sharding reduces the gradients with it.
- ``all_gather_replicas``: every replica gets the n chunks in replica
  order (NCCL all-gather); the fused step gathers the updated rows.
- ``ppermute(values, perm)``: value i moves to replica j for each pair
  (i, j) of ``perm``; a replica no pair reaches gets zeros (lax.ppermute).
- ``all_to_all(values, split_axis, concat_axis)``: each value is cut in n
  chunks along ``split_axis``; replica j gets chunk j of every replica,
  concatenated in replica order along ``concat_axis``.

``torch.cuda.nccl`` has no all-to-all and no send/recv, so the last two
are peer copies (``Tensor.to``, over NVLink where the cards have it):
PyTorch orders such a copy after the work queued on both cards' current
streams and queues what follows after it. ``PPermute`` and ``AllToAll``
are their differentiable forms, for the pipeline's and Ulysses'
backward: the gradient of each is the transposed collective (the
inverse permutation, the all-to-all with its axes swapped). On the CPU every collective works in
replica order on the host. mxtpu has no hand-written kernel here: under
GSPMD and ``shard_map`` XLA lowers these to its collectives.
"""
from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ["sum_replicas", "ReplicaSum", "reduce_scatter_replicas",
           "all_gather_replicas", "ppermute", "all_to_all", "PPermute",
           "AllToAll"]


def _nccl(buffers, what):
    """``torch.cuda.nccl`` for buffers on distinct CUDA devices, or a
    raise."""
    devs = {b.device for b in buffers}
    if len(devs) != len(buffers):
        raise MXNetError("%s: replicas share a CUDA device: each context "
                         "must be its own device" % what)
    from torch.cuda import nccl
    if not nccl.is_available(buffers):
        raise MXNetError("NCCL cannot %s these buffers (devices %s)"
                         % (what, sorted(str(d) for d in devs)))
    return nccl


def _on_cuda(buffers):
    kinds = {b.device.type for b in buffers}
    if len(kinds) > 1:
        raise MXNetError("replicas on mixed device types %s" % sorted(kinds))
    return kinds == {"cuda"}


def sum_replicas(buffers):
    """Sum ``buffers`` (one contiguous tensor per replica, one shape) into
    every one of them, in place."""
    if len(buffers) == 1:
        return
    if _on_cuda(buffers):
        _nccl(buffers, "sum").all_reduce(buffers)
        return
    total = buffers[0]
    for b in buffers[1:]:
        total = total + b
    for b in buffers:
        b.copy_(total)


def reduce_scatter_replicas(inputs, outputs):
    """``outputs[r]`` (n elements fewer times than ``inputs[r]``) <- the
    r-th chunk of ``sum_k inputs[k]``, every tensor contiguous; one NCCL
    reduce-scatter on CUDA, the sum in replica order on the CPU."""
    n = len(inputs)
    if len(outputs) != n or any(i.numel() != o.numel() * n
                                for i, o in zip(inputs, outputs)):
        raise MXNetError("reduce_scatter: %d inputs of %s elements for %d "
                         "outputs of %s" % (
                             n, [i.numel() for i in inputs], len(outputs),
                             [o.numel() for o in outputs]))
    if n == 1:
        outputs[0].copy_(inputs[0].view(outputs[0].shape))
        return
    if _on_cuda(inputs):
        _nccl(inputs, "reduce-scatter").reduce_scatter(inputs, outputs)
        return
    total = inputs[0]
    for x in inputs[1:]:
        total = total + x
    chunks = total.reshape(n, -1)
    for r, o in enumerate(outputs):
        o.copy_(chunks[r].view(o.shape))


def all_gather_replicas(inputs, outputs):
    """``outputs[r]`` <- the ``inputs`` in replica order, for every r
    (each output n times an input's elements, all contiguous); one NCCL
    all-gather on CUDA, copies on the CPU."""
    n = len(inputs)
    if len(outputs) != n or any(o.numel() != i.numel() * n
                                for i, o in zip(inputs, outputs)):
        raise MXNetError("all_gather: %d inputs of %s elements for %d "
                         "outputs of %s" % (
                             n, [i.numel() for i in inputs], len(outputs),
                             [o.numel() for o in outputs]))
    if n > 1 and _on_cuda(inputs):
        _nccl(inputs, "all-gather").all_gather(inputs, outputs)
        return
    for o in outputs:
        rows = o.view(n, -1)
        for s, x in enumerate(inputs):
            rows[s].copy_(x.reshape(-1))


def ppermute(values, perm):
    """``out[j] = values[i]`` moved to replica j's device for each (i, j)
    of ``perm``; zeros where no pair lands (lax.ppermute's rule)."""
    out = [None] * len(values)
    for i, j in perm:
        if out[j] is not None:
            raise MXNetError("ppermute: replica %d receives twice in %s"
                             % (j, list(perm)))
        out[j] = values[i].to(values[j].device, copy=True)
    return [torch.zeros_like(v) if o is None else o
            for v, o in zip(values, out)]


def all_to_all(values, split_axis, concat_axis):
    """Replica j gets chunk j (along ``split_axis``) of every value,
    concatenated in replica order along ``concat_axis``, on its own
    device."""
    n = len(values)
    for v in values:
        if v.shape[split_axis] % n:
            raise MXNetError("all_to_all: axis %d of %s does not split %d "
                             "ways" % (split_axis, tuple(v.shape), n))
    chunks = [v.chunk(n, dim=split_axis) for v in values]
    return [torch.cat([c[j].to(values[j].device) for c in chunks],
                      dim=concat_axis) for j in range(n)]


class PPermute(torch.autograd.Function):
    """``ppermute`` under autograd; the backward moves each gradient back
    along the inverse permutation."""

    @staticmethod
    def forward(ctx, perm, *values):
        ctx.perm = [(j, i) for i, j in perm]
        return tuple(ppermute(list(values), perm))

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(ppermute(list(grads), ctx.perm))


class AllToAll(torch.autograd.Function):
    """``all_to_all`` under autograd; its gradient is the all-to-all back
    (split and concatenation axes swapped)."""

    @staticmethod
    def forward(ctx, split_axis, concat_axis, *values):
        ctx.axes = (split_axis, concat_axis)
        return tuple(all_to_all(list(values), split_axis, concat_axis))

    @staticmethod
    def backward(ctx, *grads):
        split_axis, concat_axis = ctx.axes
        return (None, None) + tuple(all_to_all(list(grads), concat_axis,
                                               split_axis))


class ReplicaSum(torch.autograd.Function):
    """``(x_0, ..., x_n-1) -> (s, ..., s)`` with ``s = sum_k x_k``, each
    ``s`` on its replica's device; the backward sums the replicas'
    gradients the same way."""

    @staticmethod
    def forward(ctx, *xs):
        outs = [x.detach().clone(memory_format=torch.contiguous_format)
                for x in xs]
        sum_replicas(outs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        gs = [g.clone(memory_format=torch.contiguous_format)
              for g in grads]
        sum_replicas(gs)
        return tuple(gs)
