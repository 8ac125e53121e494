"""Sums over replicas: one value per replica (each context's copy), summed
into every replica.

``sum_replicas`` sums in place with one collective: the in-process NCCL
all-reduce (``torch.cuda.nccl``) across distinct CUDA devices, every
replica then holding the same bits; on the CPU, where contexts share the
host, the replicas added in order and the total copied back.
``ReplicaSum`` is the same sum under autograd (its gradient is the sum of
the replicas' gradients, the same collective again): the executor's
replica walk reduces a coupled op's partial results with it (BatchNorm's
statistics), and the fused step sums the replicas' gradients with
``sum_replicas``. mxtpu has no hand-written kernel here: under GSPMD XLA
lowers both to its collectives.
"""
from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ["sum_replicas", "ReplicaSum"]


def sum_replicas(buffers):
    """Sum ``buffers`` (one contiguous tensor per replica, one shape) into
    every one of them, in place."""
    if len(buffers) == 1:
        return
    if buffers[0].device.type == "cuda":
        devs = {b.device for b in buffers}
        if len(devs) != len(buffers):
            raise MXNetError("replicas share a CUDA device: each context "
                             "must be its own device")
        from torch.cuda import nccl
        if not nccl.is_available(buffers):
            raise MXNetError("NCCL cannot sum these buffers (devices %s)"
                             % sorted(str(d) for d in devs))
        nccl.all_reduce(buffers)
        return
    total = buffers[0]
    for b in buffers[1:]:
        total = total + b
    for b in buffers:
        b.copy_(total)


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
