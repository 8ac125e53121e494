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

Over subgroups of the replicas (a ``ReplicaLayout``'s tp, fsdp or data
groups: each group one collective over its own devices, NCCL caching a
communicator per device set), ``all_reduce_groups``,
``all_gather_groups`` and ``reduce_scatter_groups`` run the three
collectives along any dimension; each call over all groups adds one to
``calls[(kind, axis)]``. Their autograd forms serve a parameter split
over the mesh. A tensor that tp peers hold as copies (they take the same
rows of the batch) carries on each peer the whole gradient of those
rows, so the collectives that cross tp transpose in that sense:

- ``GatherAlong``: the blocks of a group concatenated along a dimension.
  Over a row axis (fsdp: the peers take different rows, so each holds a
  part of the gradient) the backward is the reduce-scatter; over tp it
  is each peer's own block of its gradient.
- ``SplitAlong``: each tp peer's own block of a tensor it holds whole;
  the backward all-gathers the blocks' gradients.
- ``PartialSum``: the sum over a tp group of partial products, every
  peer then holding it; the backward hands each peer's gradient to its
  own partial product.
"""
from __future__ import annotations

from collections import Counter

import torch

from ..base import MXNetError

__all__ = ["sum_replicas", "ReplicaSum", "reduce_scatter_replicas",
           "all_gather_replicas", "ppermute", "all_to_all", "PPermute",
           "AllToAll", "all_reduce_groups", "all_gather_groups",
           "reduce_scatter_groups", "GatherAlong", "SplitAlong",
           "PartialSum", "gather_split", "calls"]

#: (kind, axis) -> the group collectives called, one per call over all
#: of a layout's groups (axis None where the caller names none)
calls = Counter()


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


# ----------------------------------------------------------- subgroups
def all_reduce_groups(buffers, groups, axis=None):
    """Sum ``buffers`` (one per replica) in place within each group."""
    calls[("all_reduce", axis)] += 1
    for g in groups:
        sum_replicas([buffers[i] for i in g])


def all_gather_groups(pieces, groups, dim, axis=None):
    """Each replica's group's ``pieces`` concatenated along ``dim`` in
    group order, on its own device: one all-gather a group."""
    calls[("all_gather", axis)] += 1
    out = [None] * len(pieces)
    for g in groups:
        ins = [pieces[i].contiguous() for i in g]
        bufs = [torch.empty((len(g),) + tuple(x.shape), dtype=x.dtype,
                            device=x.device) for x in ins]
        all_gather_replicas(ins, bufs)
        for i, b, x in zip(g, bufs, ins):
            shape = list(x.shape)
            shape[dim] *= len(g)
            out[i] = b.movedim(0, dim).reshape(shape) if dim else \
                b.reshape(shape)
    return out


def reduce_scatter_groups(values, groups, dim, axis=None):
    """Replica i's block (its position in its group) along ``dim`` of its
    group's sum of ``values``: one reduce-scatter a group."""
    calls[("reduce_scatter", axis)] += 1
    out = [None] * len(values)
    for g in groups:
        k = len(g)
        stages = []
        for i in g:
            x = values[i]
            shape = list(x.shape)
            shape[dim:dim + 1] = [k, shape[dim] // k]
            stages.append(x.reshape(shape).movedim(dim, 0).contiguous())
        outs = [torch.empty(st.shape[1:], dtype=st.dtype, device=st.device)
                for st in stages]
        reduce_scatter_replicas(stages, outs)
        for i, o in zip(g, outs):
            out[i] = o
    return out


def group_positions(groups, n):
    """Each of ``n`` replicas' position in its group."""
    pos = [0] * n
    for g in groups:
        for p, i in enumerate(g):
            pos[i] = p
    return pos


class GatherAlong(torch.autograd.Function):
    """``(dim, groups, rows, axis, *pieces)``: each replica gets its
    group's pieces concatenated along ``dim``. ``rows``: the group's
    peers take different rows of the batch (an fsdp group), and the
    backward reduce-scatters the gradients; otherwise (a tp group) each
    takes its own block of its gradient."""

    @staticmethod
    def forward(ctx, dim, groups, rows, axis, *pieces):
        ctx.args = (dim, groups, rows, axis, pieces[0].shape[dim])
        return tuple(all_gather_groups(list(pieces), groups, dim, axis))

    @staticmethod
    def backward(ctx, *grads):
        dim, groups, rows, axis, size = ctx.args
        if rows:
            got = reduce_scatter_groups(list(grads), groups, dim, axis)
        else:
            pos = group_positions(groups, len(grads))
            got = [g.narrow(dim, p * size, size)
                   for g, p in zip(grads, pos)]
        return (None, None, None, None) + tuple(got)


class SplitAlong(torch.autograd.Function):
    """``(dim, groups, axis, *xs)``: each replica's own block along
    ``dim`` of a tensor its group's peers hold whole; the backward
    all-gathers the blocks' gradients."""

    @staticmethod
    def forward(ctx, dim, groups, axis, *xs):
        ctx.args = (dim, groups, axis)
        pos = group_positions(groups, len(xs))
        k = len(groups[0])
        size = xs[0].shape[dim] // k
        return tuple(x.narrow(dim, p * size, size)
                     for x, p in zip(xs, pos))

    @staticmethod
    def backward(ctx, *grads):
        dim, groups, axis = ctx.args
        return (None, None, None) + tuple(
            all_gather_groups(list(grads), groups, dim, axis))


class PartialSum(torch.autograd.Function):
    """``(groups, axis, *zs)``: every replica gets its group's sum of the
    partial products ``zs``; the backward hands each replica its own
    gradient (its peers hold the same sum and the same gradient)."""

    @staticmethod
    def forward(ctx, groups, axis, *zs):
        outs = [z.contiguous() for z in zs]
        dirty = [z for z, o in zip(zs, outs) if o is z]
        if dirty:  # summed in place: the products are the op's own
            ctx.mark_dirty(*dirty)
        all_reduce_groups(outs, groups, axis)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(grads)


def gather_split(values, name, layout, keep=()):
    """``values`` (each replica's block of the parameter ``name``) with
    every split dimension but those in ``keep`` gathered over its axes,
    the minor axis first (``GatherAlong``), on each replica's device."""
    for d, axes in enumerate(layout.specs.get(name, ())):
        if d in keep:
            continue
        for a in reversed(axes):
            values = list(GatherAlong.apply(d, layout.groups((a,)),
                                            a in layout.row_axes, a,
                                            *values))
    return values
