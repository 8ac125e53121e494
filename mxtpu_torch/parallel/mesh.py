"""Device meshes of port contexts, and process identity.

Counterpart of ``mxtpu/parallel/mesh.py``: ``make_mesh`` (:50) and
``current_mesh`` (:69), with one truth shared with
``sharding.current()``; ``process_index`` / ``process_count`` /
``host_barrier`` over ``torch.distributed`` when the process has joined a
group (one process otherwise); ``mesh_put`` (:27) splits a global tensor
into the per-device shards a spec names.

``ReplicaLayout`` says what each device of a mesh holds when a
``ShardingPlan`` splits parameters over it (one replica a device): its
coordinate on every axis, the rows of the batch it takes (the batch
splits over every axis but ``tp``, whose peers take the same rows and
hold the same activations), which block of each split parameter it keeps
(``local_shape``, ``piece``; ``assemble`` puts the blocks back together)
and the groups of replicas that work together along a set of axes
(``groups``): the ``tp`` group, the ``fsdp`` group, the ``data`` group.

A ``Mesh`` is an n-d array of contexts with one name per axis, the
port's ``jax.sharding.Mesh``: ``devices`` (a numpy object array),
``axis_names`` and ``shape`` ({axis: size}). Its devices default to every
CUDA device; on a host without one, pass ``cpu()`` contexts.
"""
from __future__ import annotations

import numpy as _np

from ..base import MXNetError
from ..context import as_context, gpu, num_gpus

__all__ = ["Mesh", "make_mesh", "current_mesh", "process_index",
           "process_count", "host_barrier", "mesh_put", "axis_size",
           "axis_devices", "ReplicaLayout"]


class Mesh:
    """``devices`` (contexts, in row-major order) laid out as ``shape``
    with one name per axis."""

    def __init__(self, devices, axis_names, shape=None):
        devices = [as_context(d) for d in _np.asarray(
            devices, dtype=object).reshape(-1)]
        shape = tuple(shape) if shape is not None else (len(devices),)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise MXNetError("mesh of shape %s needs %d axis names, got %s"
                             % (shape, len(shape), axis_names))
        if int(_np.prod(shape)) != len(devices):
            raise MXNetError("mesh of shape %s needs %d devices, got %d"
                             % (shape, int(_np.prod(shape)), len(devices)))
        if len(set(devices)) != len(devices):
            raise MXNetError("a mesh names a device twice: %s" % devices)
        arr = _np.empty(len(devices), dtype=object)
        arr[:] = devices
        self.devices = arr.reshape(shape)
        self.axis_names = axis_names

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return self.devices.size

    def __repr__(self):
        return "Mesh(%s)" % ", ".join("%s=%d" % kv
                                      for kv in self.shape.items())


def axis_size(mesh, axis_name):
    """The size of ``axis_name`` on ``mesh`` (a raise names the axes)."""
    sizes = mesh.shape
    if axis_name not in sizes:
        raise MXNetError("mesh %r has no axis %r" % (mesh, axis_name))
    return sizes[axis_name]


def axis_devices(mesh, axis_name, at=None):
    """The contexts along ``axis_name``, the other axes at index ``at``
    ({axis: index}, 0 where not given)."""
    at = dict(at or {})
    idx = tuple(slice(None) if a == axis_name else at.get(a, 0)
                for a in mesh.axis_names)
    axis_size(mesh, axis_name)
    return list(mesh.devices[idx].reshape(-1))


_current = None


def make_mesh(shape=None, axis_names=None, devices=None):
    """A Mesh, by default 1-D ('data',) over every CUDA device; 2-D
    defaults to ('data', 'model'). The mesh becomes the module's ambient
    mesh for :func:`current_mesh`."""
    if devices is None:
        if num_gpus() == 0:
            raise MXNetError("make_mesh: no CUDA device; pass "
                             "devices=[cpu(0), cpu(1), ...]")
        devices = [gpu(i) for i in range(num_gpus())]
    devices = list(devices)
    if shape is None:
        shape = (len(devices),)
    if axis_names is None:
        axis_names = {1: ("data",), 2: ("data", "model"),
                      3: ("data", "model", "pipeline"),
                      4: ("data", "seq", "model", "pipeline")}[len(shape)]
    n = int(_np.prod(shape))
    if n > len(devices):
        raise MXNetError("make_mesh: shape %s needs %d devices, %d given"
                         % (tuple(shape), n, len(devices)))
    global _current
    _current = Mesh(devices[:n], axis_names, shape)
    return _current


def current_mesh():
    """The ambient mesh, most explicit first: an active
    ``mxtpu_torch.sharding`` scope, then a :func:`make_mesh` mesh, then
    ``MXTPU_MESH``, then lazily the 1-D default over every CUDA device."""
    from .. import sharding
    m = sharding.active_mesh()
    if m is not None:
        return m
    if _current is not None:
        return _current
    ctx = sharding.from_env()
    if ctx is not None:
        return ctx.mesh
    return make_mesh()


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def process_index():
    """This process's rank in the joined ``torch.distributed`` group, 0
    without one."""
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


def process_count():
    """The joined group's size, 1 without one."""
    dist = _dist()
    return dist.get_world_size() if dist is not None else 1


def host_barrier():
    """Every process of the joined group reaches this point (a no-op for
    one process)."""
    dist = _dist()
    if dist is not None:
        dist.barrier()


def _shard_index(mesh, coord, entry):
    """(index, count) of the device at ``coord`` along the axes of one
    spec entry (axes major to minor)."""
    axes = entry if isinstance(entry, tuple) else (entry,)
    idx, count = 0, 1
    for a in axes:
        k = mesh.axis_names.index(a)
        idx = idx * mesh.devices.shape[k] + coord[k]
        count *= mesh.devices.shape[k]
    return idx, count


def mesh_put(mesh, value, spec):
    """``value`` (a tensor) as one tensor per mesh device, in the mesh's
    flat order: each dim a spec entry names split over that entry's axes,
    the rest whole; each piece on its device."""
    entries = tuple(spec)
    if len(entries) > value.dim():
        raise MXNetError("mesh_put: spec %s has more entries than %s has "
                         "dims" % (entries, tuple(value.shape)))
    out = []
    for coord in _np.ndindex(*mesh.devices.shape):
        piece = value
        for dim, entry in enumerate(entries):
            if entry is None:
                continue
            i, n = _shard_index(mesh, coord, entry)
            if value.shape[dim] % n:
                raise MXNetError("mesh_put: dim %d (%d) does not split %d "
                                 "ways" % (dim, value.shape[dim], n))
            step = value.shape[dim] // n
            piece = piece.narrow(dim, i * step, step)
        out.append(piece.to(mesh.devices[coord].torch_device))
    return out


def _axes(entry):
    """The axes of one spec entry as a tuple (``None`` -> ())."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


class ReplicaLayout:
    """Replica r is the r-th device of ``mesh`` in row-major order, at
    ``coords[r]`` ({axis: index}). The rows of the batch split over
    ``row_axes`` (every axis but ``tp_axis``): replica r takes row slice
    ``row_index[r]`` of ``n_row_slices``, and its tp peers take the same
    slice. ``specs`` ({name: PartitionSpec}) keeps the parameters that
    split a dimension: replica r holds, of each split dimension, the
    block at its index along that entry's axes (major to minor), as
    ``mesh_put`` places it. ``leads`` are the replicas at tp index 0, one
    for each row slice."""

    def __init__(self, mesh, specs=None, tp_axis="tp"):
        self.mesh = mesh
        self.axis_names = tuple(mesh.axis_names)
        self.sizes = dict(mesh.shape)
        self.coords = [dict(zip(self.axis_names, c))
                       for c in _np.ndindex(*mesh.devices.shape)]
        self.n = len(self.coords)
        self.tp_axis = tp_axis if self.sizes.get(tp_axis, 1) > 1 else None
        self.row_axes = tuple(a for a in self.axis_names
                              if a != self.tp_axis)
        self.specs = {k: tuple(_axes(e) for e in v)
                      for k, v in (specs or {}).items()
                      if any(_axes(e) for e in v)}
        self.n_row_slices = int(_np.prod([self.sizes[a]
                                          for a in self.row_axes]))
        self.row_index = [self.index(r, self.row_axes)
                          for r in range(self.n)]
        self.leads = [r for r in range(self.n) if self.tp_axis is None
                      or self.coords[r][self.tp_axis] == 0]
        self._groups = {}

    @property
    def key(self):
        """What decides the replicas' arrays: the mesh and the specs."""
        return (self.axis_names, tuple(self.mesh.devices.shape),
                tuple(self.mesh.devices.flat),
                tuple(sorted(self.specs.items())))

    @property
    def couples(self):
        """Whether the replicas must run as one walk even at inference: a
        parameter is split, or tp peers share rows."""
        return bool(self.specs) or self.tp_axis is not None

    def index(self, r, axes):
        """Replica r's index along ``axes`` (major to minor)."""
        i = 0
        for a in axes:
            i = i * self.sizes[a] + self.coords[r][a]
        return i

    def groups(self, axes):
        """The replicas grouped by their coordinates off ``axes``: each
        group ordered by its members' index along ``axes``, the groups in
        the order of their first replica."""
        axes = tuple(axes)
        got = self._groups.get(axes)
        if got is None:
            by_rest = {}
            for r in range(self.n):
                rest = tuple(self.coords[r][a] for a in self.axis_names
                             if a not in axes)
                by_rest.setdefault(rest, []).append(r)
            got = [sorted(g, key=lambda r: self.index(r, axes))
                   for g in by_rest.values()]
            self._groups[axes] = got
        return got

    def split_axes(self, name):
        """Every mesh axis that splits a dimension of ``name``."""
        return {a for e in self.specs.get(name, ()) for a in e}

    def reduce_axes(self, name):
        """The row axes over which the replicas' gradients of ``name``
        still have to be summed after the backward: those its spec does
        not split (a gather over a row axis sums its gradient there)."""
        split = self.split_axes(name)
        return tuple(a for a in self.row_axes if a not in split)

    def local_shape(self, name, shape):
        """The shape of the block of ``name`` each replica holds."""
        out = list(shape)
        for d, axes in enumerate(self.specs.get(name, ())):
            if axes:
                out[d] //= int(_np.prod([self.sizes[a] for a in axes]))
        return tuple(out)

    def _blocks(self, name, shape, r):
        """Replica r's slices of a full array of ``shape``."""
        out = []
        entries = self.specs.get(name, ())
        for d, size in enumerate(shape):
            axes = entries[d] if d < len(entries) else ()
            if not axes:
                out.append(slice(None))
                continue
            k = size // int(_np.prod([self.sizes[a] for a in axes]))
            i = self.index(r, axes)
            out.append(slice(i * k, (i + 1) * k))
        return tuple(out)

    def piece(self, name, value, r):
        """Replica r's block of the full ``value`` (a tensor or numpy
        array; a view)."""
        if name not in self.specs:
            return value
        return value[self._blocks(name, tuple(value.shape), r)]

    def assemble(self, name, pieces):
        """The full array of ``name`` from one block per replica (tensors
        on one device, or numpy arrays)."""
        if name not in self.specs:
            return pieces[0]
        first = pieces[0]
        shape = [s * int(_np.prod([self.sizes[a] for a in axes]))
                 if axes else s for s, axes in zip(
                     first.shape, self.specs[name] + ((),) * first.ndim)]
        if isinstance(first, _np.ndarray):
            full = _np.empty(shape, first.dtype)
        else:
            import torch
            full = torch.empty(shape, dtype=first.dtype,
                               device=first.device)
        for r, p in enumerate(pieces):
            full[self._blocks(name, tuple(shape), r)] = p
        return full
