"""Device meshes of port contexts, and process identity.

Counterpart of ``mxtpu/parallel/mesh.py``: ``make_mesh`` (:50) and
``current_mesh`` (:69), with one truth shared with
``sharding.current()``; ``process_index`` / ``process_count`` /
``host_barrier`` over ``torch.distributed`` when the process has joined a
group (one process otherwise); ``mesh_put`` (:27) splits a global tensor
into the per-device shards a spec names.

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
           "axis_devices"]


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
