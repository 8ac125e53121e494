"""Data-parallel training of a Symbol over a 1-D data mesh.

Counterpart of ``mxtpu/parallel/dp.py``: ``shard_params_spec`` (:29) and
``DataParallelTrainer`` (:64), over the Module machinery instead of a
second training step: ``init`` binds a ``Module`` over the mesh's
devices (one replica each, the global batch split evenly) and arms its
fused step, and ``step`` is ``forward_backward`` + ``update`` on one
global batch (BatchNorm over the whole batch, as mxtpu's one jitted step
computes it). ``optimizer`` is "sgd" (with momentum) or "adam", with
``learning_rate``, ``momentum``, ``wd`` (on every parameter) and
``rescale_grad`` (default 1.0, as mxtpu's) from ``optimizer_params``.
Adam is mxtpu's trainer's (``_adam`` :52): the bias corrections on the
moments, ``epsilon`` outside them (``TrainerAdam``, the same rule on
every update path; the Module's Adam folds them into lr, which scales
``epsilon``).
``shard_update`` (:83-88) arms the step under a ``ShardingPlan``:
optimizer state and the update shard over ``data`` (reduce-scatter,
update by rows, all-gather); without it the step is the replicated one.
``shard_params=True`` (tensor parallelism over a 'model' axis) is not
ported and raises.
"""
from __future__ import annotations

import numpy as _np
import torch

from .. import optimizer as opt
from ..base import MXNetError
from ..context import cpu
from .mesh import current_mesh
from ..sharding.spec import PartitionSpec as P

__all__ = ["DataParallelTrainer", "TrainerAdam", "shard_params_spec"]


def shard_params_spec(shapes, mesh, axis="model", min_size=2 ** 16):
    """Specs for a {name: shape} dict: dim 0 over ``axis`` when the array
    has at least ``min_size`` elements and the axis divides dim 0;
    replicated otherwise."""
    msize = mesh.shape.get(axis, 1)
    specs = {}
    for name, shape in shapes.items():
        size = int(_np.prod(shape))
        if axis in mesh.axis_names and msize > 1 and size >= min_size and \
                len(shape) >= 1 and shape[0] % msize == 0:
            specs[name] = P(axis, *([None] * (len(shape) - 1)))
        else:
            specs[name] = P()
    return specs


class TrainerAdam(opt.Adam):
    """mxtpu's trainer Adam: ``p -= lr * mhat / (sqrt(vhat) + eps)`` with
    ``mhat = m / (1 - b1^t)``, ``vhat = v / (1 - b2^t)``, t the
    optimizer's ``num_update``. ``update`` (the Updater's and the
    kvstore's path) and the fused step's rule both apply ``step_``."""

    def step_(self, p, g, m, v, lr, wd):
        """The rule on tensors, in place, after ``_update_count``."""
        t = self.num_update
        b1, b2 = self.beta1, self.beta2
        g = opt._prep(g, p, self.rescale_grad, self._clip(), wd)
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        p.sub_(lr * (m / (1 - b1 ** t))
               / (torch.sqrt(v / (1 - b2 ** t)) + self.epsilon))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        with torch.no_grad():
            self.step_(weight._data, grad._data, state[0]._data,
                       state[1]._data, self._get_lr(index),
                       self._get_wd(index))


class DataParallelTrainer:
    """Whole-batch training steps of a Symbol over a 1-D data mesh."""

    def __init__(self, symbol, mesh=None, optimizer="sgd",
                 optimizer_params=None, data_names=("data",),
                 label_names=("softmax_label",), shard_params=False,
                 dtype="float32", shard_update=False):
        if shard_params:
            raise MXNetError("DataParallelTrainer(shard_params=True) shards "
                             "parameters over a 'model' axis: tensor "
                             "parallelism is not ported (1-D data meshes "
                             "only)")
        if optimizer not in ("sgd", "adam"):
            raise MXNetError("DataParallelTrainer: optimizer %r; the port "
                             "runs 'sgd' and 'adam'" % (optimizer,))
        if dtype != "float32":
            raise MXNetError("DataParallelTrainer: dtype %r; float32 only"
                             % (dtype,))
        self.symbol = symbol
        self.mesh = mesh or current_mesh()
        for axis, size in self.mesh.shape.items():
            if axis != "data" and size > 1:
                raise MXNetError("DataParallelTrainer: axis '%s' of size %d;"
                                 " only a 1-D 'data' mesh is ported"
                                 % (axis, size))
        self.data_names = list(data_names)
        self.label_names = list(label_names)
        self.optimizer = optimizer
        op = dict(optimizer_params or {})
        self.lr = op.get("learning_rate", 0.01)
        self.momentum = op.get("momentum", 0.0)
        self.wd = op.get("wd", 0.0)
        self.rescale = op.get("rescale_grad", 1.0)
        self.shard_update = bool(shard_update)
        self.step_count = 0
        self._module = None

    def init(self, input_shapes, initializer=None):
        """Bind over the mesh's devices at the global ``input_shapes``,
        initialize (default ``Xavier(magnitude=2)``) and arm the fused
        step."""
        from .. import sharding
        from ..initializer import Xavier
        from ..module import Module
        mod = Module(self.symbol, data_names=self.data_names,
                     label_names=self.label_names,
                     context=list(self.mesh.devices.flat))
        mod.bind(data_shapes=[(n, input_shapes[n]) for n in self.data_names],
                 label_shapes=[(n, input_shapes[n]) for n in
                               self.label_names if n in input_shapes])
        mod.init_params(initializer or Xavier(magnitude=2.0))
        params = {"learning_rate": self.lr, "wd": self.wd,
                  "rescale_grad": self.rescale}
        # an instance without param_idx2name: wd on every parameter
        optimizer = opt.SGD(momentum=self.momentum, **params) \
            if self.optimizer == "sgd" else TrainerAdam(**params)
        mesh_ctx = sharding.MeshContext(self.mesh) if self.shard_update \
            else sharding.DISABLED
        with sharding.use(mesh_ctx):
            mod.init_optimizer(kvstore=None, optimizer=optimizer)
        if mod._fused is None:
            raise MXNetError("DataParallelTrainer: the fused step did not "
                             "arm (the batch must divide over %d devices)"
                             % self.mesh.size)
        self._module = mod
        return self

    def step(self, batch):
        """One training step on ``batch`` ({name: global array}, numpy or
        NDArray); returns the outputs of the whole batch."""
        from ..io import DataBatch
        from ..ndarray import NDArray, array
        self.step_count += 1

        def arr(v):
            return v if isinstance(v, NDArray) else array(
                _np.asarray(v), ctx=cpu())
        mod = self._module
        mod.forward_backward(DataBatch(
            [arr(batch[n]) for n in self.data_names],
            [arr(batch[n]) for n in self.label_names if n in batch]))
        mod.update()
        return [o._data for o in mod.get_outputs()]

    @property
    def params(self):
        """{name: tensor}, the first replica's (the replicas hold the
        same bits)."""
        ex = self._module._exec_group.execs[0]
        return {n: ex.arg_dict[n]._data for n in self._module._param_names}

    @property
    def aux(self):
        ex = self._module._exec_group.execs[0]
        return {n: ex.aux_dict[n]._data for n in self._module._aux_names}

    @property
    def fused(self):
        """The Module's fused step (its ``_plan``, ``opt_state``)."""
        return self._module._fused

