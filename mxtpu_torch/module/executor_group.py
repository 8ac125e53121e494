"""DataParallelExecutorGroup: one executor per context, each on its slice
of the batch.

Counterpart of ``mxtpu/module/executor_group.py``: ``_split_input_slice``
(:18, with ``work_load_list``), one ``Executor`` per context bound on its
slice's shapes (:101-131), ``set_params``, ``get_params`` averaged over
the contexts on the host (:143-165), ``forward`` feeding each context its
rows, ``backward``, ``get_outputs`` merged on the first context,
``get_input_grads`` and ``update_metric`` per slice, the state
inputs' ``get_states``/``set_states``, and ``install_monitor`` (:220),
which also reaches the executors of a later rebind. A Module over one context is a
group of one; ``shared_group`` binds over another group's arrays (the
buckets of a BucketingModule share one set of parameters).

``forward(..., coupled=True)`` runs the executors as one function of the
whole batch (``executor.forward_replicas``): BatchNorm then normalizes
by the whole batch's statistics and a normalized loss divides by the
whole batch, as mxtpu's multi-context fused step computes them; without
it each context is on its own, as mxtpu's executor group is. Each
executor's parameter gradients are views into one flat buffer per dtype
(``flat_grads``), so a step sums each replica's gradients with one
collective. The parameters of ``flat_tail`` go at the end of their buffer:
under a sharding plan the replicated gradients then lie in one leading
segment, summed in place, and the sharded ones after it.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError
from ..context import cpu
from ..executor import backward_replicas, forward_replicas
from ..ndarray import NDArray, host_copies

__all__ = ["DataParallelExecutorGroup"]


def _split_input_slice(batch_size, work_load_list):
    """The slice of the batch each context takes, in proportion to
    ``work_load_list`` (mxtpu/module/executor_group.py:18)."""
    total = sum(work_load_list)
    if batch_size < len(work_load_list):
        raise MXNetError("batch size must be >= number of devices")
    slices = []
    begin = 0
    for i, load in enumerate(work_load_list):
        end = batch_size if i == len(work_load_list) - 1 else \
            begin + int(round(batch_size * load / total))
        slices.append(slice(begin, end))
        begin = end
    return slices


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 fixed_param_names=None, grad_req="write", flat_tail=(),
                 shared_group=None, state_names=()):
        self.symbol = symbol
        self.contexts = list(contexts)
        self.workload = list(workload or [1] * len(self.contexts))
        if len(self.workload) != len(self.contexts):
            raise MXNetError("work_load_list has %d entries for %d contexts"
                             % (len(self.workload), len(self.contexts)))
        self.param_names = list(param_names)
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = list(fixed_param_names or [])
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self._grad_req = grad_req
        self.flat_tail = frozenset(flat_tail)
        self._coupled = False
        self.execs, self.flat_grads = [], []
        self.state_names = list(state_names)
        self._monitor = None
        self.bind_exec(data_shapes, label_shapes, shared_group)

    # ------------------------------------------------ bind
    def _scaled_slice(self, islice, dim0):
        """A batch slice scaled for an array whose leading dim is a
        multiple of the batch (the LM's (B*T,) labels)."""
        if self.batch_size and dim0 != self.batch_size \
                and dim0 % self.batch_size == 0:
            k = dim0 // self.batch_size
            return slice(islice.start * k, islice.stop * k)
        return islice

    def _req(self, name):
        if not self.for_training:
            return "null"
        if name in self.data_names:
            return self._grad_req if self.inputs_need_grad else "null"
        if name in self.param_names and name not in self.fixed_param_names:
            return self._grad_req
        return "null"

    def bind_exec(self, data_shapes, label_shapes, shared_group=None):
        """One executor per context at its slice's shapes; on a rebind
        (a new batch shape) the parameter, gradient and aux arrays of the
        previous executors are kept, and with ``shared_group`` (another
        symbol's group over the same contexts: a bucket's) that group's
        arrays of the same names and shapes and its flat gradient
        buffers are taken, the same tensors."""
        prev = old = self.execs
        old_flats = self.flat_grads
        if shared_group is not None:
            if shared_group.contexts != self.contexts:
                raise MXNetError("shared_module is bound on %s, this "
                                 "module on %s" % (shared_group.contexts,
                                                   self.contexts))
            old, old_flats = shared_group.execs, shared_group.flat_grads
        self.data_shapes, self.label_shapes = data_shapes, label_shapes
        self.data_names = [n for n, _ in data_shapes]
        self.label_names = [n for n, _ in label_shapes]
        self.batch_size = data_shapes[0][1][0]
        self.slices = _split_input_slice(self.batch_size, self.workload)
        self.execs = []
        self.flat_grads = []
        for i, ctx in enumerate(self.contexts):
            shapes = {}
            for name, shape in data_shapes + label_shapes:
                s = self._scaled_slice(self.slices[i], shape[0])
                shapes[name] = (s.stop - s.start,) + tuple(shape[1:])
            exe, flats = self._bind_one(ctx, shapes, old[i] if old else None)
            self.execs.append(exe)
            self.flat_grads.append(flats or (old_flats[i] if old else {}))
        self.param_arrays = [[e.arg_dict[n] for e in self.execs]
                             for n in self.param_names]
        self.grad_arrays = [[e.grad_dict.get(n) for e in self.execs]
                            for n in self.param_names]
        self.aux_arrays = [[e.aux_dict[n] for e in self.execs]
                           for n in self.aux_names]
        if self._monitor is not None:  # the rebound executors instead
            mon = self._monitor
            mon.exes = [e for e in mon.exes if all(e is not p for p in prev)]
            for exe in self.execs:
                mon.install(exe)

    def _bind_one(self, ctx, shapes, old):
        """(executor, {dtype: flat gradient buffer}) of one context, its
        input arrays new, its other arrays ``old``'s where given."""
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**shapes)
        dev = ctx.torch_device
        inputs = set(self.data_names + self.label_names)
        args, reqs, grads = {}, {}, {}
        for name, shape in zip(self.arg_names, arg_shapes):
            reqs[name] = self._req(name)
            kept = None if old is None or name in inputs else \
                old.arg_dict.get(name)
            if kept is not None and kept.shape == tuple(shape):
                args[name] = kept
                if name in old.grad_dict:
                    grads[name] = old.grad_dict[name]
            else:
                args[name] = NDArray(torch.zeros(shape, device=dev), ctx)
        # the parameters' gradients: views into one flat buffer per dtype,
        # those of flat_tail last
        need = sorted((n for n in self.param_names
                       if reqs[n] != "null" and n not in grads),
                      key=lambda n: n in self.flat_tail)
        flats = {}
        by_dtype = {}
        for n in need:
            by_dtype.setdefault(args[n].dtype, []).append(n)
        for dtype, names in by_dtype.items():
            flat = torch.zeros(sum(args[n].size for n in names),
                               dtype=dtype, device=dev)
            flats[dtype] = flat
            off = 0
            for n in names:
                k = args[n].size
                grads[n] = NDArray(flat[off:off + k].view(args[n].shape),
                                   ctx)
                off += k
        for name, shape in zip(self.arg_names, arg_shapes):
            if reqs[name] != "null" and name not in grads:
                grads[name] = NDArray(torch.zeros(shape, device=dev), ctx)
        aux = {}
        for n, shape in zip(self.aux_names, aux_shapes):
            kept = None if old is None else old.aux_dict.get(n)
            aux[n] = kept if kept is not None and \
                kept.shape == tuple(shape) else \
                NDArray(torch.zeros(shape, device=dev), ctx)
        return self.symbol.bind(ctx, args, args_grad=grads, grad_req=reqs,
                                aux_states=aux), flats

    def reshape(self, data_shapes, label_shapes):
        if data_shapes == self.data_shapes and \
                label_shapes == self.label_shapes:
            return
        self.bind_exec(data_shapes, label_shapes)

    # ------------------------------------------------ params
    def set_params(self, arg_params, aux_params):
        """Copy the given values into every context's arrays in place."""
        with torch.no_grad():
            for given, blocks in ((arg_params, dict(zip(
                    self.param_names, self.param_arrays))),
                    (aux_params, dict(zip(self.aux_names,
                                          self.aux_arrays)))):
                for name, val in (given or {}).items():
                    if name not in blocks:
                        continue
                    src = getattr(val, "_data", val)
                    if not isinstance(src, torch.Tensor):
                        src = torch.as_tensor(_np.asarray(src))
                    for arr in blocks[name]:
                        arr._data.copy_(src.reshape(arr.shape))

    def get_params(self, first_only=False):
        """(arg_params, aux_params) as cpu() NDArrays: one context's
        values with one device->host copy per dtype; over several, the
        average of the contexts' copies computed on the host as mxtpu
        computes it (executor_group.py:147-165), or with ``first_only``
        the first context's (replicas known to hold the same bits)."""
        blocks = self.param_arrays + self.aux_arrays
        names = self.param_names + self.aux_names
        if first_only:
            blocks = [b[:1] for b in blocks]
        n = len(blocks[0]) if blocks else 1
        host = host_copies([a._data for b in blocks for a in b])
        vals = []
        for i in range(len(blocks)):
            acc = host[i * n]
            for t in host[i * n + 1:(i + 1) * n]:
                acc = acc + t
            vals.append(NDArray(acc / n if n > 1 else acc, cpu()))
        k = len(self.param_names)
        return dict(zip(names[:k], vals[:k])), dict(zip(names[k:], vals[k:]))

    # ------------------------------------------------ compute
    def _feeds(self, data_batch):
        """{input name: [each context's rows]} of a batch."""
        feeds = {}
        labels = data_batch.label or []
        for name, arr in zip(self.data_names, data_batch.data):
            feeds[name] = [arr[s] for s in self.slices]
        for name, arr in zip(self.label_names, labels):
            feeds[name] = [arr[self._scaled_slice(s, arr.shape[0])]
                           for s in self.slices]
        return feeds

    def load_batch(self, data_batch):
        """Copy each context's rows of the batch into its executor's bound
        input arrays, on its device."""
        for name, parts in self._feeds(data_batch).items():
            for exe, part in zip(self.execs, parts):
                exe.arg_dict[name][:] = part

    def forward(self, data_batch, is_train=None, coupled=False):
        """Each context's forward on its rows; ``coupled`` (training
        only) runs them as one function of the whole batch."""
        if is_train is None:
            is_train = self.for_training
        self.load_batch(data_batch)
        self._coupled = coupled and is_train
        if self._coupled:
            forward_replicas(self.execs)
            return
        for exe in self.execs:
            exe.forward(is_train=is_train)

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True for backward")
        per_exec = None
        if out_grads is not None:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            per_exec = [[g[self._scaled_slice(s, g.shape[0])] for g in
                         out_grads] for s in self.slices]
        if self._coupled:
            backward_replicas(self.execs, per_exec)
            return
        for i, exe in enumerate(self.execs):
            exe.backward(None if per_exec is None else per_exec[i])

    def get_outputs(self, merge_multi_context=True):
        outputs = [[exe.outputs[i] for exe in self.execs]
                   for i in range(len(self.execs[0].outputs))]
        if merge_multi_context:
            return [self._merge(out) for out in outputs]
        return outputs

    def _merge(self, arrays):
        """Arrays of each context concatenated on the first one."""
        if len(arrays) == 1:
            return arrays[0]
        ctx = arrays[0].context
        return NDArray(torch.cat([a._data.to(ctx.torch_device)
                                  for a in arrays]), ctx)

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True first")
        grads = [[exe.grad_dict[n] for exe in self.execs]
                 for n in self.data_names]
        if merge_multi_context:
            return [self._merge(g) for g in grads]
        return grads

    def get_states(self, merge_multi_context=True):
        """The state inputs' arrays: per state name, each context's (or
        merged on the first context)."""
        states = [[exe.arg_dict[n] for exe in self.execs]
                  for n in self.state_names]
        if merge_multi_context:
            return [self._merge(s) for s in states]
        return states

    def set_states(self, states=None, value=None):
        """Copy ``states`` (per state name: one array split over the
        contexts by rows, or one array per context) or fill ``value``."""
        if (states is None) == (value is None):
            raise MXNetError("set_states: give states or value, not both")
        with torch.no_grad():
            for i, name in enumerate(self.state_names):
                dsts = [exe.arg_dict[name] for exe in self.execs]
                if value is not None:
                    for d in dsts:
                        d._data.fill_(value)
                    continue
                src = states[i]
                parts = src if isinstance(src, (list, tuple)) else \
                    [src[s] for s in self.slices]
                for d, v in zip(dsts, parts):
                    d[:] = v

    def install_monitor(self, mon):
        """Install ``mon`` on every executor, now and after a rebind."""
        self._monitor = mon
        for exe in self.execs:
            mon.install(exe)

    def update_metric(self, eval_metric, labels):
        for exe, s in zip(self.execs, self.slices):
            eval_metric.update(
                [lbl[self._scaled_slice(s, lbl.shape[0])] for lbl in labels],
                exe.outputs)

    def step_views(self):
        """[(labels, outputs)] of the last step, one pair per context, on
        its device (the bound label arrays): what the device metric folds
        in."""
        return [([exe.arg_dict[n]._data for n in self.label_names],
                 [o._data for o in exe.outputs]) for exe in self.execs]
