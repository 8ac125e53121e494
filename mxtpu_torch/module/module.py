"""Module: a symbol bound on a list of device contexts, its parameters
and optimizer.

Counterpart of ``mxtpu/module/module.py`` (bind :285, init_params :190,
init_optimizer :335 with the kvstore decision, ``_arm_fused`` :401-441,
forward_backward :509, update :575, get_outputs :603). The port binds a
``DataParallelExecutorGroup``: one Executor per context, each on its
slice of the batch (``work_load_list``); one context is a group of one.
``context`` defaults to gpu(0) and raises without CUDA; a context named
twice raises. The parameters live in the executors' bound arrays on the
devices; ``get_params`` returns cpu() copies (averaged over the
contexts, as mxtpu's executor group averages them).

``init_optimizer`` follows mxtpu's: ``model._create_kvstore`` decides
the store and ``update_on_kvstore``, ``rescale_grad`` is 1/(global
batch), the optimizer's indices name each parameter (per device without
``update_on_kvstore``). It then arms a ``FusedTrainStep`` on exactly
mxtpu's conditions, because the choice decides BatchNorm's semantics
over several contexts: the fused step runs ``forward_backward`` as one
function of the whole batch (BatchNorm on the whole batch's statistics)
and ``update`` sums the replicas' gradients with one collective and
applies every rule on every replica. Otherwise (inputs_need_grad,
grad_req other than "write", an optimizer without a rule, a ``dist``
kvstore, an uneven ``work_load_list``, a batch that does not divide over
the contexts) each context runs on its slice, with its own BatchNorm
statistics, and ``update`` goes through the kvstore
(``model._update_params_on_kvstore``) or the Updater
(``model._update_params``), and ``fit`` averages the contexts' params
on the host at each epoch end, as mxtpu's legacy path does. Under an
active mesh (``fit(mesh=...)``, ``sharding.use``, ``MXTPU_MESH``;
mxtpu's :401-485) the fused step takes the mesh's ``ShardingPlan`` and
runs over the mesh's devices, the executor group bound anew over them
even for a Module bound to one context: cross-replica weight-update
sharding (``fused.py``). On a mesh with ``tp`` or ``fsdp`` axes
(``"data:2,tp:2"``, ``"data:2,fsdp:2"``, ``"4x2"``) each device holds its
block of every parameter the plan splits (the plan's
``replica_layout()``): the rows of the batch split over every axis but
``tp``, an ``fsdp`` block is gathered right before its op and its
gradient reduce-scattered, a ``tp`` block computed on by its op's
``tp_fn``. ``get_params``, ``save_checkpoint`` and
``save_optimizer_states`` assemble the blocks to full size, and
``set_params``, ``init_params`` and ``load_optimizer_states`` hand each
device its blocks. A mesh the batch does not divide over ``data`` is
declined with mxtpu's warning; one whose other row axes it does not
divide raises.
``forward`` called directly runs each context on its slice, as mxtpu's
does; ``get_outputs`` merges them on the first context.
``install_monitor`` (mxtpu :674) takes mxtpu's per-op branch (:691-694):
it disarms the fused step for good, and the monitor's sampled batches
walk every op on each executor; ``output_shapes`` (:175) are inferred
from the bound shapes.

``state_names`` are inputs that are neither data nor parameters (an
RNN's carried state): bound without a gradient, kept across batches,
read and written by ``get_states``/``set_states`` as the reference's
Module does (mxtpu's returns [] there), and, as in mxtpu (:413), they
keep the fused step disarmed. ``bind(shared_module=...)`` binds over the
shared module's parameter, gradient and aux tensors (the same storage)
and ``borrow_optimizer`` its optimizer and fused state: the per-bucket
modules of ``BucketingModule`` (mxtpu :304-318, :746-766).

Checkpoints (``save_checkpoint``, the static ``load``, ``save_params``,
``load_params``, ``save_optimizer_states``, ``load_optimizer_states``;
mxtpu/module/module.py:101-146, 699-744) write mxtpu's files:
``-symbol.json`` and ``.params`` load in either package, bit for bit.
A ``.states`` file is a pickle of ``{index: numpy state}``, which the
port's update paths read and write (through the kvstore when it
updates); it is not interchangeable with mxtpu's, whose fused step
pickles its own state tree.
"""
from __future__ import annotations

import logging
import pickle

import torch

from .. import model as _model
from .. import optimizer as opt
from ..base import MXNetError
from ..context import context_list, current_context
from ..initializer import InitDesc, Uniform
from ..ndarray import NDArray
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup
from .fused import FusedTrainStep, supports

__all__ = ["Module"]


def _descs(shapes, names, what, unused=()):
    """[(name, shape)] from DataDesc-likes or pairs, in ``names`` order.
    A shape named in ``unused`` (a label name the symbol does not take,
    as an inference symbol bound with its training labels) is dropped,
    as mxtpu's Module drops it."""
    got = {}
    for d in shapes or []:
        name, shape = (d.name, d.shape) if hasattr(d, "name") else d
        got[name] = tuple(shape)
    extra = set(got) - set(names) - set(unused)
    if extra:
        raise MXNetError("%s shapes name %s; the module's %s names are %s"
                         % (what, sorted(extra), what, names))
    return [(n, got[n]) for n in names if n in got]


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        if context is None:
            context = current_context()
        self._context = context_list(context)
        for ctx in self._context:
            ctx.torch_device  # raises for a missing card
        self._device = self._context[0].torch_device
        if work_load_list is None:
            work_load_list = [1] * len(self._context)
        if len(work_load_list) != len(self._context):
            raise MXNetError("work_load_list has %d entries for %d contexts"
                             % (len(work_load_list), len(self._context)))
        self._work_load_list = list(work_load_list)
        self._symbol = symbol
        args = symbol.list_arguments()
        self._data_names = list(data_names or [])
        self._label_names = [n for n in (label_names or []) if n in args]
        self._unused_labels = [n for n in (label_names or [])
                               if n not in args]
        self._state_names = list(state_names or [])
        for what, names in (("data", self._data_names),
                            ("state", self._state_names)):
            for n in names:
                if n not in args:
                    raise MXNetError("%s name '%s' is not an argument of "
                                     "the symbol (%s)" % (what, n, args))
        input_names = self._data_names + self._label_names + \
            self._state_names
        self._param_names = [n for n in args if n not in input_names]
        self._fixed_param_names = list(fixed_param_names or [])
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        self._exec_group = None
        self._data_shapes = self._label_shapes = None
        self._grad_req = "write"
        self._optimizer = self._updater = None
        self._kvstore = None
        self._update_on_kvstore = False
        self._fused = None
        # plan_for_module's overrides and shard_update under a mesh
        # (DataParallelTrainer's shard_params sets them)
        self._plan_options = {}
        self._monitor_installed = False
        # set by load(): params written at bind, states at init_optimizer
        self._arg_params = self._aux_params = None
        self._preload_opt_states = None

    # ------------------------------------------------ checkpoints
    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over ``prefix-symbol.json`` whose params come from
        ``prefix-%04d.params`` when it binds; with
        ``load_optimizer_states`` its optimizer starts from
        ``prefix-%04d.states``. ``kwargs`` go to the constructor."""
        sym, args, auxs = _model.load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params, mod._aux_params = args, auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        async_write=False):
        """``prefix-symbol.json``, ``prefix-%04d.params`` and its
        manifest, and with ``save_optimizer_states`` ``prefix-%04d.states``,
        written synchronously (``async_write`` raises: not ported)."""
        _model.refuse_async(async_write)
        self._symbol.save("%s-symbol.json" % prefix)
        arg_params, aux_params = self.get_params()
        _model.save_params("%s-%04d.params" % (prefix, epoch), epoch,
                           arg_params, aux_params)
        if save_optimizer_states:
            state_name = "%s-%04d.states" % (prefix, epoch)
            self.save_optimizer_states(state_name)
            self.logger.info('Saved optimizer state to "%s"', state_name)

    def save_optimizer_states(self, fname):
        """Pickle of ``{index: numpy state}`` from the fused step, the
        kvstore's updater or the Updater, whichever updates."""
        assert self.optimizer_initialized
        if self._fused is None and self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
            return
        with open(fname, "wb") as f:
            f.write(pickle.dumps(self._fused.export_opt_state())
                    if self._fused is not None
                    else self._updater.get_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._fused is None and self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as f:
            states = pickle.loads(f.read())
        if self._fused is not None:
            self._fused.import_opt_state(states)
        else:
            self._updater.set_states(states)

    # ------------------------------------------------ properties
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        """[(output name, shape)] at the bound (whole-batch) shapes."""
        assert self.binded
        shapes = self._symbol.infer_shape(
            **dict(self._data_shapes + (self._label_shapes or [])))[1]
        return list(zip(self._output_names, shapes))

    def install_monitor(self, mon):
        """Monitor every executor's ops (mxtpu's per-op path): the fused
        step is disarmed, now and at any later ``init_optimizer``."""
        assert self.binded
        self._monitor_installed = True
        self._disarm_fused()
        self._exec_group.install_monitor(mon)

    # ------------------------------------------------ bind
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if force_rebind:
            self.binded = False
            self._exec_group = None
            self._fused = None
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        shared_group = None
        if shared_module is not None:
            if not (isinstance(shared_module, Module) and
                    shared_module.binded and
                    shared_module.params_initialized):
                raise MXNetError("bind(shared_module=...) takes a Module "
                                 "that is bound and initialized")
            shared_group = shared_module._exec_group
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        self._data_shapes = _descs(data_shapes, self._data_names, "data")
        self._label_shapes = _descs(label_shapes, self._label_names, "label",
                                    self._unused_labels)
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list,
            self._data_shapes, self._label_shapes, self._param_names,
            for_training, inputs_need_grad,
            fixed_param_names=self._fixed_param_names, grad_req=grad_req,
            shared_group=shared_group, state_names=self._state_names)
        self.binded = True
        if shared_module is not None:
            self.params_initialized = True
        elif self._arg_params is not None:  # a loaded checkpoint
            args, auxs = self._arg_params, self._aux_params
            self._arg_params = self._aux_params = None
            self.params_initialized = False
            self.init_params(arg_params=args, aux_params=auxs)

    def reshape(self, data_shapes, label_shapes=None):
        assert self.binded
        self._data_shapes = _descs(data_shapes, self._data_names, "data")
        self._label_shapes = _descs(label_shapes, self._label_names, "label",
                                    self._unused_labels)
        self._exec_group.reshape(self._data_shapes, self._label_shapes)

    # ------------------------------------------------ params
    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """Give every parameter its value: from ``arg_params`` /
        ``aux_params`` where named there, else from ``initializer``
        (default ``Uniform(0.01)``; an error when ``arg_params`` is given
        without ``allow_missing``). Names the module does not take are
        ignored, as mxtpu ignores them (``allow_extra`` is accepted for
        its signature): a SequentialModule hands every module the whole
        dict. The first context's arrays are written in place, once, and
        copied to the other contexts."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        if initializer is None:
            initializer = Uniform(0.01)
        attrs = self._symbol.attr_dict()
        group = self._exec_group
        ex = group.execs[0]
        split = group.layout.specs if group.layout is not None else {}

        def target(name):
            """The array the initializer writes: the first replica's, or
            a whole one where the replicas hold blocks."""
            arr = ex.arg_dict[name]
            if name not in split:
                return arr
            return NDArray(torch.zeros(group.param_shapes[name],
                                       dtype=arr._data.dtype,
                                       device=arr._data.device),
                           arr.context)
        # arguments, then aux states, each in name order: the order of
        # the initializer's draws
        pairs = [(n, target(n), arg_params)
                 for n in sorted(self._param_names)] + \
                [(n, ex.aux_dict[n], aux_params)
                 for n in sorted(self._aux_names)]
        done = {}
        for name, arr, given in pairs:
            if given is not None and name in given:
                done[name] = given[name]
                continue
            if given is not None and not allow_missing and \
                    given is arg_params:
                raise MXNetError("%s is not presented" % name)
            initializer(InitDesc(name, attrs.get(name)), arr)
            done[name] = arr
        group.set_params({n: done[n] for n in self._param_names},
                         {n: done[n] for n in self._aux_names})
        self.params_initialized = True

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def get_params(self):
        """(arg_params, aux_params): cpu() copies of the live values (the
        aux values as the last training forward wrote them back), taken
        with one device->host copy per dtype and device; over several
        contexts each value is the contexts' average; on the fused step,
        whose replicas hold the same bits, the first replica's."""
        assert self.binded and self.params_initialized
        return self._exec_group.get_params(
            first_only=self._fused is not None)

    # ------------------------------------------------ optimizer
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        group = self._exec_group
        first = {n: b[0] for n, b in zip(self._param_names,
                                         group.param_arrays)}
        kv, update_on_kvstore = _model._create_kvstore(
            kvstore, len(self._context), first)
        batch_size = group.batch_size
        if kv is not None and "dist" in kv.type and "_sync" in kv.type:
            batch_size *= kv.num_workers
        if isinstance(optimizer, str):
            n = len(self._context)
            if update_on_kvstore:
                idx2name = dict(enumerate(self._param_names))
            else:
                idx2name = {i * n + k: name for k in range(n)
                            for i, name in enumerate(self._param_names)}
            params = dict(optimizer_params)
            params.setdefault("rescale_grad", 1.0 / batch_size)
            optimizer = opt.create(optimizer, sym=self._symbol,
                                   param_idx2name=idx2name, **params)
        elif not isinstance(optimizer, opt.Optimizer):
            raise MXNetError("optimizer must be a name or an Optimizer")
        self._optimizer = optimizer
        self._kvstore = kv
        self._update_on_kvstore = update_on_kvstore
        self._updater = None
        if kv is not None:
            _model._initialize_kvstore(kv, group.param_arrays, first,
                                       self._param_names, update_on_kvstore)
        if update_on_kvstore:
            kv.set_optimizer(optimizer)
        else:
            self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True
        self._arm_fused()
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def _arm_fused(self):
        """Arm the fused step on mxtpu's conditions (module.py:401-441):
        training with grad_req "write", no input gradients, no monitor
        installed, an optimizer
        with a rule, no ``dist`` kvstore and an even ``work_load_list``.
        Under an active mesh the step takes a ``ShardingPlan`` and runs
        over the mesh's devices, even for a Module bound to one context
        (mxtpu's :422-424): the executor group is bound anew over them,
        from the current parameters, with the sharded parameters'
        gradients at the end of each flat buffer. Without one the batch must divide
        over the contexts."""
        self._disarm_fused()
        group = self._exec_group
        n = len(group.contexts)
        if (not self.for_training or self.inputs_need_grad
                or self._monitor_installed or self._state_names
                or self._grad_req != "write"
                or not supports(self._optimizer)
                or (self._kvstore is not None
                    and "dist" in self._kvstore.type)
                or len(set(self._work_load_list)) > 1):
            return
        plan = self._resolve_sharding_plan()
        if plan is None and n > 1 and group.batch_size % n:
            return
        if plan is not None:
            tail = frozenset(plan.sharded_opt_names())
            layout = plan.replica_layout()
            if plan.mesh_ctx.devices != group.contexts or \
                    group.flat_tail != tail or group.layout is None or \
                    group.layout.key != layout.key:
                group = self._rebind(plan.mesh_ctx.devices, tail, layout)
        shapes, types = self._pipeline_hints()
        self._fused = FusedTrainStep(group.execs, self._param_names,
                                     self._optimizer, group.flat_grads,
                                     plan=plan, module=self,
                                     graph_shapes=shapes, graph_types=types,
                                     logger=self.logger)

    def _disarm_fused(self):
        """Retire the fused step: the executors train their own graph
        again (``fwd_bwd``)."""
        self._fused = None
        if self._exec_group is not None:
            for ex in self._exec_group.execs:
                ex.set_train_program(None, None)

    def _pipeline_hints(self):
        """Shape/dtype hints for the compile pipeline's analyses and the
        verifier re-run that gates every transform (mxtpu :443-456): the
        bound whole-batch data/label shapes and the parameter and aux
        shapes they infer, with the bound arrays' dtypes."""
        shapes = dict(self._data_shapes + (self._label_shapes or []))
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**shapes)
        ex0 = self._exec_group.execs[0]
        types = {}
        for names, found, bound in (
                (self._symbol.list_arguments(), arg_shapes, ex0.arg_dict),
                (self._aux_names, aux_shapes, ex0.aux_dict)):
            for n, shp in zip(names, found):
                if n in self._param_names or n in self._aux_names:
                    shapes[n] = tuple(shp)
                    if n in bound:
                        types[n] = bound[n].dtype
        return shapes, types

    def borrow_optimizer(self, shared_module):
        """Train through ``shared_module``'s optimizer, kvstore and
        Updater (mxtpu/module/module.py:746-766); with its fused step
        armed, through a fused step over this module's executors that
        adopts that step's optimizer state, so every bucket of a
        BucketingModule advances one set of weights (shared storage,
        ``bind(shared_module=...)``) and one set of moments."""
        if not shared_module.optimizer_initialized:
            raise MXNetError("borrow_optimizer: the shared module has no "
                             "optimizer")
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        self.optimizer_initialized = True
        self._disarm_fused()
        if shared_module._fused is not None:
            group = self._exec_group
            shapes, types = self._pipeline_hints()
            self._fused = FusedTrainStep(
                group.execs, self._param_names, self._optimizer,
                group.flat_grads, plan=shared_module._fused._plan,
                state=shared_module._fused, module=self,
                graph_shapes=shapes, graph_types=types, logger=self.logger)

    def _resolve_sharding_plan(self):
        """The ShardingPlan of the active mesh, or None for the contexts'
        own path (mxtpu's :456-478). A mesh the batch does not divide over
        ``data`` is declined with mxtpu's log line, never with wrong
        arithmetic; one whose other row axes (the axes but ``tp``: fsdp)
        it does not divide raises. ``_plan_options`` (``overrides``,
        ``shard_update``) reach ``plan_for_module``."""
        from .. import sharding as _sharding
        mctx = _sharding.current()
        if mctx is None or len(mctx.devices) <= 1:
            return None
        batch = self._exec_group.batch_size
        if batch % mctx.n_data != 0:
            self.logger.warning(
                "sharding: batch size %d does not divide over the %d-way "
                "data axis — mesh declined, falling back to the "
                "single-device fused path", batch, mctx.n_data)
            return None
        plan = _sharding.plan_for_module(self, mctx, **self._plan_options)
        rows = plan.replica_layout().n_row_slices
        if batch % rows:
            raise MXNetError(
                "fit(mesh=%r): the batch of %d does not divide over the "
                "%d row slices of axes %s (the batch splits over every "
                "axis but tp)" % (mctx, batch, rows,
                                  plan.replica_layout().row_axes))
        return plan

    def _rebind(self, contexts, flat_tail, layout=None):
        """Bind the executor group anew over ``contexts`` (one replica
        each, even slices, the gradients of ``flat_tail`` last in their
        flat buffers; with ``layout``, each replica's rows and blocks),
        carrying the current parameters and aux states."""
        old = self._exec_group
        args, auxs = old.get_params(first_only=True) \
            if old.layout is not None and old.layout.specs else (
                {n: old.execs[0].arg_dict[n] for n in self._param_names},
                {n: old.execs[0].aux_dict[n] for n in self._aux_names})
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, contexts, [1] * len(contexts), self._data_shapes,
            self._label_shapes, self._param_names, self.for_training,
            self.inputs_need_grad,
            fixed_param_names=self._fixed_param_names,
            grad_req=self._grad_req, flat_tail=flat_tail,
            state_names=self._state_names, layout=layout)
        self._exec_group.set_params(args, auxs)
        return self._exec_group

    # ------------------------------------------------ compute
    def _forward(self, data_batch, is_train, coupled=False):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        new = tuple(tuple(x.shape) for x in data_batch.data)
        if new != tuple(s for _, s in self._data_shapes):
            labels = [(n, tuple(x.shape)) for n, x in
                      zip(self._label_names, data_batch.label or [])]
            self.reshape(list(zip(self._data_names, new)),
                         labels or self._label_shapes)
        self._exec_group.forward(data_batch, is_train, coupled=coupled)

    def forward(self, data_batch, is_train=None):
        """Each context's forward on its rows of the batch."""
        self._forward(data_batch, is_train)

    def forward_backward(self, data_batch):
        """The training forward and backward; with the fused step armed,
        over all contexts as one function of the whole batch."""
        self._forward(data_batch, True, coupled=self._fused is not None)
        self.backward()

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        if self._fused is not None:
            self._fused.update()
            return
        group = self._exec_group
        if self._update_on_kvstore:
            _model._update_params_on_kvstore(
                group.param_arrays, group.grad_arrays, self._kvstore,
                self._param_names)
        else:
            _model._update_params(
                group.param_arrays, group.grad_arrays, self._updater,
                len(self._context), self._kvstore, self._param_names)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._exec_group.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)

    def get_states(self, merge_multi_context=True):
        """The arrays of the ``state_names`` inputs (per context unless
        merged; the reference's Module.get_states)."""
        assert self.binded and self.params_initialized
        return self._exec_group.get_states(merge_multi_context)

    def set_states(self, states=None, value=None):
        """Write ``states`` (one array, or one list of per-context arrays,
        per state name) or the scalar ``value`` into the state inputs."""
        assert self.binded and self.params_initialized
        self._exec_group.set_states(states, value)

    def _step_views(self):
        """[(labels, outputs)] of the last step, one pair per context, on
        its device."""
        return self._exec_group.step_views()

    def _host_round_trip(self):
        """Whether fit averages the contexts' params on the host at each
        epoch end (mxtpu's legacy multi-context path)."""
        return len(self._context) > 1 and self._fused is None
