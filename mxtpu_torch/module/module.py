"""Module: a symbol bound on one device, its parameters and optimizer.

Counterpart of ``mxtpu/module/module.py`` (bind :285, init_params :190,
init_optimizer :335 arming the fused step as ``_arm_fused`` :401-441
does, forward_backward :509, update :575, get_outputs :603). The port
binds one Executor on one device (``context`` defaults to gpu(0) and
raises without CUDA; several contexts raise: data parallelism over
NCCL is a later slice). The parameters live in the executor's bound
arrays on the device; ``get_params`` returns cpu() copies.

When the optimizer has a fused rule (SGD, NAG, Adam, RMSProp, AdaGrad),
``init_optimizer`` arms a ``FusedTrainStep`` over those same arrays and
``update`` applies every parameter's rule in one call; any other
optimizer updates through the Updater. ``forward_backward`` is the
executor's training forward and backward (which writes BatchNorm's
moving statistics back into the bound aux arrays), and ``get_outputs``
returns its outputs on the device, with no host copy.

Checkpoints (``save_checkpoint``, the static ``load``, ``save_params``,
``load_params``, ``save_optimizer_states``, ``load_optimizer_states``;
mxtpu/module/module.py:101-146, 699-744) write mxtpu's files:
``-symbol.json`` and ``.params`` load in either package, bit for bit.
A ``.states`` file is a pickle of ``{index: numpy state}``, which both
of the port's update paths read and write; it is not interchangeable
with mxtpu's, whose fused step pickles its own state tree.
"""
from __future__ import annotations

import logging
import pickle

import numpy as _np
import torch

from .. import model as _model
from .. import optimizer as opt
from ..base import MXNetError
from ..context import as_context, cpu, current_context
from ..initializer import InitDesc, Uniform
from ..ndarray import NDArray, host_copies
from .base_module import BaseModule, refuse_unported
from .fused import FusedTrainStep, supports

__all__ = ["Module"]


def _descs(shapes, names, what):
    """[(name, shape)] from DataDesc-likes or pairs, in ``names`` order."""
    got = {}
    for d in shapes or []:
        name, shape = (d.name, d.shape) if hasattr(d, "name") else d
        got[name] = tuple(shape)
    if set(got) - set(names):
        raise MXNetError("%s shapes name %s; the module's %s names are %s"
                         % (what, sorted(set(got) - set(names)), what,
                            names))
    return [(n, got[n]) for n in names if n in got]


def _as_tensor(v, device):
    t = getattr(v, "_data", v)
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(_np.asarray(v))
    return t.to(device)


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        if context is None:
            context = current_context()
        if isinstance(context, (list, tuple)):
            if len(context) != 1:
                raise MXNetError("Module over %d contexts: data parallelism "
                                 "is not ported yet; pass one context"
                                 % len(context))
            context = context[0]
        self._context = as_context(context)
        self._device = self._context.torch_device
        if state_names:
            raise MXNetError("Module(state_names=...) is not ported yet")
        self._symbol = symbol
        args = symbol.list_arguments()
        self._data_names = list(data_names or [])
        self._label_names = [n for n in (label_names or []) if n in args]
        for n in self._data_names:
            if n not in args:
                raise MXNetError("data name '%s' is not an argument of the "
                                 "symbol (%s)" % (n, args))
        input_names = self._data_names + self._label_names
        self._param_names = [n for n in args if n not in input_names]
        self._fixed_param_names = list(fixed_param_names or [])
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        self._exec = None
        self._data_shapes = self._label_shapes = None
        self._grad_req = "write"
        self._optimizer = self._updater = None
        self._fused = None
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
        """Pickle of ``{index: numpy state}`` from the fused step or the
        Updater, whichever updates."""
        assert self.optimizer_initialized
        with open(fname, "wb") as f:
            f.write(pickle.dumps(self._fused.export_opt_state())
                    if self._fused is not None
                    else self._updater.get_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
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

    # ------------------------------------------------ bind
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if force_rebind:
            self.binded = False
            self._exec = None
            self._fused = None
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if shared_module is not None:
            raise MXNetError("bind(shared_module=...) is not ported yet")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        self._data_shapes = _descs(data_shapes, self._data_names, "data")
        self._label_shapes = _descs(label_shapes, self._label_names, "label")
        self._exec = self._bind_exec(None)
        self.binded = True
        if self._arg_params is not None:  # a loaded checkpoint
            args, auxs = self._arg_params, self._aux_params
            self._arg_params = self._aux_params = None
            self.params_initialized = False
            self.init_params(arg_params=args, aux_params=auxs)

    def _bind_exec(self, old):
        """An Executor for the current data/label shapes; the parameter,
        gradient and aux arrays of ``old`` (a reshape) are kept."""
        shapes = dict(self._data_shapes + self._label_shapes)
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**shapes)
        dev = self._device
        args, grads, reqs = {}, {}, {}
        inputs = set(self._data_names + self._label_names)
        for name, shape in zip(self._symbol.list_arguments(), arg_shapes):
            if old is not None and name not in inputs:
                args[name] = old.arg_dict[name]
                if name in old.grad_dict:
                    grads[name] = old.grad_dict[name]
            else:
                args[name] = NDArray(torch.zeros(shape, device=dev),
                                     self._context)
            need = (name in self._data_names and self.inputs_need_grad) or (
                name not in inputs and self.for_training
                and name not in self._fixed_param_names)
            reqs[name] = self._grad_req if need else "null"
            if need and name not in grads:
                grads[name] = NDArray(torch.zeros(shape, device=dev),
                                      self._context)
        aux = {n: (old.aux_dict[n] if old is not None else
                   NDArray(torch.zeros(s, device=dev), self._context))
               for n, s in zip(self._aux_names, aux_shapes)}
        return self._symbol.bind(self._context, args, args_grad=grads,
                                 grad_req=reqs, aux_states=aux)

    def reshape(self, data_shapes, label_shapes=None):
        assert self.binded
        self._data_shapes = _descs(data_shapes, self._data_names, "data")
        self._label_shapes = _descs(label_shapes, self._label_names, "label")
        self._exec = self._bind_exec(self._exec)

    # ------------------------------------------------ params
    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """Give every parameter its value: from ``arg_params`` /
        ``aux_params`` where named there, else from ``initializer``
        (default ``Uniform(0.01)``; an error when ``arg_params`` is given
        without ``allow_missing``). Writes the bound arrays in place."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        if initializer is None:
            initializer = Uniform(0.01)
        attrs = self._symbol.attr_dict()
        # arguments, then aux states, each in name order: the order of
        # the initializer's draws
        pairs = [(n, self._exec.arg_dict[n], arg_params)
                 for n in sorted(self._param_names)] + \
                [(n, self._exec.aux_dict[n], aux_params)
                 for n in sorted(self._aux_names)]
        for name, arr, given in pairs:
            if given is not None and name in given:
                with torch.no_grad():
                    arr._data.copy_(_as_tensor(given[name], self._device)
                                    .reshape(arr.shape))
            elif given is not None and not allow_missing and \
                    given is arg_params:
                raise MXNetError("%s is not presented" % name)
            else:
                initializer(InitDesc(name, attrs.get(name)), arr)
        if not allow_extra:
            for given in (arg_params, aux_params):
                extra = set(given or {}) - set(self._param_names) \
                    - set(self._aux_names)
                if extra:
                    raise MXNetError("init_params: unknown parameters %s"
                                     % sorted(extra))
        self.params_initialized = True

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def get_params(self):
        """(arg_params, aux_params): cpu() copies of the live values (the
        aux values as the last training forward wrote them back), taken
        with one device->host copy per dtype."""
        assert self.binded and self.params_initialized
        ex = self._exec
        arrays = [ex.arg_dict[n] for n in self._param_names] + \
            [ex.aux_dict[n] for n in self._aux_names]
        host = [NDArray(t, cpu())
                for t in host_copies([a._data for a in arrays])]
        k = len(self._param_names)
        return (dict(zip(self._param_names, host[:k])),
                dict(zip(self._aux_names, host[k:])))

    # ------------------------------------------------ optimizer
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        refuse_unported(kvstore)
        if isinstance(optimizer, str):
            params = dict(optimizer_params)
            params.setdefault("rescale_grad",
                              1.0 / self._data_shapes[0][1][0])
            optimizer = opt.create(
                optimizer, sym=self._symbol,
                param_idx2name=dict(enumerate(self._param_names)), **params)
        elif not isinstance(optimizer, opt.Optimizer):
            raise MXNetError("optimizer must be a name or an Optimizer")
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True
        self._arm_fused()
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def _arm_fused(self):
        """Arm the fused update when the optimizer has a rule."""
        self._fused = None
        if self.for_training and supports(self._optimizer):
            self._fused = FusedTrainStep(self._exec, self._param_names,
                                         self._optimizer)

    # ------------------------------------------------ compute
    def _load_batch(self, data_batch):
        ex = self._exec
        for name, arr in zip(self._data_names, data_batch.data):
            ex.arg_dict[name][:] = arr
        for name, arr in zip(self._label_names, data_batch.label or []):
            ex.arg_dict[name][:] = arr

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        new = tuple(tuple(x.shape) for x in data_batch.data)
        if new != tuple(s for _, s in self._data_shapes):
            labels = [(n, tuple(x.shape)) for n, x in
                      zip(self._label_names, data_batch.label or [])]
            self.reshape(list(zip(self._data_names, new)),
                         labels or self._label_shapes)
        self._load_batch(data_batch)
        self._exec.forward(is_train=is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec.backward(out_grads=out_grads)

    def update(self):
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        if self._fused is not None:
            self._fused.update()
            return
        ex = self._exec
        for i, name in enumerate(self._param_names):
            grad = ex.grad_dict.get(name)
            if grad is None or ex.grad_req.get(name) == "null":
                continue
            self._updater(i, grad, ex.arg_dict[name])

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        outs = list(self._exec.outputs)
        return outs if merge_multi_context else [[o] for o in outs]

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        grads = [self._exec.grad_dict[n] for n in self._data_names]
        return grads if merge_multi_context else [[g] for g in grads]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(list(labels), self.get_outputs())

    def _step_view(self, data_batch):
        """(labels, outputs) of the last step, on the device."""
        return ([self._exec.arg_dict[n]._data for n in self._label_names],
                [o._data for o in self._exec.outputs])

