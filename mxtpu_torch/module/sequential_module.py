"""SequentialModule: a chain of modules, each one's outputs the next
one's data.

Counterpart of ``mxtpu/module/sequential_module.py`` (parity: python/
mxnet/module/sequential_module.py). ``add(module, take_labels=,
auto_wiring=)``; ``bind`` binds every module after the first with
``inputs_need_grad`` when training, so ``backward`` carries each
module's input gradients back as the previous module's head gradients;
``forward``, ``update``, ``update_metric`` (the modules that take
labels) and ``install_monitor`` go to every module.
"""
from __future__ import annotations

import logging

from ..io import DataBatch, DataDesc
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None
        self._data_shapes = None
        self._meta_keys = {getattr(SequentialModule, x)
                           for x in dir(SequentialModule)
                           if x.startswith("META_")}

    def add(self, module, **kwargs):
        """Append ``module``; ``take_labels=True`` feeds it the batch's
        labels, ``auto_wiring=True`` renames the incoming data to its
        data names. Unbinds the chain."""
        self._modules.append(module)
        for key in kwargs:
            assert key in self._meta_keys, "Unknown meta \"%s\"" % key
        self._metas.append(kwargs)
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    @property
    def data_names(self):
        return self._modules[0].data_names if self._modules else []

    @property
    def output_names(self):
        return self._modules[-1].output_names if self._modules else []

    @property
    def data_shapes(self):
        assert self.binded
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._modules[-1].output_shapes

    def get_params(self):
        assert self.binded and self.params_initialized
        arg_params, aux_params = {}, {}
        for module in self._modules:
            arg, aux = module.get_params()
            arg_params.update(arg)
            aux_params.update(aux)
        return (arg_params, aux_params)

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """Each module's ``init_params``; a parameter name in two modules
        is an error."""
        if self.params_initialized and not force_init:
            return
        assert self.binded
        for module in self._modules:
            module.init_params(initializer=initializer, arg_params=arg_params,
                               aux_params=aux_params,
                               allow_missing=allow_missing,
                               force_init=force_init, allow_extra=allow_extra)
        owner = ({}, {})
        for i, module in enumerate(self._modules):
            for known, names in zip(owner, module.get_params()):
                for name in names:
                    assert name not in known, (
                        "Duplicated parameter names: name \"%s\" in layer %d "
                        "(%s) is already used in layer %d (%s)." % (
                            name, i, type(module), known[name],
                            type(self._modules[known[name]])))
                    known[name] = i
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if inputs_need_grad:
            assert for_training
        assert shared_module is None, "Shared module is not supported"
        assert self._modules
        self.binded = True
        # the reference's bind sets these (mxtpu's does not, so its
        # get_input_grads always fails its assertion)
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._label_shapes = label_shapes
        my_data_shapes = data_shapes
        anybody_needs_labels = False
        for i, module in enumerate(self._modules):
            meta = self._metas[i]
            take = bool(meta.get(self.META_TAKE_LABELS))
            anybody_needs_labels |= take
            if meta.get(self.META_AUTO_WIRING, False):
                names = module.data_names
                assert len(names) == len(my_data_shapes)
                my_data_shapes = [(n, s) for n, (_, s)
                                  in zip(names, my_data_shapes)]
            module.bind(data_shapes=my_data_shapes,
                        label_shapes=label_shapes if take else None,
                        for_training=for_training,
                        inputs_need_grad=bool(for_training and (
                            inputs_need_grad or i > 0)),
                        force_rebind=force_rebind, shared_module=None,
                        grad_req=grad_req)
            my_data_shapes = [DataDesc(n, tuple(s)) for n, (_, s) in
                              zip(module.output_names, module.output_shapes)]
        if not anybody_needs_labels:
            self._label_shapes = None

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        for module in self._modules:
            module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                  optimizer_params=optimizer_params,
                                  force_init=force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        batch = DataBatch(data=data_batch.data, label=data_batch.label,
                          pad=data_batch.pad, index=data_batch.index,
                          provide_data=data_batch.provide_data,
                          provide_label=data_batch.provide_label)
        for i, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if i + 1 == len(self._modules):
                break
            batch.data = module.get_outputs()
            batch.provide_data = [(n, tuple(o.shape)) for n, o in
                                  zip(module.output_names, batch.data)]

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        for i in reversed(range(len(self._modules))):
            module = self._modules[i]
            module.backward(out_grads=out_grads)
            if i == 0:
                break
            out_grads = module.get_input_grads()

    def update(self):
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        for meta, module in zip(self._metas, self._modules):
            if meta.get(self.META_TAKE_LABELS):
                module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        assert self.binded
        for module in self._modules:
            module.install_monitor(mon)
