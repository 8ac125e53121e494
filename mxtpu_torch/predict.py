"""Standalone inference API.

Counterpart of ``mxtpu/predict.py``: ``Predictor`` with ``arg:``/``aux:``
weight loading from a dict or from the bytes of a ``.params`` file
(:37-91, with ``output_names``/``output_index`` keeping internal
outputs), the shape-keyed bind cache (``_bind``/``_bind_fresh``
:112-150), ``set_input`` (float32, as :158), ``forward``,
``partial_forward`` (:171-201: node by node from the last position, a
step back restarting, the walk's tensors released at the end),
``num_steps``, ``reshape``, ``forward_batch`` (:243, padding to
``bucket_sizes``), ``reshaped`` (:269, a new Predictor over the same
weight tensors), ``num_outputs``, ``symbol_hash`` (:92), and
``create``/``load_checkpoint_predictor`` (:283-295), which read the
``.params`` file's bytes as the C predict API does. Unlike the JAX
package, which defaults to ``cpu()``, a Predictor given no context runs
on ``gpu(0)`` (``dev_type``/``dev_id`` choose another) and raises
without CUDA.
"""
from __future__ import annotations

import hashlib as _hashlib
import io as _io
from collections import OrderedDict as _OrderedDict

import numpy as _np
import torch

from . import ndarray as nd
from . import symbol as sym_mod
from .base import MXNetError
from .context import Context, as_context, current_context
from .executor import eager_run_range

__all__ = ["Predictor", "to_host", "create", "load_checkpoint_predictor"]


def to_host(tensors):
    """Numpy copies of output tensors: one device->host copy per output,
    each waiting for the device (the LM has a single output)."""
    return [nd.to_numpy(t) for t in tensors]


def _as_tensor(v, device):
    if isinstance(v, nd.NDArray):
        v = v._data
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.as_tensor(_np.asarray(v), device=device)


def _internal_outputs(symbol, output_names, output_index):
    """``symbol`` cut to the named internal outputs ("fc1" or
    "fc1_output"), or to the one at ``output_index`` of its internals."""
    if output_names:
        internals = symbol.get_internals()
        names = internals.list_outputs()
        heads = []
        for want in output_names:
            cand = [i for i, n in enumerate(names)
                    if n == want or n == str(want) + "_output"]
            if not cand:
                raise MXNetError("PartialOut: no internal output named "
                                 "'%s'" % want)
            heads.append(internals[cand[-1]])
        return heads[0] if len(heads) == 1 else sym_mod.Group(heads)
    if output_index is not None:
        return symbol.get_internals()[int(output_index)]
    return symbol


class Predictor:
    """One bound inference graph (parity: the PredictorHandle object)."""

    def __init__(self, symbol_json_str, param_bytes_or_dict, ctx=None,
                 input_shapes=None, dev_type=None, dev_id=0,
                 output_index=None, output_names=None, bucket_sizes=None,
                 max_cached_binds=8):
        if input_shapes is None:
            raise MXNetError("Predictor requires input_shapes")
        if ctx is None and dev_type is not None:
            ctx = Context(Context.devid2type.get(dev_type, dev_type), dev_id)
        self._ctx = as_context(ctx) if ctx is not None else current_context()
        device = self._ctx.torch_device
        symbol = sym_mod.load_json(symbol_json_str) \
            if isinstance(symbol_json_str, str) else symbol_json_str
        self._symbol = _internal_outputs(symbol, output_names, output_index)
        params = param_bytes_or_dict
        if isinstance(params, (bytes, bytearray)):
            params = nd.load(_io.BytesIO(bytes(params)))
        self._arg_params = {}
        self._aux_params = {}
        for k, v in params.items():
            # weights land on THIS predictor's device exactly once; a
            # tensor already there is taken as it is (reshaped() shares)
            arr = nd.NDArray(_as_tensor(v, device), self._ctx)
            if k.startswith("aux:"):
                self._aux_params[k[4:]] = arr
            else:
                self._arg_params[k[4:] if k.startswith("arg:") else k] = arr
        self._input_shapes = {k: tuple(v) for k, v in input_shapes.items()}
        self._bucket_sizes = tuple(sorted(set(bucket_sizes))) \
            if bucket_sizes else None
        self._max_cached_binds = max(1, int(max_cached_binds))
        self._bind_cache = _OrderedDict()  # shape key -> (exec, args, outs)
        self._symbol_hash = None
        self._pdone, self._penv = 0, {}  # partial_forward's walk
        self._bind()

    @property
    def symbol_hash(self):
        """A stable digest of the graph's JSON (the model's part of an
        executable-cache key)."""
        if self._symbol_hash is None:
            self._symbol_hash = _hashlib.sha1(
                self._symbol.tojson().encode()).hexdigest()[:16]
        return self._symbol_hash

    @staticmethod
    def shape_key(input_shapes):
        """The bind-cache key for an input-shape dict."""
        return tuple(sorted((k, tuple(v)) for k, v in input_shapes.items()))

    def _bind(self):
        key = self.shape_key(self._input_shapes)
        hit = self._bind_cache.get(key)
        if hit is not None:
            self._bind_cache.move_to_end(key)
            self._executor, self._arg_arrays, self._out_shapes = hit
            return
        self._bind_fresh()
        self._bind_cache[key] = (self._executor, self._arg_arrays,
                                 self._out_shapes)
        while len(self._bind_cache) > self._max_cached_binds:
            self._bind_cache.popitem(last=False)

    def _bind_fresh(self):
        symbol = self._symbol
        arg_shapes, out_shapes, aux_shapes = symbol.infer_shape(
            **self._input_shapes)
        args = {}
        for name, shape in zip(symbol.list_arguments(), arg_shapes):
            if name in self._input_shapes or name not in self._arg_params:
                # inputs, and unfed non-param args (e.g. softmax_label,
                # dead in the inference graph), bind zeros
                args[name] = nd.zeros(shape, self._ctx)
            else:
                args[name] = self._arg_params[name]
        aux = {}
        for name in symbol.list_auxiliary_states():
            if name not in self._aux_params:
                raise MXNetError("predictor: missing aux state %s" % name)
            aux[name] = self._aux_params[name]
        self._executor = symbol.bind(self._ctx, args, aux_states=aux,
                                     grad_req="null")
        self._arg_arrays = args
        self._out_shapes = out_shapes

    def set_input(self, name, value):
        """MXPredSetInput: the value is cast to float32 and copied into
        the bound input."""
        if name not in self._input_shapes:
            raise MXNetError("unknown input %s" % name)
        value = _np.asarray(value, dtype=_np.float32)
        if tuple(value.shape) != tuple(self._input_shapes[name]):
            raise MXNetError("input %s shape %s != bound shape %s" % (
                name, value.shape, self._input_shapes[name]))
        self._arg_arrays[name][:] = value

    def forward(self, **inputs):
        """MXPredForward (optionally setting inputs in one call)."""
        for k, v in inputs.items():
            self.set_input(k, v)
        self._executor.forward(is_train=False)

    def partial_forward(self, step):
        """MXPredPartialForward: run the graph's nodes up to position
        ``step`` of its topological order, one at a time (unfused), from
        where the last call stopped (a smaller ``step`` restarts from
        node 0); returns how many nodes remain. At 0 the outputs are set
        and the walk's intermediate tensors are released."""
        ex = self._executor
        topo = ex._symbol._topo()
        n = len(topo)
        stop = max(0, min(int(step), n))
        if stop < self._pdone:
            self._pdone, self._penv = 0, {}
        args = {k: a._data for k, a in ex.arg_dict.items()}
        aux = {k: a._data for k, a in ex.aux_dict.items()}
        with torch.inference_mode():
            eager_run_range(ex._symbol, self._penv, self._pdone, stop, args,
                            aux, ex._device, topo=topo)
        self._pdone = stop
        if stop == n:
            ex.outputs = [ex._wrap(self._penv[(id(s), i)])
                          for s, i in ex._symbol._outputs]
            self._pdone, self._penv = 0, {}
        return n - stop

    @property
    def num_steps(self):
        """How many nodes ``partial_forward`` steps through."""
        return len(self._executor._symbol._topo())

    def get_output(self, index=0):
        """MXPredGetOutput -> numpy."""
        return self._executor.outputs[index].asnumpy()

    def get_outputs(self):
        """Every output as numpy (one device->host copy each)."""
        return to_host([o._data for o in self._executor.outputs])

    def get_output_shape(self, index=0):
        return tuple(self._out_shapes[index])

    @property
    def num_outputs(self):
        return len(self._out_shapes)

    def reshape(self, new_input_shapes):
        """MXPredReshape: rebind with new shapes. Weights are reused, and a
        shape set seen before reuses its cached executor."""
        self._input_shapes.update(
            {k: tuple(v) for k, v in new_input_shapes.items()})
        self._bind()

    def forward_batch(self, inputs):
        """Numpy outputs of a dict of numpy inputs with any leading batch
        size: padded with zero rows to the smallest of ``bucket_sizes``
        that holds it (the exact size without them), run at that bucket's
        cached executor, and sliced back to the true examples' rows. An
        output with R rows an example (the LM's (B*T, vocab)) keeps its
        first n*R rows; mxtpu keeps n rows whatever R is."""
        from .serving.batcher import pad_rows, pick_bucket
        arrs = {k: _np.asarray(v) for k, v in inputs.items()}
        ns = {a.shape[0] for a in arrs.values()}
        if len(ns) != 1:
            raise MXNetError("forward_batch: inconsistent leading dims")
        n = ns.pop()
        bucket = pick_bucket(n, self._bucket_sizes) \
            if self._bucket_sizes else n
        if bucket < n:
            raise MXNetError("forward_batch: batch %d exceeds largest "
                             "bucket %d" % (n, bucket))
        shapes = {k: (bucket,) + a.shape[1:] for k, a in arrs.items()}
        if shapes != self._input_shapes:
            self.reshape(shapes)
        self.forward(**{k: pad_rows(a, bucket) for k, a in arrs.items()})
        return [out[:n * (out.shape[0] // bucket)]
                for out in self.get_outputs()]

    def reshaped(self, new_input_shapes):
        """MXPredReshape's C contract: a new Predictor at the new input
        shapes over this one's weight tensors (no copy); this one stays
        bound at its shapes."""
        shapes = dict(self._input_shapes)
        shapes.update(new_input_shapes)
        params = {"arg:%s" % k: v for k, v in self._arg_params.items()}
        params.update({"aux:%s" % k: v for k, v in self._aux_params.items()})
        return Predictor(self._symbol, params, ctx=self._ctx,
                         input_shapes=shapes,
                         bucket_sizes=self._bucket_sizes,
                         max_cached_binds=self._max_cached_binds)


def create(symbol_file, param_file, input_shapes, ctx=None):
    """A Predictor from a symbol JSON file and the bytes of a ``.params``
    file (the MXPredCreate file flow)."""
    with open(symbol_file) as f:
        sym_json = f.read()
    with open(param_file, "rb") as f:
        param_bytes = f.read()
    return Predictor(sym_json, param_bytes, ctx=ctx,
                     input_shapes=input_shapes)


def load_checkpoint_predictor(prefix, epoch, input_shapes, ctx=None):
    """A Predictor over a Module/model checkpoint pair."""
    return create("%s-symbol.json" % prefix,
                  "%s-%04d.params" % (prefix, epoch), input_shapes, ctx=ctx)
