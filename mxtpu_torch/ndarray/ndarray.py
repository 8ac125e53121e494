"""NDArray over torch.Tensor: the imperative tensor.

Counterpart of ``mxtpu/ndarray/ndarray.py``: ``NDArray`` (:47) with its
properties, the autograd methods (``attach_grad`` :157, ``backward``
:165, ``detach``), indexing recorded on the tape (:170-241), the
arithmetic and comparison operators over the registered ops (:286-392),
the guarded in-place operators (:360), the reductions and ``transpose``
(:399-415); the imperative invoke ``invoke_op`` (:427) and the creation
functions. ``dtype`` is a numpy dtype, as in mxtpu (bfloat16, which
numpy lacks, gives the stand-in ``registry.BFLOAT16``); ``asnumpy``
returns bfloat16 data as float32. mxtpu's
arrays are immutable and "mutation" rebinds a buffer; here an in-place
write (``x[:] = v``, ``+=``, ``out=``, the aux writeback) writes the
tensor in place under ``no_grad``, so every holder of it sees the new
values and a marked variable stays the same autograd leaf.

``save`` and ``load`` read and write mxtpu's binary format (a copy of
``mxtpu/ndarray/ndarray.py:574-686``), so a file written by either
package loads in the other, bit for bit.
"""
from __future__ import annotations

import json
import struct
from contextlib import nullcontext

import numpy as _np
import torch

from .. import autograd as _ag
from ..base import MXNetError
from ..context import Context, as_context, cpu, current_context
from ..diagnostics import ledger_mod as _ledger_mod
from ..ops.registry import get_op, numpy_dtype, torch_dtype, write_aux

__all__ = ["NDArray", "array", "invoke_op", "imperative_invoke", "waitall",
           "zeros", "ones", "empty", "full", "arange", "concatenate",
           "to_numpy", "host_copies", "save", "load"]


def to_numpy(t):
    """Host numpy copy of a tensor (bfloat16 widened to float32). A CPU
    tensor is copied too: ``.numpy()`` would share its storage, and a
    later in-place write (an update) would show in the caller's array."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    if t.device.type == "cpu":
        return t.numpy().copy()
    return t.cpu().numpy()


def _dtype_str(dtype):
    """MXNet's name of a dtype given as a string, numpy or torch dtype."""
    return dtype if isinstance(dtype, str) else dtype_name(dtype)


def _is_basic(k):
    return isinstance(k, (slice, int, _np.integer)) and \
        not isinstance(k, (bool, _np.bool_))


def _basic_index(t, key):
    """``t[key]`` for int/slice/Ellipsis keys, negative steps included
    (torch slices take positive steps only: such an axis is gathered
    with index_select, which autograd differentiates as mxtpu's take);
    None for any other key."""
    ks = key if isinstance(key, tuple) else (key,)
    ells = [i for i, k in enumerate(ks) if k is Ellipsis]
    if len(ells) > 1:
        return None
    if ells:
        i = ells[0]
        fill = t.ndim - (len(ks) - 1)
        if fill < 0:
            return None
        ks = ks[:i] + (slice(None),) * fill + ks[i + 1:]
    if len(ks) > t.ndim or not all(_is_basic(k) for k in ks):
        return None
    flips, plain, kept = [], [], 0
    for d, k in enumerate(ks):
        if isinstance(k, slice) and k.step is not None and k.step < 0:
            flips.append((kept, _np.arange(*k.indices(t.shape[d]))))
            plain.append(slice(None))
        else:
            plain.append(k)
        kept += isinstance(k, slice)
    out = t[tuple(plain)]
    for d, idx in flips:
        out = torch.index_select(out, d, torch.as_tensor(
            idx, dtype=torch.int64, device=t.device))
    return out


def _track_alloc(arr):
    """Memory-ledger seam of the creation functions (mxtpu
    ndarray.py:31-37): ties the fresh array's storage bytes to its
    lifetime, under the ambient allocation origin ('ndarray' by
    default). One global read when diagnostics are off."""
    if _ledger_mod._ENABLED:
        _ledger_mod._LEDGER.track(arr._data, ctx=str(arr._ctx))
    return arr


class NDArray:
    """An n-dimensional array (a tensor) bound to a Context."""

    __slots__ = ("_data", "_ctx", "grad", "_grad_req", "_tape_gen",
                 "_tape_deps", "__weakref__")
    #: the storage type: "default" (dense); ``sparse.CSRNDArray`` and
    #: ``sparse.RowSparseNDArray`` are "csr" and "row_sparse"
    stype = "default"

    def __init__(self, data, ctx=None):
        self._data = data
        self._ctx = as_context(data.device) if ctx is None else ctx
        self.grad = None
        self._grad_req = "null"
        self._tape_gen = 0
        self._tape_deps = {}

    # ------------------------------------------------ properties
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """The numpy dtype, as mxtpu's ``np.dtype(self._data.dtype)``;
        a bfloat16 array gives the stand-in ``registry.BFLOAT16``."""
        return numpy_dtype(self._data.dtype)

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def context(self):
        return self._ctx

    ctx = context

    @property
    def T(self):
        return invoke_op("transpose", [self], {})[0]

    # ------------------------------------------------ sync / host transfer
    def wait_to_read(self):
        if self._data.device.type == "cuda":
            torch.cuda.current_stream(self._data.device).synchronize()

    wait_to_write = wait_to_read

    def asnumpy(self):
        return to_numpy(self._data)

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def astype(self, dtype):
        return invoke_op("Cast", [self], {"dtype": _dtype_str(dtype)})[0]

    def copy(self):
        return invoke_op("_copy", [self], {})[0]

    def as_in_context(self, ctx):
        ctx = as_context(ctx)
        if ctx == self._ctx:
            return self
        # a copy even where both contexts map to one torch device
        # (cpu(0) -> cpu(1)): each context holds its own array, a new
        # allocation the ledger accounts like a creation
        return _track_alloc(NDArray(self._data.to(ctx.torch_device,
                                                  copy=True), ctx))

    def copyto(self, other):
        """Copy into the NDArray ``other`` (in place) or onto the Context
        ``other`` (a new NDArray); returns the destination."""
        if isinstance(other, NDArray):
            with torch.no_grad():
                other._data.copy_(self._data.reshape(other._data.shape))
            other._written()
            return other
        ctx = as_context(other)
        return NDArray(self._data.detach().to(ctx.torch_device, copy=True),
                       ctx)

    def reshape(self, shape):
        if isinstance(shape, int):
            shape = (shape,)
        return invoke_op("Reshape", [self], {"shape": tuple(shape)})[0]

    def broadcast_to(self, shape):
        return invoke_op("broadcast_to", [self], {"shape": tuple(shape)})[0]

    def expand_dims(self, axis):
        return invoke_op("expand_dims", [self], {"axis": int(axis)})[0]

    def flatten(self):
        return invoke_op("Flatten", [self], {})[0]

    # ------------------------------------------------ autograd
    def attach_grad(self, grad_req="write", stype=None):
        del stype
        grad = NDArray(torch.zeros_like(self._data.detach()), self._ctx)
        _ag.mark_variables([self], [grad], grad_req)

    def detach(self):
        return NDArray(self._data.detach(), self._ctx)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        _ag.backward([self], [out_grad] if out_grad is not None else None,
                     retain_graph=retain_graph, train_mode=train_mode)

    # ------------------------------------------------ indexing
    def __getitem__(self, key):
        if _ag.is_recording():
            # an index must ride the tape, or backward would see the
            # view as a constant: an NDArray key is the take op, a basic
            # key torch's own (recorded) indexing; anything else raises
            if isinstance(key, NDArray):
                return invoke_op("take", [self, key],
                                 {"axis": 0, "mode": "clip"})[0]
            with torch.enable_grad():
                out = _basic_index(self._data, key)
            if out is None:
                raise MXNetError(
                    "autograd: index %r is not differentiable-recordable; "
                    "use basic slices/ints or take() while recording"
                    % (key,))
            res = NDArray(out, self._ctx)
            _ag.record_arrays([self], [res])
            return res
        if isinstance(key, NDArray):
            key = key._data.to(torch.int64)
        with torch.no_grad():
            out = _basic_index(self._data, key)
            if out is None:
                out = self._data[key]
        return NDArray(out, self._ctx)

    def __setitem__(self, key, value):
        self._inplace_guard()
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, (int, float, torch.Tensor)):
            value = torch.as_tensor(_np.asarray(value))
        if isinstance(key, NDArray):
            key = key._data.to(torch.int64)
        with torch.no_grad():
            if isinstance(value, (int, float)):
                if isinstance(key, slice) and key == slice(None):
                    self._data.fill_(value)
                else:
                    self._data[key] = value
            elif isinstance(key, slice) and key == slice(None):
                self._data.copy_(value.reshape(self._data.shape)
                                 if value.numel() == self._data.numel()
                                 else value)
            else:
                self._data[key] = value.to(self._data.device)
        self._written()

    def _written(self):
        """Called after every in-place write to ``_data``: a dense array
        has nothing to do; a sparse one marks its components stale."""

    def __len__(self):
        return self.shape[0]

    def __iter__(self):
        for i in range(self.shape[0]):
            yield self[i]

    def __bool__(self):
        if self.size == 1:
            return bool(self.asnumpy().reshape(())[()])
        raise ValueError(
            "The truth value of an NDArray with %d elements is ambiguous; "
            "use asnumpy() with .any()/.all()" % self.size)

    # ------------------------------------------------ arithmetic
    def _binop(self, other, op, scalar_op):
        if isinstance(other, NDArray):
            return invoke_op(op, [self, other], {})[0]
        return invoke_op(scalar_op, [self], {"scalar": float(other)})[0]

    def _rscalar(self, other, scalar_op, flipped):
        if isinstance(other, NDArray):
            return flipped(other, self)
        return invoke_op(scalar_op, [self], {"scalar": float(other)})[0]

    def __add__(self, o):
        return self._binop(o, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._rscalar(o, "_rminus_scalar", NDArray.__sub__)

    def __mul__(self, o):
        return self._binop(o, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, "broadcast_div", "_div_scalar")

    __div__ = __truediv__

    def __rtruediv__(self, o):
        return self._rscalar(o, "_rdiv_scalar", NDArray.__truediv__)

    __rdiv__ = __rtruediv__

    def __mod__(self, o):
        return self._binop(o, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, o):
        return self._rscalar(o, "_rmod_scalar", NDArray.__mod__)

    def __pow__(self, o):
        return self._binop(o, "broadcast_power", "_power_scalar")

    def __rpow__(self, o):
        return self._rscalar(o, "_rpower_scalar", NDArray.__pow__)

    def __neg__(self):
        return invoke_op("negative", [self], {})[0]

    def __eq__(self, o):
        if isinstance(o, (NDArray, int, float)):
            return self._binop(o, "broadcast_equal", "_equal_scalar")
        return NotImplemented

    def __ne__(self, o):
        if isinstance(o, (NDArray, int, float)):
            return self._binop(o, "broadcast_not_equal", "_not_equal_scalar")
        return NotImplemented

    def __gt__(self, o):
        return self._binop(o, "broadcast_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binop(o, "broadcast_greater_equal",
                           "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binop(o, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binop(o, "broadcast_lesser_equal",
                           "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    def _inplace_guard(self):
        """An array the tape consumed or produced in this generation is
        off-limits for mutation while recording: the backward would read
        other values than the forward did (mxtpu's guard, :360)."""
        if _ag.is_recording() and _ag.on_tape(self):
            raise MXNetError("Inplace update of a recorded array is not "
                             "supported when recording with autograd")

    def _assign(self, result):
        with torch.no_grad():
            if result.shape == self.shape and \
                    result._data.dtype == self._data.dtype:
                self._data.copy_(result._data)
            else:
                self._data = result._data.detach()
        self._written()
        return self

    def __iadd__(self, o):
        self._inplace_guard()
        return self._assign(self.__add__(o))

    def __isub__(self, o):
        self._inplace_guard()
        return self._assign(self.__sub__(o))

    def __imul__(self, o):
        self._inplace_guard()
        return self._assign(self.__mul__(o))

    def __itruediv__(self, o):
        self._inplace_guard()
        return self._assign(self.__truediv__(o))

    def __repr__(self):
        return "%s\n<NDArray %s @%s>" % (
            str(self.asnumpy()), "x".join(str(s) for s in self.shape),
            self._ctx)

    # ------------------------------------------------ reductions
    def sum(self, axis=None, keepdims=False):
        return invoke_op("sum", [self], {"axis": axis,
                                         "keepdims": keepdims})[0]

    def mean(self, axis=None, keepdims=False):
        return invoke_op("mean", [self], {"axis": axis,
                                          "keepdims": keepdims})[0]

    def max(self, axis=None, keepdims=False):
        return invoke_op("max", [self], {"axis": axis,
                                         "keepdims": keepdims})[0]

    def min(self, axis=None, keepdims=False):
        return invoke_op("min", [self], {"axis": axis,
                                         "keepdims": keepdims})[0]

    def argmax(self, axis=None):
        return invoke_op("argmax", [self], {"axis": axis})[0]

    def transpose(self, axes=None):
        return invoke_op("transpose", [self], {"axes": axes or ()})[0]

    def tostype(self, stype):
        """This array in storage ``stype`` ("default": itself)."""
        if stype in (None, "default"):
            return self
        from .sparse import cast_storage
        return cast_storage(self, stype)


# ---------------------------------------------------------------- invoke
def invoke_op(name, nd_inputs, attr_kwargs, out=None):
    """Imperative invoke (parity mxtpu/ndarray/ndarray.py:427): parse the
    attrs (``__is_train__`` from ``autograd.is_training``), run the op
    under torch's grad mode while recording and under ``no_grad``
    otherwise, write an op's updated aux values (BatchNorm's moving
    statistics) into its aux inputs in place (``registry.write_aux``, as
    the executor does), and put the arrays on the tape while recording. ``name`` is an
    op name or an OpDef. Returns the visible outputs as NDArrays (or
    ``out``, written in place)."""
    op = get_op(name) if isinstance(name, str) else name
    if out is not None and _ag.is_recording():
        raise MXNetError(
            "Inplace operations (out=) are not supported when recording with"
            " autograd")
    attrs = dict(attr_kwargs)
    if "__is_train__" in op.attrs_spec:
        attrs.setdefault("__is_train__", _ag.is_training())
    parsed = op.parse_attrs(attrs)
    ctx = nd_inputs[0]._ctx if nd_inputs else \
        _ctx_attr(attr_kwargs.get("ctx"))
    with _ag.grad_mode():
        outs = op.apply(parsed, [x._data for x in nd_inputs],
                        ctx.torch_device)
    n_vis = op.n_out(parsed)
    if op.aux_names and len(outs) > n_vis:
        names = op.input_names(parsed)
        write_aux({an: nd_inputs[names.index(an)]._data
                   for an in op.aux_names},
                  dict(zip(op.aux_names, outs[n_vis:])))
    out_arrays = [NDArray(v, ctx) for v in outs[:n_vis]]
    if _ag.is_recording():
        _ag.record_arrays(nd_inputs, out_arrays)
    if out is not None:
        outs_list = list(out) if isinstance(out, (list, tuple)) else [out]
        with torch.no_grad():
            for dst, src in zip(outs_list, out_arrays):
                dst._data.copy_(src._data)
                dst._written()
        return outs_list
    return out_arrays


imperative_invoke = invoke_op


def _ctx_attr(ctx):
    """The context of an op with no tensor inputs: its ``ctx`` attr (a
    Context, or text such as "gpu(1)"), else the current context."""
    if ctx is None or ctx == "":
        return current_context()
    if isinstance(ctx, str):
        kind, _, rest = ctx.partition("(")
        return Context(kind.strip(), int(rest.rstrip(")") or 0))
    return as_context(ctx)


def _initialised_cuda_devices():
    """The CUDA devices this process has a context on (the ones that can
    hold launched work); none without CUDA or before its first use."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return []
    return [d for d in range(torch.cuda.device_count())
            if torch._C._cuda_hasPrimaryContext(d)]


def waitall():
    """Block until all launched work completes (parity
    Engine::WaitForAll, mxtpu/ndarray/ndarray.py:475-487): the host tasks
    on the dependency engine, when one was started (one nobody started
    holds nothing), then every CUDA device the process has initialised,
    not only the current one."""
    from .. import engine as _engine
    eng = _engine.started()
    if eng is not None:
        eng.wait_for_all()
    for d in _initialised_cuda_devices():
        torch.cuda.synchronize(d)


def _context(ctx):
    """The given context (``cpu(1)`` stays cpu(1) though it maps to the
    one host device), else the current one."""
    return as_context(ctx) if ctx is not None else current_context()


#: the types ``array`` (and ``NDArrayIter``'s batches) narrow when no
#: dtype is given, by name (mxtpu's ``_DTYPE_COERCE``: JAX without x64
#: has no 64-bit types)
NARROW = {"float64": "float32", "int64": "int32"}


def array(source_array, ctx=None, dtype=None):
    """NDArray from a numpy array, list, tensor or NDArray: always a copy,
    so the in-place writes of training (the optimizer's, the aux
    writeback) never reach the source. Its type is ``dtype`` if given,
    else an NDArray's own, else the source's with float64 and int64
    narrowed to float32 and int32, as mxtpu's ``array``."""
    if isinstance(source_array, NDArray):
        source_array = source_array._data.detach()
        dt = source_array.dtype
    else:
        if not isinstance(source_array, torch.Tensor):
            src = _np.asarray(source_array)
            if not src.flags.writeable:  # torch takes writable memory only
                src = src.copy()
            source_array = torch.from_numpy(src)
        dt = torch_dtype(NARROW.get(dtype_name(source_array.dtype),
                                    source_array.dtype))
    if dtype is not None:
        dt = torch_dtype(dtype)
    ctx = _context(ctx)
    return _track_alloc(NDArray(source_array.to(
        device=ctx.torch_device, dtype=dt, copy=True), ctx))


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype="float32", **kwargs):
    del kwargs
    ctx = _context(ctx)
    return _track_alloc(NDArray(torch.zeros(
        _shape(shape), dtype=torch_dtype(dtype), device=ctx.torch_device),
        ctx))


def empty(shape, ctx=None, dtype="float32"):
    return zeros(shape, ctx=ctx, dtype=dtype)


def ones(shape, ctx=None, dtype="float32", **kwargs):
    del kwargs
    ctx = _context(ctx)
    return _track_alloc(NDArray(torch.ones(
        _shape(shape), dtype=torch_dtype(dtype), device=ctx.torch_device),
        ctx))


def full(shape, val, ctx=None, dtype="float32"):
    ctx = _context(ctx)
    return _track_alloc(NDArray(torch.full(
        _shape(shape), val, dtype=torch_dtype(dtype),
        device=ctx.torch_device), ctx))


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    """``start, start+step, ...`` below ``stop`` (from 0 below ``start``
    when ``stop`` is None), each value ``repeat`` times."""
    if stop is None:
        start, stop = 0.0, start
    ctx = _context(ctx)
    out = torch.arange(start, stop, step, dtype=torch.float64,
                       device=ctx.torch_device).to(torch_dtype(dtype))
    if int(repeat) > 1:
        out = torch.repeat_interleave(out, int(repeat))
    return NDArray(out, ctx)


def concatenate(arrays, axis=0, always_copy=True):
    del always_copy
    return invoke_op("Concat", list(arrays),
                     {"num_args": len(arrays), "dim": axis})[0]


# ---------------------------------------------------------------- serialization
# mxtpu's format (parity role of NDArray::Save/Load ndarray.h:361-373):
#   magic 'MXTPU001' | int64 n | per item: int64 len, name | int64 len,
#   JSON header {"shape", "dtype"} | int64 len, raw little-endian bytes
_MAGIC = b"MXTPU001"


def dtype_name(dtype):
    """numpy's name of a torch or numpy dtype ("float32", "bfloat16",
    ...), the name the file header and the checkpoint manifest carry."""
    return str(torch_dtype(dtype)).rsplit(".", 1)[-1]


def host_copies(tensors):
    """cpu() copies of many tensors with one device->host copy per dtype:
    the device tensors of one dtype are concatenated on their device,
    copied once, and split on the host. Host tensors are cloned."""
    out = [None] * len(tensors)
    groups = {}
    for i, t in enumerate(tensors):
        t = t.detach()
        if t.device.type == "cpu":
            out[i] = t.clone()
        else:
            groups.setdefault((t.device, t.dtype), []).append(i)
    for idxs in groups.values():
        flat = torch.cat([tensors[i].detach().reshape(-1)
                          for i in idxs]).cpu()
        for i, part in zip(idxs, torch.split(
                flat, [tensors[i].numel() for i in idxs])):
            out[i] = part.reshape(tensors[i].shape)
    return out


def _raw_bytes(t):
    """(numpy name of the dtype, a contiguous numpy view of the bytes) of
    a host tensor or numpy array."""
    if isinstance(t, _np.ndarray):
        return t.dtype.name, _np.ascontiguousarray(t)
    t = t.contiguous()
    if t.dtype == torch.bfloat16:  # numpy has no bfloat16: its bits
        return "bfloat16", t.view(torch.int16).numpy()
    return dtype_name(t.dtype), t.numpy()


def save(fname, data):
    """Save NDArrays (or tensors): a list, or a dict by name (parity
    mx.nd.save). Every array reaches the host in one copy per dtype."""
    if isinstance(data, (NDArray, torch.Tensor)):
        data = [data]
    items = list(data.items()) if isinstance(data, dict) else \
        [("", v) for v in data]
    host = host_copies([getattr(v, "_data", v) for _, v in items])
    save_host(fname, [(name, t) for (name, _), t in zip(items, host)])


def save_host(fname, items):
    """``save``'s file from ``[(name, host array)]`` (cpu tensors or numpy
    arrays), written from the arrays' own memory without another copy:
    the caller's arrays are already its own (the elastic snapshot
    writer's)."""
    with open(fname, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<q", len(items)))
        for name, t in items:
            dtype, raw = _raw_bytes(t)
            hdr = json.dumps({"shape": list(t.shape),
                              "dtype": dtype}).encode()
            for chunk in (name.encode(), hdr):
                f.write(struct.pack("<q", len(chunk)))
                f.write(chunk)
            f.write(struct.pack("<q", raw.nbytes))
            f.write(memoryview(raw.reshape(-1)).cast("B"))


def _from_raw(raw, dtype, shape):
    if dtype == "bfloat16":
        arr = _np.frombuffer(raw, dtype=_np.int16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    arr = _np.frombuffer(raw, dtype=_np.dtype(dtype)).reshape(shape)
    return torch.from_numpy(arr.copy())


def load(fname):
    """Load NDArrays written by ``save`` (either package's): a dict when
    the file names them, else a list, of cpu() NDArrays in the stored
    dtype, as the reference loads onto the host. ``fname`` is a path or
    a binary file object."""
    opened = nullcontext(fname) if hasattr(fname, "read") else \
        open(fname, "rb")
    named, unnamed = {}, []
    with opened as f:
        if f.read(8) != _MAGIC:
            raise MXNetError("invalid NDArray file %s" % (fname,))

        def chunk():
            (n,) = struct.unpack("<q", f.read(8))
            return f.read(n)

        (n,) = struct.unpack("<q", f.read(8))
        for _ in range(n):
            name = chunk().decode()
            hdr = json.loads(chunk().decode())
            arr = NDArray(_from_raw(chunk(), hdr["dtype"], hdr["shape"]),
                          cpu())
            if name:
                named[name] = arr
            else:
                unnamed.append(arr)
    return named if named else unnamed
