"""Sparse NDArray storage types: CSR and RowSparse.

Counterpart of ``mxtpu/ndarray/sparse.py``: ``BaseSparseNDArray`` (:35)
with the dense view every dense op reads (the storage fallback) and the
lazy rebuild of the components after a dense write, ``CSRNDArray``
(:113; ``data``/``indices``/``indptr``, ``nnz``, ``copy``, the row slice
``__getitem__`` :206), ``RowSparseNDArray`` (:225; ``retain``), the
constructors ``csr_matrix``, ``row_sparse_array``, ``zeros``, ``empty``
and ``array``, and the ops ``cast_storage`` (:373), ``sparse_retain``
(:387), ``dot`` (:399) and ``add`` (:425).

The components are tensors on the array's context, with mxtpu's types:
the data narrowed as ``jnp.asarray`` narrows it (float64 to float32,
int64 to int32), every index int32; ``dtype`` is the numpy type the
array was made from, as mxtpu's. The constructors and ``cast_storage``
convert from host sources in numpy, as mxtpu's (and the reference's
``cast_storage`` on the CPU) do; everything else runs on the array's
device: the dense view, the components' rebuild after a dense write,
row slices, ``copy``, ``sparse_retain`` and ``add``. ``dot`` of a CSR
array and a dense one is a ``torch.sparse_csr_tensor`` product on the
device (mxtpu's BCOO ``dot_general``); with ``transpose_a`` the product
is the COO of the transpose times the dense array, kept as a
``RowSparseNDArray`` over the unique column ids, as mxtpu keeps it.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError
from ..context import current_context
from ..ops.registry import numpy_dtype, torch_dtype
from .ndarray import NARROW, NDArray

__all__ = ["BaseSparseNDArray", "CSRNDArray", "RowSparseNDArray",
           "csr_matrix", "row_sparse_array", "zeros", "empty", "array",
           "cast_storage", "sparse_retain", "dot", "add"]


def _host(x):
    """A numpy array of a numpy array, list, tensor or NDArray."""
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return _np.asarray(x)


def _component(values, ctx, dtype=None):
    """A tensor on ``ctx`` of host ``values``: ``dtype`` if given, else
    the values' own type with 64-bit types narrowed, as ``jnp.asarray``
    without x64 narrows them."""
    v = _np.ascontiguousarray(values)
    if dtype is None:
        dtype = NARROW.get(v.dtype.name, v.dtype.name)
    return torch.from_numpy(v).to(device=ctx.torch_device,
                                  dtype=torch_dtype(dtype))


class BaseSparseNDArray(NDArray):
    """The common base: ``_data`` is the dense view, built on first read
    (every dense op works through it, the storage fallback); writing
    ``_data`` (a pull into the array, an update) marks the components
    stale, and the next component read rebuilds them from the dense
    values on the device."""

    __slots__ = ("_sp_shape", "_sp_dtype", "_dense", "_stale")

    def __init__(self, shape, dtype, ctx=None):
        self._ctx = ctx or current_context()
        self.grad = None
        self._grad_req = "null"
        self._tape_gen = 0
        self._tape_deps = {}
        self._sp_shape = tuple(int(s) for s in shape)
        self._sp_dtype = _np.dtype(dtype)
        self._dense = None
        self._stale = False

    @property
    def _data(self):
        if self._dense is None:
            self._dense = self._to_dense()
        return self._dense

    @_data.setter
    def _data(self, v):
        self._dense = v
        self._stale = True

    @classmethod
    def _of(cls, shape, ctx, *components, dtype=None):
        """An array holding ``components``, tensors on ``ctx``'s device
        (no host round trip); ``dtype`` defaults to the data's."""
        out = cls.__new__(cls)
        BaseSparseNDArray.__init__(
            out, shape, dtype or numpy_dtype(components[0].dtype), ctx)
        out._hold(*components)
        return out

    def _written(self):
        """An in-place write went to the dense view (``x[:] = v``, ``+=``,
        an op's ``out=``, ``copyto``): rebuild the components from it on
        their next read."""
        if self._dense is not None:
            self._stale = True

    def __getitem__(self, key):
        """A copy, as mxtpu's index of a sparse array is: a write to it
        never reaches this array (the dense array's basic index is a
        write-through view, C.14)."""
        out = super().__getitem__(key)
        if not isinstance(out, BaseSparseNDArray) and \
                out._data._base is not None:
            out._data = out._data.clone()
        return out

    def _sync(self):
        if self._stale:
            self._stale = False
            self._refresh_from_dense(self._dense.detach())

    def _hold(self, *components):
        raise NotImplementedError

    def _refresh_from_dense(self, dense):
        raise NotImplementedError

    def _to_dense(self):
        raise NotImplementedError

    @property
    def shape(self):
        return self._sp_shape

    @property
    def dtype(self):
        return self._sp_dtype

    @property
    def ndim(self):
        return len(self._sp_shape)

    @property
    def size(self):
        return int(_np.prod(self._sp_shape, dtype=_np.int64))

    def todense(self):
        return NDArray(self._data, self._ctx)

    def tostype(self, stype):
        if stype == self.stype:
            return self
        if stype == "default":
            return self.todense()
        return cast_storage(self.todense(), stype)


class CSRNDArray(BaseSparseNDArray):
    """A 2-D compressed-sparse-row array: ``data`` (nnz,), ``indices``
    (nnz,) column ids and ``indptr`` (rows + 1,) row offsets."""

    __slots__ = ("_spd", "_spi", "_spp")
    stype = "csr"

    def __init__(self, data, indices, indptr, shape, ctx=None):
        data = _host(data)
        super().__init__(shape, data.dtype, ctx)
        self._hold(_component(data, self._ctx),
                   _component(_host(indices), self._ctx, "int32"),
                   _component(_host(indptr), self._ctx, "int32"))

    def _hold(self, data, indices, indptr):
        self._spd = data
        self._spi = indices.to(torch.int32)
        self._spp = indptr.to(torch.int32)

    def _components(self):
        self._sync()
        return self._spd, self._spi, self._spp

    @property
    def data(self):
        return NDArray(self._components()[0], self._ctx)

    @property
    def indices(self):
        return NDArray(self._components()[1], self._ctx)

    @property
    def indptr(self):
        return NDArray(self._components()[2], self._ctx)

    @property
    def nnz(self):
        return int(self._components()[0].shape[0])

    def _rows(self):
        """Each stored value's row (nnz,) int64, on the device."""
        _, _, indptr = self._components()
        counts = (indptr[1:] - indptr[:-1]).to(torch.int64)
        return torch.repeat_interleave(
            torch.arange(self._sp_shape[0], device=indptr.device), counts)

    def _to_dense(self):
        data, indices, _ = self._components()
        out = torch.zeros(self._sp_shape, dtype=data.dtype,
                          device=data.device)
        out[self._rows(), indices.to(torch.int64)] = data
        return out

    def _refresh_from_dense(self, dense):
        rows, cols = torch.nonzero(dense, as_tuple=True)
        self._hold(dense[rows, cols], cols, _indptr(rows, dense.shape[0]))

    def _torch_csr(self):
        """The array as a ``torch.sparse_csr_tensor`` on its device."""
        data, indices, indptr = self._components()
        return torch.sparse_csr_tensor(indptr, indices, data,
                                       self._sp_shape, check_invariants=False)

    def copy(self):
        return CSRNDArray._of(self._sp_shape, self._ctx,
                              *[c.clone() for c in self._components()])

    def __getitem__(self, key):
        if isinstance(key, slice):
            if key.step not in (None, 1):
                raise MXNetError(
                    "CSRNDArray slicing supports step=1 only (got step=%s)"
                    % key.step)
            start, stop, _ = key.indices(self._sp_shape[0])
            stop = max(stop, start)
            data, indices, indptr = self._components()
            lo, hi = int(indptr[start]), int(indptr[stop])
            return CSRNDArray._of((stop - start, self._sp_shape[1]),
                                  self._ctx, data[lo:hi].clone(),
                                  indices[lo:hi].clone(),
                                  indptr[start:stop + 1] - lo)
        return super().__getitem__(key)


class RowSparseNDArray(BaseSparseNDArray):
    """An array sparse in its first dimension: ``data[i]`` is the whole
    slice of row ``indices[i]`` (the storage of embedding and sparse
    gradients)."""

    __slots__ = ("_spd", "_spi")
    stype = "row_sparse"

    def __init__(self, data, indices, shape, ctx=None):
        data = _host(data)
        super().__init__(shape, data.dtype, ctx)
        self._hold(_component(data, self._ctx),
                   _component(_host(indices), self._ctx, "int32"))

    def _hold(self, data, indices):
        self._spd = data
        self._spi = indices.to(torch.int32)

    def _components(self):
        self._sync()
        return self._spd, self._spi

    def _set_rows(self, data, indices):
        """Make the tensors ``data`` at the rows ``indices`` the array's
        value, on its device (a row_sparse pull)."""
        dev = self._ctx.torch_device
        self._hold(data.to(dev), indices.to(dev))
        self._dense = None
        self._stale = False

    @property
    def data(self):
        return NDArray(self._components()[0], self._ctx)

    @property
    def indices(self):
        return NDArray(self._components()[1], self._ctx)

    def _to_dense(self):
        data, indices = self._components()
        out = torch.zeros(self._sp_shape, dtype=data.dtype,
                          device=data.device)
        if data.shape[0]:
            out[indices.to(torch.int64)] = data
        return out

    def _refresh_from_dense(self, dense):
        rows = torch.nonzero(
            (dense.reshape(dense.shape[0], -1) != 0).any(1)).reshape(-1)
        self._hold(dense[rows], rows)

    def copy(self):
        return RowSparseNDArray._of(self._sp_shape, self._ctx,
                                    *[c.clone() for c in self._components()])

    def retain(self, indices):
        return sparse_retain(self, indices)


# ------------------------------------------------------------ constructors
def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from (data, indices, indptr), a scipy.sparse matrix or
    a dense source."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        data = _host(data).astype(dtype or _np.float32)
        return CSRNDArray(data, _host(indices), _host(indptr), shape, ctx)
    if hasattr(arg1, "tocsr"):  # scipy sparse
        m = arg1.tocsr()
        return CSRNDArray(m.data.astype(dtype or m.dtype), m.indices,
                          m.indptr, m.shape, ctx)
    dense = _host(arg1)
    if dtype is not None:
        dense = dense.astype(dtype)
    return _dense_to_csr(dense, ctx)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from (data, indices) and ``shape``, or from a
    dense source."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        data = _host(data).astype(dtype or _np.float32)
        if shape is None:
            raise MXNetError("row_sparse_array((data, indices)) needs shape")
        return RowSparseNDArray(data, _host(indices), shape, ctx)
    dense = _host(arg1)
    if dtype is not None:
        dense = dense.astype(dtype)
    return _dense_to_rsp(dense, ctx)


def _indptr(rows, n):
    """The (n + 1,) row offsets of sorted row ids ``rows``, on their
    device."""
    counts = torch.bincount(rows, minlength=n)
    return torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])


def _dense_to_csr(dense, ctx=None):
    if dense.ndim != 2:
        raise MXNetError("csr storage requires 2D")
    n, m = dense.shape
    rows, cols = _np.nonzero(dense)
    counts = _np.bincount(rows, minlength=n)
    indptr = _np.concatenate([[0], _np.cumsum(counts)])
    return CSRNDArray(dense[rows, cols], cols, indptr, (n, m), ctx)


def _dense_to_rsp(dense, ctx=None):
    rows = _np.nonzero(_np.any(dense.reshape(dense.shape[0], -1) != 0,
                               axis=1))[0]
    return RowSparseNDArray(dense[rows], rows, dense.shape, ctx)


def zeros(stype, shape, ctx=None, dtype="float32"):
    dtype = _np.dtype(dtype)
    shape = tuple(shape)
    if stype == "csr":
        return CSRNDArray(_np.zeros((0,), dtype), _np.zeros((0,), _np.int64),
                          _np.zeros((shape[0] + 1,), _np.int64), shape, ctx)
    if stype == "row_sparse":
        return RowSparseNDArray(_np.zeros((0,) + shape[1:], dtype),
                                _np.zeros((0,), _np.int64), shape, ctx)
    if stype == "default":
        from .ndarray import zeros as dense_zeros
        return dense_zeros(shape, ctx, str(dtype))
    raise MXNetError("unknown stype %s" % stype)


def empty(stype, shape, ctx=None, dtype="float32"):
    return zeros(stype, shape, ctx, dtype)


def array(source, ctx=None, dtype=None):
    """A sparse array from a sparse source (a sparse NDArray: a copy; a
    scipy.sparse matrix: CSR)."""
    if isinstance(source, BaseSparseNDArray):
        return source.copy()
    if hasattr(source, "tocsr"):
        return csr_matrix(source, ctx=ctx, dtype=dtype)
    raise MXNetError("sparse.array expects a sparse source; use nd.array")


# ------------------------------------------------------------ sparse ops
def cast_storage(arr, stype):
    """Convert between storage types; to sparse storage on the host."""
    if stype == arr.stype:
        return arr
    if stype == "default":
        return arr.todense() if isinstance(arr, BaseSparseNDArray) else arr
    dense = arr.asnumpy()
    if stype == "csr":
        return _dense_to_csr(dense, arr.context)
    if stype == "row_sparse":
        return _dense_to_rsp(dense, arr.context)
    raise MXNetError("unknown stype %s" % stype)


def sparse_retain(arr, indices):
    """The rows of a row_sparse array whose ids are in ``indices``, on the
    array's device."""
    if not isinstance(arr, RowSparseNDArray):
        raise MXNetError("sparse_retain expects row_sparse storage")
    data, have = arr._components()
    want = indices._data if isinstance(indices, NDArray) \
        else torch.as_tensor(_np.asarray(indices))
    mask = torch.isin(have.to(torch.int64),
                      want.to(device=have.device, dtype=torch.int64))
    return RowSparseNDArray._of(arr.shape, arr.context, data[mask],
                                have[mask])


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Sparse-aware dot. CSR · dense on the device (a
    ``torch.sparse_csr_tensor`` product) gives a dense NDArray; CSRᵀ ·
    dense gives a RowSparseNDArray over the unique column ids of the CSR
    array; any other mix densifies its sparse side."""
    from . import dot as dense_dot

    if isinstance(lhs, CSRNDArray) and not isinstance(rhs,
                                                      BaseSparseNDArray):
        rhs_mat = rhs._data.t() if transpose_b else rhs._data
        vector = rhs_mat.dim() == 1  # a column, and the result 1-D
        if vector:
            rhs_mat = rhs_mat.reshape(-1, 1)
        if transpose_a:
            data, indices, _ = lhs._components()
            rows = lhs._rows()
            n, m = lhs.shape
            coo = torch.sparse_coo_tensor(
                torch.stack([indices.to(torch.int64), rows]), data, (m, n),
                check_invariants=False)
            out = torch.sparse.mm(coo, rhs_mat)
            if vector:
                out = out.reshape(-1)
            ids = torch.unique(indices.to(torch.int64))
            return RowSparseNDArray._of(out.shape, lhs.context, out[ids],
                                        ids)
        out = torch.sparse.mm(lhs._torch_csr(), rhs_mat.contiguous())
        return NDArray(out.reshape(-1) if vector else out, lhs.context)
    if isinstance(lhs, BaseSparseNDArray) or isinstance(rhs,
                                                        BaseSparseNDArray):
        lhs = lhs.todense() if isinstance(lhs, BaseSparseNDArray) else lhs
        rhs = rhs.todense() if isinstance(rhs, BaseSparseNDArray) else rhs
    return dense_dot(lhs, rhs, transpose_a=transpose_a,
                     transpose_b=transpose_b)


def add(lhs, rhs):
    """Elementwise add: row_sparse + row_sparse stays row_sparse, csr + csr
    stays csr (a merge of the components on the arrays' device, never
    dense); any other pair adds densely."""
    if isinstance(lhs, RowSparseNDArray) and isinstance(rhs,
                                                        RowSparseNDArray):
        ldata, lidx = lhs._components()
        rdata, ridx = [c.to(ldata.device) for c in rhs._components()]
        lidx, ridx = lidx.to(torch.int64), ridx.to(torch.int64)
        idx = torch.unique(torch.cat([lidx, ridx]))
        data = ldata.new_zeros((len(idx),) + tuple(lhs.shape[1:]))
        data.index_add_(0, torch.searchsorted(idx, lidx), ldata)
        data.index_add_(0, torch.searchsorted(idx, ridx),
                        rdata.to(data.dtype))
        return RowSparseNDArray._of(lhs.shape, lhs.context, data, idx,
                                    dtype=lhs.dtype)
    if isinstance(lhs, CSRNDArray) and isinstance(rhs, CSRNDArray):
        n, m = lhs.shape
        dev = lhs._components()[0].device
        # each stored value's key row * m + column, merged in sorted order
        keys = torch.cat([x._rows().to(dev) * m
                          + x._components()[1].to(dev, torch.int64)
                          for x in (lhs, rhs)])
        vals = torch.cat([x._components()[0].to(dev) for x in (lhs, rhs)])
        keys, order = torch.sort(keys, stable=True)
        uniq, group = torch.unique_consecutive(keys, return_inverse=True)
        data = vals.new_zeros(len(uniq)).index_add_(0, group, vals[order])
        # the type numpy promotes the two data to, as mxtpu's merge does
        dtype = _np.result_type(*[numpy_dtype(x._components()[0].dtype)
                                  for x in (lhs, rhs)])
        return CSRNDArray._of(lhs.shape, lhs.context, data, uniq % m,
                              _indptr(uniq // m, n), dtype=dtype)
    return NDArray(lhs._data + rhs._data, lhs._ctx)
