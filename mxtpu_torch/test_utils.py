"""The part of mxtpu's test harness that the example scripts use.

Counterpart of ``mxtpu/test_utils.py:19-90``: ``default_context``,
``set_default_context``, ``default_dtype``, ``same``, ``almost_equal``
and ``assert_almost_equal`` (with ``find_max_violation``), and the
sparse helpers (:40, :378-490): ``rand_ndarray`` (with ``stype``),
``rand_sparse_ndarray``, ``create_sparse_array``,
``create_sparse_array_zd`` and ``shuffle_csr_column_indices``, drawing
from a module ``RandomState(1234)`` as mxtpu's do. The default
context is the port's, ``gpu(0)`` unless a ``with ctx:`` scope or
``set_default_context`` names another: it raises on a host without
CUDA, as every entry point of the port does.
"""
from __future__ import annotations

import os

import numpy as _np

from . import context as ctx_mod
from . import ndarray as nd

__all__ = ["default_context", "set_default_context", "default_dtype",
           "same", "find_max_violation", "assert_almost_equal",
           "almost_equal", "make_rec", "make_det_rec", "rand_ndarray",
           "rand_sparse_ndarray", "create_sparse_array",
           "create_sparse_array_zd", "shuffle_csr_column_indices"]

_rng = _np.random.RandomState(1234)


def default_context():
    return ctx_mod.current_context()


def set_default_context(ctx):
    ctx_mod.Context._default_ctx.stack = [ctx]


def default_dtype():
    return _np.float32


def same(a, b):
    return _np.array_equal(a, b)


def find_max_violation(a, b, rtol=None, atol=None):
    rtol = rtol or 1e-5
    atol = atol or 1e-20
    diff = _np.abs(a - b)
    tol = atol + rtol * _np.abs(b)
    violation = diff / (tol + 1e-20)
    loc = _np.unravel_index(_np.argmax(violation), violation.shape)
    return violation[loc], loc


def _numpy(x):
    return x.asnumpy() if isinstance(x, nd.NDArray) else _np.asarray(x)


def assert_almost_equal(a, b, rtol=1e-5, atol=1e-20, names=("a", "b")):
    """Raise AssertionError unless ``a`` and ``b`` agree within
    ``atol + rtol * |b|`` element by element (NaN equal to NaN)."""
    a, b = _numpy(a), _numpy(b)
    if _np.allclose(a, b, rtol=rtol, atol=atol, equal_nan=True):
        return
    index, rel = find_max_violation(a, b, rtol, atol)
    raise AssertionError(
        "Error %f exceeds tolerance rtol=%f, atol=%f. Location of maximum "
        "error: %s, %s=%s, %s=%s"
        % (index, rtol, atol, str(rel), names[0],
           a.flat[0] if a.size else a, names[1], b.flat[0] if b.size else b))


def almost_equal(a, b, rtol=1e-5, atol=1e-20):
    return _np.allclose(a, b, rtol=rtol, atol=atol, equal_nan=True)


def make_rec(path, n, edge=256, seed=0, num_classes=1000, quality=90):
    """Pack ``n`` JPEG records of ``edge`` x ``edge`` (``.rec`` at
    ``path``, ``.idx`` beside it), as ``tools/bench_input.make_rec``: one
    seeded random base image rolled along its width and one channel
    brightened a record, so the JPEGs compress as real photographs do;
    the label of record ``i`` is ``i % num_classes``. Returns ``path``."""
    from . import recordio
    rng = _np.random.RandomState(seed)
    rec = recordio.MXIndexedRecordIO(os.path.splitext(path)[0] + ".idx",
                                     path, "w")
    base = rng.randint(0, 255, size=(edge, edge, 3), dtype=_np.uint8)
    for i in range(n):
        img = _np.roll(base, shift=int(rng.randint(0, edge)), axis=1).copy()
        img[:, :, i % 3] = _np.minimum(255, img[:, :, i % 3] * 1.2).astype(
            _np.uint8)
        hdr = recordio.IRHeader(0, float(i % num_classes), i, 0)
        rec.write_idx(i, recordio.pack_img(hdr, img, quality=quality,
                                           img_fmt=".jpg"))
    rec.close()
    return path


def make_det_rec(path, n, edge=300, num_classes=20, seed=0, quality=90):
    """Pack ``n`` detection records: ``models.ssd_data.make_batch``'s
    painted box on its dim background, at ``edge`` x ``edge``, scaled to
    uint8 and JPEG-encoded, with the label ``[2, 5, cls, xmin, ymin,
    xmax, ymax]`` (header width 2, object width 5, coordinates in [0, 1]).
    Returns ``path``; the ``.idx`` is beside it."""
    from . import recordio
    from .models import ssd_data
    rng = _np.random.RandomState(seed)
    rec = recordio.MXIndexedRecordIO(os.path.splitext(path)[0] + ".idx",
                                     path, "w")
    for i in range(n):
        x, lab = ssd_data.make_batch(rng, 1, (3, edge, edge), num_classes)
        img = (x[0].transpose(1, 2, 0) * 255.0).round().astype(_np.uint8)
        label = [2.0, 5.0] + [float(v) for v in lab[0, 0]]
        hdr = recordio.IRHeader(0, label, i, 0)
        rec.write_idx(i, recordio.pack_img(hdr, img, quality=quality,
                                           img_fmt=".jpg"))
    rec.close()
    return path


def rand_ndarray(shape, stype="default", density=None):
    """A random NDArray of ``shape``: uniform in [-1, 1), or sparse of
    ``stype`` (``rand_sparse_ndarray``)."""
    if stype != "default":
        arr, _ = rand_sparse_ndarray(shape, stype, density=density)
        return arr
    return nd.array(_rng.uniform(-1, 1, size=shape))


def _dense_to_sparse(dense, stype):
    from .ndarray import sparse
    if stype == "csr":
        return sparse.csr_matrix(dense)
    if stype == "row_sparse":
        return sparse.row_sparse_array(dense)
    raise ValueError("unknown storage type %s" % stype)


def rand_sparse_ndarray(shape, stype, density=None, dtype=None):
    """(a random sparse NDArray of ``stype``, its dense numpy twin): values
    uniform in [-1, 1), each kept with probability ``density`` (0.3)."""
    density = 0.3 if density is None else density
    dtype = _np.float32 if dtype is None else _np.dtype(dtype)
    dense = _rng.uniform(-1, 1, size=shape).astype(dtype)
    dense[_rng.uniform(size=shape) > density] = 0
    return _dense_to_sparse(dense, stype), dense


def create_sparse_array(shape, stype, data_init=None, density=0.5,
                        dtype=None):
    """A sparse NDArray filled with ``data_init`` or random values in [0,
    1) kept with probability ``density``."""
    dtype = _np.float32 if dtype is None else _np.dtype(dtype)
    if data_init is not None:
        dense = _np.full(shape, data_init, dtype)
    else:
        dense = _rng.uniform(0, 1, size=shape).astype(dtype)
        dense[_rng.uniform(size=shape) > density] = 0
    return _dense_to_sparse(dense, stype)


def create_sparse_array_zd(shape, stype, density=0.05, **kwargs):
    """A random sparse NDArray that may hold no value at all (numpy's
    global generator, as mxtpu's)."""
    del kwargs
    dense = _np.random.rand(*shape) * (_np.random.rand(*shape) < density)
    return nd.array(dense.astype("float32")).tostype(stype)


def shuffle_csr_column_indices(csr):
    """mxtpu's stand-in: the dense values of ``csr`` (a dense round trip
    keeps no index order to shuffle)."""
    return csr.asnumpy()
