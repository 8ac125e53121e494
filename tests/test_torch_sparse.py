"""The sparse NDArray of the port (``mxtpu_torch/ndarray/sparse.py``)
against mxtpu's, one body through both packages on the CPU: every
constructor (``csr_matrix`` from components, a dense array and a
scipy matrix; ``row_sparse_array``; ``zeros``/``empty`` of each storage;
``array``), the components (values, dtypes, shapes), ``nnz``, ``stype``,
``copy``, CSR row slices, ``cast_storage``/``tostype`` both ways, ``dot``
(csr·dense, with ``transpose_b``, csrᵀ·dense as row_sparse, dense·csr),
``add``/``elemwise_add`` (rsp+rsp, csr+csr, mixed), ``sparse_retain``
and ``retain``, a dense write rebuilding the components, the bodies
that once went wrong (``final_op_cases.SPARSE_FAULTS``), and
``test_utils``' sparse helpers from one seed. Values exact where the
arithmetic is a copy, within 1e-6 where it sums. Then the sparse
example's flow (``models/sparse_linear.py``: LibSVMIter's csr batches,
``row_sparse_pull`` from a local kvstore, a row_sparse gradient pushed
through SGD) for 2 epochs: the accuracies equal mxtpu's.

torch is imported lazily and pinned to one thread: several test workers
share the host."""
import os
import sys

import numpy as np
import pytest

import mxtpu as mx
from final_op_cases import SPARSE_FAULTS, sparse_device_ops

D = np.array([[0.0, 1.5, 0.0, 0.0], [2.0, 0.0, 0.0, -3.0],
              [0.0, 0.0, 0.0, 0.0], [0.0, 4.0, 5.0, 0.0]], np.float32)
W = np.arange(8, dtype=np.float32).reshape(4, 2) - 3.0


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


def _parts(a):
    """Everything an array shows: its storage, shape, dtype, dense values
    and components."""
    out = [a.stype, tuple(a.shape), np.dtype(a.dtype).name, a.asnumpy()]
    for name in ("data", "indices", "indptr"):
        c = getattr(a, name, None)
        if a.stype != "default" and c is not None and \
                not (name == "indptr" and a.stype == "row_sparse"):
            out += [name, c.asnumpy()]
    if a.stype == "csr":
        out.append(a.nnz)
    return out


def _same(got, want, tol=0.0):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g) is type(w) or isinstance(w, np.ndarray), (g, w)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, (g, w)
            np.testing.assert_allclose(g, w, rtol=0, atol=tol)
        else:
            assert g == w, (g, w)


def _both(mt, body, tol=0.0):
    with mx.cpu():
        want = body(mx)
    with mt.cpu():
        got = body(mt)
    for g, w in zip(got, want):
        _same(_parts(g) if hasattr(g, "stype") else g,
              _parts(w) if hasattr(w, "stype") else w, tol)
    assert len(got) == len(want)


def test_constructors_match_mxtpu(mt):
    import scipy.sparse as sps

    def body(pkg):
        sp = pkg.nd.sparse
        data, indices, indptr = [1.5, 2.0, -3.0, 4.0, 5.0], \
            [1, 0, 3, 1, 2], [0, 1, 3, 3, 5]
        return [sp.csr_matrix((data, indices, indptr), shape=(4, 4)),
                sp.csr_matrix(D), sp.csr_matrix(pkg.nd.array(D)),
                sp.csr_matrix(sps.csr_matrix(D)),
                sp.csr_matrix(D.astype(np.float64), dtype="float32"),
                sp.row_sparse_array(([[1.0, 2.0], [3.0, 4.0]], [0, 3]),
                                    shape=(5, 2)),
                sp.row_sparse_array(D), sp.zeros("csr", (3, 5)),
                sp.zeros("row_sparse", (4, 2, 3)),
                sp.zeros("default", (2, 3)), sp.empty("row_sparse", (3, 2)),
                sp.array(sp.csr_matrix(D)),
                sp.array(sps.csr_matrix(D))]

    _both(mt, body)


def test_components_slices_and_conversions_match_mxtpu(mt):
    def body(pkg):
        nd = pkg.nd
        c = nd.sparse.csr_matrix(D)
        r = nd.sparse.row_sparse_array(D)
        dense = nd.array(D)
        return [c.copy(), r.copy(), c[1:4], c[0:0], c[2:3], c[1],
                nd.cast_storage(dense, stype="csr"),
                nd.cast_storage(dense, stype="row_sparse"),
                nd.cast_storage(c, stype="default"),
                nd.cast_storage(r, "default"), dense.tostype("csr"),
                dense.tostype("row_sparse"), dense.tostype("default"),
                c.tostype("row_sparse"), r.tostype("csr"),
                c.tostype("csr"), r.todense(), c + 1, r * 2]

    _both(mt, body)


def test_dot_add_and_retain_match_mxtpu(mt):
    def body(pkg):
        nd = pkg.nd
        c = nd.sparse.csr_matrix(D)
        c2 = nd.sparse.csr_matrix(D.T.copy() * 0.5)
        r = nd.sparse.row_sparse_array(D)
        r2 = nd.sparse.row_sparse_array(
            ([[1.0, 1.0, 1.0, 1.0], [2.0, 0.0, 0.0, 2.0]], [0, 1]),
            shape=(4, 4))
        w = nd.array(W)
        return [nd.dot(c, w), nd.dot(c, nd.array(W.T.copy()),
                                     transpose_b=True),
                nd.dot(c, w, transpose_a=True),
                nd.dot(nd.array(D), c), nd.dot(r, nd.array(D)),
                nd.elemwise_add(r, r2), nd.sparse.add(c, c2),
                nd.elemwise_add(c, c2), nd.elemwise_add(nd.array(D), r),
                nd.sparse.add(nd.array(D), c),
                nd.sparse_retain(r, nd.array(np.array([3.0, 0.0]))),
                nd._sparse_retain(r, nd.array(np.array([2.0]))),
                r.retain(nd.array(np.array([1.0, 3.0])))]

    _both(mt, body, tol=1e-6)


@pytest.mark.parametrize("name,body", SPARSE_FAULTS,
                         ids=[n for n, _ in SPARSE_FAULTS])
def test_sparse_faults_match_mxtpu(mt, name, body):
    """In-place writes rebuild the components (an index is a copy), dots
    of a CSR array and a vector, csr + csr of two types."""
    _both(mt, body, 1e-6)


def test_a_dense_write_rebuilds_the_components(mt):
    """A write of the dense view (a pull into a sparse array) marks the
    components stale; the next read rebuilds them, as mxtpu's."""
    def body(pkg):
        nd = pkg.nd
        store = pkg.kv.create("local")
        store.init("k", nd.array(D))
        c = nd.sparse.zeros("csr", (4, 4))
        r = nd.sparse.zeros("row_sparse", (4, 4))
        store.pull("k", out=c)
        store.pull("k", out=r)
        return [c, r]

    _both(mt, body)


def test_sparse_ops_never_copy_components_to_the_host(mt, monkeypatch):
    """The ops above run with ``torch.Tensor.numpy`` refused, so none
    takes a component through the host (on the card they stay there),
    and give mxtpu's arrays."""
    import contextlib

    import torch

    def no_host(self, *a, **k):
        raise AssertionError("a sparse op copied a tensor to the host")

    @contextlib.contextmanager
    def refuse():
        with monkeypatch.context() as m:
            m.setattr(torch.Tensor, "numpy", no_host)
            yield

    with mx.cpu():
        want = sparse_device_ops(mx, contextlib.nullcontext)
    with mt.cpu():
        got = sparse_device_ops(mt, refuse)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(_parts(g), _parts(w), 1e-6)


def test_sparse_test_utils_match_mxtpu(mt):
    def body(pkg):
        tu = pkg.test_utils
        tu._rng = np.random.RandomState(11)
        np.random.seed(4)
        a, dense = tu.rand_sparse_ndarray((5, 6), "csr", density=0.4)
        return [a, tu.rand_ndarray((4, 3), "row_sparse", density=0.5),
                tu.rand_ndarray((2, 3)),
                tu.create_sparse_array((3, 4), "csr"),
                tu.create_sparse_array((3, 4), "row_sparse", data_init=2.0),
                tu.create_sparse_array_zd((6, 5), "csr", density=0.2),
                tu.create_sparse_array_zd((3, 5), "row_sparse", density=0.0),
                [dense, tu.shuffle_csr_column_indices(a)]]

    with mx.cpu():
        want = body(mx)
    with mt.cpu():
        got = body(mt)
    for g, w in zip(got[:-1], want[:-1]):
        _same(_parts(g), _parts(w), 1e-7)
    _same(got[-1], want[-1])


def test_sparse_example_flow_matches_mxtpu(mt, tmp_path):
    """2 epochs of examples/sparse/linear_classification.py's flow at
    its defaults (1,024 rows, 256 features, B=64, lr 0.5): the same train
    accuracy each epoch through both packages."""
    from mxtpu_torch.models import sparse_linear
    path = str(tmp_path / "train.libsvm")
    sparse_linear.synth_libsvm(path, 1024, 256, np.random.RandomState(7))
    with mt.cpu():
        got = sparse_linear.train(path, epochs=2)
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                    "examples", "sparse"))
    try:
        import linear_classification as example
    finally:
        sys.path.pop(0)
    want = example.main(["--epochs", "2"])
    assert got == want and want[1] > want[0]


@pytest.mark.parametrize("transpose", [False, True])
def test_chip_smoke_dot_bound_counts_each_tensor_once(mt, transpose):
    """``chip_smoke.sparse_dot_bytes`` on a small CSR array: its
    components, the weight rows its column ids touch (or the dense rows
    of the transposed product) and the result, each once."""
    import chip_smoke
    with mt.cpu():
        c = mt.nd.sparse.csr_matrix(D)
        parts = sum(x.asnumpy().nbytes for x in (c.data, c.indices,
                                                  c.indptr))
        uniq = len(np.unique(c.indices.asnumpy()))
        if transpose:
            r = mt.nd.dot(c, mt.nd.array(np.ones((4, 1), np.float32)),
                          transpose_a=True)
            want = parts + 4 * 4 + r.data.asnumpy().nbytes + \
                r.indices.asnumpy().nbytes
        else:
            out = mt.nd.dot(c, mt.nd.array(np.ones((4, 1), np.float32)))
            want = parts + 4 * uniq + out.asnumpy().nbytes
    assert chip_smoke.sparse_dot_bytes(c.nnz, 4, uniq, transpose) == want
