"""The inputs of the last op cases: the 18 names of ``mxtpu/ops/linalg.py``
and the quantize, dequantize, fft, ifft and count_sketch names of
``mxtpu/ops/contrib.py``. Each case is ``(op, inputs, attrs, indices of
the inputs to differentiate, indices of the outputs to differentiate)``
in numpy alone, so that ``test_torch_linalg.py`` and
``test_torch_contrib_rest.py`` hold them against mxtpu on the CPU and
``test_torch_cuda.py`` and ``chip_smoke.py`` run them on the card against
the CPU (where neither JAX nor mxtpu is). The CTC cases are
``CTC_CASES``: ``(name, T, N, C, labels, attrs, data_lengths,
label_lengths, NaN at (t, n, c) or None)``. ``sparse_device_ops`` runs
the sparse ops that must stay on the arrays' device through a package;
``SPARSE_FAULTS`` the sparse bodies that once went wrong."""
import numpy as np


def _r(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _spd(batch, n, seed):
    """Symmetric positive definite (batch, n, n), well conditioned."""
    a = _r((batch, n, n), seed)
    return (a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)
            ).astype(np.float32)


def _lower(batch, n, seed):
    """Lower triangle with a safe diagonal, and junk above it: the ops
    that read only the lower triangle must not see it."""
    a = _r((batch, n, n), seed)
    a += np.eye(n, dtype=np.float32) * (2.0 + n)
    return a.astype(np.float32)


_A = _r((2, 3, 4), 1)
_B = _r((2, 4, 5), 2)
_C = _r((2, 3, 5), 3)
_SQ = _r((2, 4, 4), 4)
_RHS = _r((2, 4, 3), 5)
_RHS_R = _r((2, 3, 4), 6)
_NONSYM = np.array([[4.0, 1.0], [3.0, 5.0]], np.float32)
_NOT_PD = np.array([[[1.0, 2.0], [2.0, 1.0]], [[4.0, 1.0], [1.0, 3.0]]],
                   np.float32)

LINALG_CASES = [
    ("_linalg_gemm", [_A, _B, _C], {"alpha": 0.5, "beta": 2.0}, [0, 1, 2],
     [0]),
    ("linalg_gemm", [_A.transpose(0, 2, 1).copy(), _B.transpose(0, 2, 1)
                     .copy(), _C], {"transpose_a": True, "transpose_b": True},
     [0, 1, 2], [0]),
    ("_linalg_gemm2", [_A, _B], {"alpha": -1.5}, [0, 1], [0]),
    ("linalg_gemm2", [_A, _C], {"transpose_a": True}, [0, 1], [0]),
    ("_linalg_potrf", [_spd(2, 4, 7)], {}, [0], [0]),
    ("_linalg_potrf", [_NONSYM], {}, [0], [0]),       # (A + Aᵀ) / 2
    ("linalg_potrf", [_NOT_PD], {}, [0], [0]),  # NaN and its gradient
    ("_linalg_potri", [_lower(2, 4, 8)], {}, [0], [0]),
    ("_linalg_trmm", [_SQ, _RHS], {"alpha": 2.0}, [0, 1], [0]),  # whole A
    ("linalg_trmm", [_SQ, _RHS_R], {"rightside": True, "transpose": True},
     [0, 1], [0]),
    ("_linalg_trsm", [_lower(2, 4, 9), _RHS], {"alpha": 0.5}, [0, 1], [0]),
    ("linalg_trsm", [_lower(2, 4, 10), _RHS], {"transpose": True}, [0, 1],
     [0]),
    ("_linalg_trsm", [_lower(2, 4, 11), _RHS_R], {"rightside": True},
     [0, 1], [0]),
    ("linalg_trsm", [_lower(2, 4, 12), _RHS_R],
     {"rightside": True, "transpose": True, "alpha": -2.0}, [0, 1], [0]),
    ("_linalg_sumlogdiag", [_spd(3, 4, 13)], {}, [0], [0]),
    ("_linalg_syrk", [_A], {"alpha": 1.5}, [0], [0]),
    ("linalg_syrk", [_A], {"transpose": True}, [0], [0]),
    ("_linalg_gelqf", [_r((2, 3, 5), 14)], {}, [0], [0, 1]),   # wide A
    ("linalg_gelqf", [_r((4, 4), 15)], {}, [0], [0, 1]),
]

_Q = np.array([[-1.0, -0.5, 0.0, 0.5, 1.0, 1.5, 2.0, 10.0]], np.float32)
_MN, _MX = np.array([-1.0], np.float32), np.array([1.0], np.float32)
# (data - mn) * 255 / 2 at 0.5 / 255 steps: exact halves round to even
_TIES = ((np.arange(8, dtype=np.float32) + 0.5) * (2.0 / 255.0) - 1.0
         ).reshape(1, 8).astype(np.float32)

CONTRIB_CASES = [
    ("_contrib_quantize", [_Q, _MN, _MX], {}, [1, 2], [1, 2]),
    ("_contrib_quantize", [_TIES, _MN, _MX], {}, [], []),
    ("_contrib_quantize", [_Q, _MN, _MN.copy()], {}, [], []),  # mn == mx
    ("_contrib_dequantize", [np.arange(0, 256, 37, dtype=np.uint8)
                             .reshape(1, -1), _MN, _MX], {}, [1, 2], [0]),
    ("_contrib_dequantize", [np.array([[0, 1, 255]], np.uint8), _MN,
                             _MN.copy()], {}, [1, 2], [0]),   # mn == mx
    ("_contrib_fft", [_r((3, 8), 16)], {}, [0], [0]),
    ("_contrib_fft", [_r((2, 2, 5), 17)], {"compute_size": 64}, [0], [0]),
    ("_contrib_ifft", [_r((3, 16), 18)], {}, [0], [0]),
    ("_contrib_count_sketch", [_r((3, 4), 19), np.array(
        [[-1.0, 5.0, 2.7, -5.0]], np.float32), np.array(
        [[1.0, -1.0, 1.0, -1.0]], np.float32)], {"out_dim": 4}, [0, 2],
     [0]),
    ("_contrib_count_sketch", [_r((2, 6), 20), np.array(
        [[1.0, 1.0, 0.0, 2.0, 1.0, 3.0]], np.float32), np.array(
        [[1.0, -1.0, 1.0, 1.0, -1.0, 1.0]], np.float32)], {"out_dim": 4},
     [0, 2], [0]),   # duplicate indices add
    ("_contrib_count_sketch", [_r((2, 5), 22), np.array(
        [[np.nan, 3e9, -3e9, 2.0, 1.0]], np.float32), np.array(
        [[1.0, -1.0, 1.0, -1.0, 1.0]], np.float32)], {"out_dim": 4},
     [0, 2], [0]),   # h as XLA converts it: NaN -> 0, saturated
]

_OCR_LABELS = np.random.RandomState(21).randint(0, 11, (4, 5))
CTC_CASES = [
    ("plain", 6, 3, 5, [[1, 2, 0], [3, 3, 0], [4, 1, 2]], {}, None, None,
     None),
    ("infeasible_repeat", 2, 1, 4, [[1, 1]], {}, None, None, None),
    ("infeasible_short", 1, 1, 4, [[1, 2]], {}, None, None, None),
    ("data_lengths", 6, 3, 5, [[1, 2, 0], [3, 3, 0], [4, 1, 2]],
     {"use_data_lengths": True}, [4, 6, 2], None, None),
    ("label_lengths", 6, 3, 5, [[1, 2, 0], [3, 3, 0], [4, 1, 2]],
     {"use_label_lengths": True}, None, [1, 3, 0], None),
    ("both_lengths", 7, 3, 5, [[0, 2, 1], [3, 3, 4], [4, 1, 2]],
     {"use_data_lengths": True, "use_label_lengths": True}, [7, 3, 0],
     [3, 2, 3], None),
    ("blank_last", 6, 3, 5, [[1, -1, 2], [3, 3, -1], [0, 1, 9]],
     {"blank_label": "last"}, None, None, None),
    ("interleaved_and_out_of_range", 6, 3, 5, [[0, 2, 1], [3, 0, 3],
                                               [7, 1, 2]], {}, None, None,
     None),
    ("nan_logits", 6, 3, 5, [[1, 2, 0], [3, 3, 0], [4, 1, 2]], {}, None,
     None, (1, 0, 2)),
    ("ocr", 32, 4, 11, _OCR_LABELS.tolist(), {}, None, None, None),
    # labels and lengths as XLA converts them: NaN -> 0, saturated
    ("label_3e9_blank_first", 6, 2, 5, [[1, 3e9, 2], [3, 1, 0]], {}, None,
     None, None),
    ("label_3e9_blank_last", 6, 2, 5, [[1, 3e9, 2], [3, 1, -1]],
     {"blank_label": "last"}, None, None, None),
    ("label_nan_blank_last", 6, 2, 5, [[1, np.nan, 2], [3, 1, -1]],
     {"blank_label": "last"}, None, None, None),
    ("lengths_nan_and_3e9", 6, 2, 5, [[1, 2, 3], [3, 1, 2]],
     {"use_data_lengths": True, "use_label_lengths": True}, [np.nan, 3e9],
     [3e9, np.nan], None),
]


def ctc_inputs(T, N, C, labels, data_lengths, label_lengths, nan, seed=0):
    """(data (T, N, C), label (N, L), the lengths given, head (N,)) as
    float32 numpy arrays."""
    rng = np.random.RandomState(seed)
    x = rng.randn(T, N, C).astype(np.float32)
    if nan is not None:
        x[nan] = np.nan
    lab = np.asarray(labels, np.float32)
    extra = [np.asarray(v, np.float32) for v in (data_lengths, label_lengths)
             if v is not None]
    head = (rng.rand(N) + 0.5).astype(np.float32)
    return x, lab, extra, head


_SP = np.array([[0.0, 1.5, 0.0, 0.0], [2.0, 0.0, 0.0, -3.0],
                [0.0, 0.0, 0.0, 0.0], [0.0, 4.0, 5.0, 0.0]], np.float32)


def _write_all(pkg):
    c = pkg.nd.sparse.csr_matrix(_SP)
    c.asnumpy()  # the dense view exists before the write
    c[:] = pkg.nd.array(2 * _SP)
    return [c]


def _add_in_place(pkg):
    r = pkg.nd.sparse.row_sparse_array(_SP)
    r += 1
    return [r]


def _update_out(pkg):
    w = pkg.nd.sparse.row_sparse_array(_SP)
    pkg.nd.sgd_update(w, pkg.nd.array(np.ones((4, 4), np.float32)), lr=0.1,
                      out=w)
    return [w]


def _updater_step(pkg):
    w = pkg.nd.sparse.row_sparse_array(_SP)
    update = pkg.optimizer.get_updater(pkg.optimizer.SGD(learning_rate=0.1))
    update(0, pkg.nd.array(np.ones((4, 4), np.float32)), w)
    return [w]


def _write_an_index(pkg):
    c = pkg.nd.sparse.csr_matrix(_SP)
    row = c[1]
    row[:] = 7  # a copy: the array keeps its values
    return [c, row]


def _dot_vector(transpose_a):
    def body(pkg):
        v = pkg.nd.array(np.array([1.0, -2.0, 0.5, 3.0], np.float32))
        return [pkg.nd.sparse.dot(pkg.nd.sparse.csr_matrix(_SP), v,
                                  transpose_a=transpose_a)]
    return body


def _add_two_types(pkg):
    sp = pkg.nd.sparse
    i32 = sp.csr_matrix(_SP.astype(np.int32))
    return [sp.add(sp.csr_matrix(_SP), i32), sp.add(i32, i32)]


#: Bodies once wrong in the port, (name, body(pkg) -> arrays): in-place
#: writes to sparse arrays (C.15: ``x[:] = v``, ``+=``, an op's
#: ``out=``, an ``Updater`` step, a write to an index's copy), dots of
#: a CSR array and a vector (C.16) and csr + csr of two types (C.19: the
#: dtype numpy promotes the data to, float64 over float32 values).
SPARSE_FAULTS = [("write_all", _write_all), ("add_in_place", _add_in_place),
                 ("update_out", _update_out), ("updater_step", _updater_step),
                 ("write_an_index", _write_an_index),
                 ("dot_vector", _dot_vector(False)),
                 ("dot_vector_transpose_a", _dot_vector(True)),
                 ("add_two_types", _add_two_types)]


def sparse_device_ops(pkg, refuse):
    """add, sparse_retain, copy, a row slice, the rebuild after a dense
    write and row_sparse_pull; the ops themselves inside ``refuse()``."""
    D = np.array([[0.0, 1.5, 0.0, 0.0], [2.0, 0.0, 0.0, -3.0],
                  [0.0, 0.0, 0.0, 0.0], [0.0, 4.0, 5.0, 0.0]], np.float32)
    nd = pkg.nd
    c = nd.sparse.csr_matrix(D)
    c2 = nd.sparse.csr_matrix(D.T.copy() * 0.5)
    r = nd.sparse.row_sparse_array(D)
    r2 = nd.sparse.row_sparse_array(
        ([[1.0, 1.0, 1.0, 1.0], [2.0, 0.0, 0.0, 2.0]], [0, 1]),
        shape=(4, 4))
    store = pkg.kv.create("local")
    store.init("k", nd.array(D))
    pulled = nd.sparse.zeros("csr", (4, 4))
    pulled_rsp = nd.sparse.zeros("row_sparse", (4, 4))
    rows = nd.sparse.zeros("row_sparse", (4, 4))
    ids = nd.array(np.array([3.0, 1.0, 3.0]))
    with refuse():
        store.pull("k", out=pulled)
        store.pull("k", out=pulled_rsp)
        store.row_sparse_pull("k", out=rows, row_ids=ids)
        out = [nd.sparse.add(r, r2), nd.sparse.add(c, c2),
               nd.sparse.add(c, nd.sparse.zeros("csr", (4, 4))),
               nd.sparse_retain(r, ids), r.retain(nd.array(np.array([2.0]))),
               c.copy(), r.copy(), c[1:3], pulled.copy(),
               pulled_rsp.copy()]
    return out + [rows]
