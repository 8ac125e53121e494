"""Sparse linear classification: MXNet's example/sparse showcase for csr
data, a row_sparse weight and the kvstore's ``row_sparse_pull``.

The port's copy of ``examples/sparse/linear_classification.py``
(``synth_libsvm`` and the training loop of its ``main``, as ``train``),
which imports ``mxtpu`` and cannot be imported by the port: LibSVMIter
streams csr batches; the rows a batch touches are pulled from a
``local`` kvstore holding a row_sparse weight; the logistic loss's
gradient on those rows is pushed back as a row_sparse array and the
store's SGD applies it. As in the example, the csr batch is densified at
the device boundary and the arrays live on the default context (the
card's, unless a ``with cpu():`` scope names another).
"""
from __future__ import annotations

import numpy as np

from .. import io
from .. import kvstore as kv
from .. import ndarray as nd
from .. import optimizer

__all__ = ["synth_libsvm", "train"]


def synth_libsvm(path, n, dim, rng, nnz=6):
    """Sparse separable two-class data in libsvm format."""
    w_true = rng.randn(dim)
    with open(path, "w") as f:
        for _ in range(n):
            idx = np.sort(rng.choice(dim, size=nnz, replace=False))
            val = rng.randn(nnz)
            y = 1 if float(np.dot(w_true[idx], val)) > 0 else 0
            feats = " ".join("%d:%.4f" % (i, v) for i, v in zip(idx, val))
            f.write("%d %s\n" % (y, feats))


def train(path, epochs=5, dim=256, batch_size=64, lr=0.5):
    """The example's loop over the libsvm file at ``path``; returns the
    train accuracy of each epoch."""
    it = io.LibSVMIter(data_libsvm=path, data_shape=(dim,),
                       batch_size=batch_size)
    store = kv.create("local")
    weight = nd.sparse.zeros("row_sparse", (dim, 1))
    store.init("w", weight)
    store.set_optimizer(optimizer.SGD(learning_rate=lr, rescale_grad=1.0))
    bias = nd.zeros((1,))
    accs = []
    for _ in range(epochs):
        it.reset()
        correct = total = 0
        for batch in it:
            x = batch.data[0]          # csr
            y = batch.label[0]
            row_ids = nd.array(np.nonzero(
                x.asnumpy().sum(axis=0) != 0)[0].astype("float32"))
            w_rows = nd.sparse.zeros("row_sparse", (dim, 1))
            store.row_sparse_pull("w", out=w_rows, row_ids=row_ids)
            xd = nd.array(x.asnumpy())          # densify at the boundary
            wd = nd.array(w_rows.asnumpy())
            score = nd.dot(xd, wd) + bias
            prob = 1.0 / (1.0 + nd.exp(-score))
            err = prob - y.reshape((-1, 1)).as_in_context(prob.context)
            gw = nd.dot(xd.T, err) / batch_size
            gb = err.mean()
            grad_rs = nd.array(gw.asnumpy()).tostype("row_sparse")
            store.push("w", grad_rs)
            pred = (prob.asnumpy() > 0.5).astype(int).ravel()
            correct += int((pred == y.asnumpy().astype(int)).sum())
            total += len(pred)
            bias -= lr * gb.asnumpy()
        accs.append(correct / max(total, 1))
    return accs
