"""The 18 names of ``mxtpu/ops/linalg.py`` (9 ops, each with its
``linalg_*`` alias) in the port against mxtpu's, batched: the same numpy
inputs through mxtpu's op (JAX on the CPU) and the port's (PyTorch on
the CPU), forward within 1e-5 and the gradient, ``torch.autograd.grad``
against ``jax.vjp``, within 1e-4, both of the largest magnitude (at
least 1). The cases (``final_op_cases.LINALG_CASES``) hold a non-symmetric
A for potrf (mxtpu factors (A + Aᵀ) / 2), one that is not positive
definite (NaN over the lower triangle, no raise), junk above the
diagonal for potri and trsm (they read the lower triangle), a full A for
trmm (it multiplies by all of it), and a wide A for gelqf. Then the
``nd.linalg`` and ``sym.linalg`` namespaces.

torch is imported lazily and pinned to one thread: several test workers
share the host."""
import numpy as np
import pytest

import mxtpu
from final_op_cases import LINALG_CASES
from final_op_parity import check_forward, check_gradient

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
IDS = ["%s-%d" % (c[0], i) for i, c in enumerate(LINALG_CASES)]


@pytest.fixture(scope="module")
def tt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return torch, mxtpu_torch


@pytest.mark.parametrize("name,arrays,attrs,diff,outs", LINALG_CASES,
                         ids=IDS)
def test_linalg_op_matches_mxtpu(tt, name, arrays, attrs, diff, outs):
    torch, mt = tt
    check_forward(torch, mt, name, arrays, attrs, FWD_TOL)
    if diff:
        check_gradient(torch, mt, name, arrays, attrs, diff, outs, GRAD_TOL)


def test_the_departures_from_lapack_pinned(tt):
    """potrf symmetrizes and never raises; trmm takes the whole A; potri
    and trsm read the lower triangle alone."""
    torch, mt = tt
    reg = mt.ops.registry
    _, _, (L,) = reg.invoke("_linalg_potrf",
                            [torch.tensor([[4.0, 1.0], [3.0, 5.0]])], {})
    assert L.tolist() == [[2.0, 0.0], [1.0, 2.0]]
    _, _, (L,) = reg.invoke("_linalg_potrf",
                            [torch.tensor([[1.0, 2.0], [2.0, 1.0]])], {})
    nan = torch.isnan(L)
    assert nan[0, 0] and L[0, 1] == 0 and nan[1].all()
    full = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    eye = torch.eye(2)
    _, _, (p,) = reg.invoke("_linalg_trmm", [full, eye], {})
    assert torch.equal(p, full)
    _, _, (x,) = reg.invoke("_linalg_trsm", [full, eye], {})
    _, _, (y,) = reg.invoke("_linalg_trsm", [full.tril(), eye], {})
    _, _, (u,) = reg.invoke("_linalg_potri", [full], {})
    _, _, (v,) = reg.invoke("_linalg_potri", [full.tril(), eye][:1], {})
    assert torch.equal(x, y) and torch.equal(u, v)


def test_linalg_namespaces_match_mxtpu(tt):
    """``nd.linalg.<op>`` and ``sym.linalg.<op>`` (the ``_linalg_``
    prefix namespaces) against mxtpu's."""
    torch, mt = tt
    a = np.array([[[2.0, 0.5], [0.5, 3.0]]], np.float32)
    b = np.array([[[1.0, 2.0], [3.0, 4.0]]], np.float32)

    def body(pkg):
        nd_out = [pkg.nd.linalg.gemm2(pkg.nd.array(a), pkg.nd.array(b),
                                      alpha=2.0),
                  pkg.nd.linalg.potrf(pkg.nd.array(a)),
                  pkg.nd.linalg.sumlogdiag(pkg.nd.array(a))]
        x = pkg.sym.Variable("x")
        s = pkg.sym.Group([pkg.sym.linalg.syrk(x, transpose=True),
                           pkg.sym.linalg.trmm(x, x, alpha=0.5)])
        ex = s.bind(pkg.cpu(), {"x": pkg.nd.array(b, ctx=pkg.cpu())})
        return [o.asnumpy() for o in nd_out + list(ex.forward())]

    with mt.cpu():
        got = body(mt)
    want = body(mxtpu)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,arrays,attrs,diff,outs", LINALG_CASES, ids=IDS)
def test_shape_inference_matches_the_op(tt, name, arrays, attrs, diff, outs):
    """Shape inference (the op on meta tensors, as a Symbol's
    infer_shape runs it) gives each output's shape and type."""
    torch, mt = tt
    op = mt.ops.registry.get_op(name)
    a = op.parse_attrs(dict(attrs))
    inferred = op.infer(a, [(x.shape, x.dtype.name) for x in arrays])
    real = op.apply(a, [torch.from_numpy(x.copy()) for x in arrays])
    assert inferred == [(tuple(r.shape), r.dtype) for r in real]
