"""Linear-algebra operators: the ``_linalg_*`` family.

Counterpart of ``mxtpu/ops/linalg.py`` (the 9 ops :16-67, each with its
``linalg_*`` alias). mxtpu leaves them to XLA's linear algebra; here they
are ``torch.matmul`` and ``torch.linalg`` (cuBLAS and cuSOLVER on the
card, LAPACK on the CPU), and autograd gives the gradients. Where mxtpu
departs from LAPACK's contract the port follows mxtpu:

- ``potrf`` is ``jnp.linalg.cholesky``, which factors the symmetrized
  input (A + Aᵀ) / 2 and does not raise on a matrix that is not positive
  definite: it gives NaN over the lower triangle and 0 above it, and a
  NaN gradient. The symmetrization is written out (so autograd sees it)
  and ``cholesky_ex``'s ``info`` picks the matrices to fill with NaN.
- ``potri`` and ``trsm`` read only the lower triangle of A
  (``lax.linalg.triangular_solve(lower=True)``); ``trmm`` multiplies by
  the whole A, with no ``tril``.
- ``gelqf`` is the reduced QR of Aᵀ, transposed back: (Q, L) with
  L = Rᵀ, R's diagonal signed as the factorization gives it.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = []


def _t(x, flag):
    return x.transpose(-1, -2) if flag else x


def _gemm(a, A, B, C):
    return a.alpha * torch.matmul(_t(A, a.transpose_a),
                                  _t(B, a.transpose_b)) + a.beta * C


def _gemm2(a, A, B):
    return a.alpha * torch.matmul(_t(A, a.transpose_a), _t(B, a.transpose_b))


def _potrf(a, A):
    """Cholesky factor of (A + Aᵀ) / 2; NaN on and below the diagonal, 0
    above, where that matrix is not positive definite. The NaN is a
    product with the factor, so autograd carries it back: such a
    matrix's gradient is NaN, as ``jax.vjp`` of mxtpu's gives, and the
    other matrices of a batch keep theirs."""
    sym = (A + A.transpose(-1, -2)) / 2
    if A.device.type == "meta":
        return torch.empty_like(A)
    L, info = torch.linalg.cholesky_ex(sym)
    bad = (info != 0)[..., None, None]
    lower = torch.ones(A.shape[-2:], dtype=torch.bool,
                       device=A.device).tril()
    poison = torch.where(bad & lower, float("nan"), 1.0).to(L.dtype)
    return torch.where(bad & ~lower, torch.zeros_like(L), L * poison)


def _lower_solve(A, B, left, transpose):
    """X with op(tril(A)) X = B (``left``) or X op(tril(A)) = B, op the
    transpose where ``transpose``: ``lax.linalg.triangular_solve`` with
    ``lower=True``."""
    L = A.tril()
    if transpose:
        return torch.linalg.solve_triangular(L.transpose(-1, -2), B,
                                             upper=True, left=left)
    return torch.linalg.solve_triangular(L, B, upper=False, left=left)


def _potri(a, A):
    """(L⁻¹)ᵀ L⁻¹ for L the lower triangle of A: the inverse of L Lᵀ."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype,
                    device=A.device).expand(A.shape)
    if A.device.type == "meta":
        return torch.empty_like(A)
    Linv = _lower_solve(A, eye, True, False)
    return torch.matmul(Linv.transpose(-1, -2), Linv)


def _trmm(a, A, B):
    """alpha op(A) B, or alpha B op(A) with ``rightside``: the whole A."""
    opA = _t(A, a.transpose)
    return a.alpha * (torch.matmul(B, opA) if a.rightside
                      else torch.matmul(opA, B))


def _trsm(a, A, B):
    if A.device.type == "meta":
        return torch.empty_like(B)
    return a.alpha * _lower_solve(A, B, not a.rightside, bool(a.transpose))


def _sumlogdiag(a, A):
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(-1)


def _syrk(a, A):
    At = A.transpose(-1, -2)
    return a.alpha * (torch.matmul(At, A) if a.transpose
                      else torch.matmul(A, At))


def _gelqf(a, A):
    """(Q, L) with A = L Q, Q's rows orthonormal: the reduced QR of Aᵀ."""
    if A.device.type == "meta":
        m = A.shape[-2]
        return (torch.empty_like(A),
                torch.empty(A.shape[:-1] + (m,), dtype=A.dtype,
                            device="meta"))
    q, r = torch.linalg.qr(A.transpose(-1, -2), mode="reduced")
    return q.transpose(-1, -2), r.transpose(-1, -2)


_GEMM_ATTRS = {"transpose_a": False, "transpose_b": False, "alpha": 1.0}
_SIDE_ATTRS = {"transpose": False, "rightside": False, "alpha": 1.0}

register("_linalg_gemm", _gemm, arg_names=["A", "B", "C"],
         attrs=dict(_GEMM_ATTRS, beta=1.0), aliases=("linalg_gemm",))
register("_linalg_gemm2", _gemm2, arg_names=["A", "B"],
         attrs=dict(_GEMM_ATTRS), aliases=("linalg_gemm2",))
register("_linalg_potrf", _potrf, arg_names=["A"], attrs={},
         aliases=("linalg_potrf",))
register("_linalg_potri", _potri, arg_names=["A"], attrs={},
         aliases=("linalg_potri",))
register("_linalg_trmm", _trmm, arg_names=["A", "B"],
         attrs=dict(_SIDE_ATTRS), aliases=("linalg_trmm",))
register("_linalg_trsm", _trsm, arg_names=["A", "B"],
         attrs=dict(_SIDE_ATTRS), aliases=("linalg_trsm",))
register("_linalg_sumlogdiag", _sumlogdiag, arg_names=["A"], attrs={},
         aliases=("linalg_sumlogdiag",))
register("_linalg_syrk", _syrk, arg_names=["A"],
         attrs={"transpose": False, "alpha": 1.0}, aliases=("linalg_syrk",))
register("_linalg_gelqf", _gelqf, arg_names=["A"], attrs={}, num_outputs=2,
         aliases=("linalg_gelqf",))
