"""The part of mxtpu's test harness that the example scripts use.

Counterpart of ``mxtpu/test_utils.py:19-90``: ``default_context``,
``set_default_context``, ``default_dtype``, ``same``, ``almost_equal``
and ``assert_almost_equal`` (with ``find_max_violation``). The default
context is the port's, ``gpu(0)`` unless a ``with ctx:`` scope or
``set_default_context`` names another: it raises on a host without
CUDA, as every entry point of the port does.
"""
from __future__ import annotations

import numpy as _np

from . import context as ctx_mod
from . import ndarray as nd

__all__ = ["default_context", "set_default_context", "default_dtype",
           "same", "find_max_violation", "assert_almost_equal",
           "almost_equal"]


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
