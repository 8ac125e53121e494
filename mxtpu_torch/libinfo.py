"""Library locator and version (parity: python/mxnet/libinfo.py —
``find_lib_path()`` for the native runtime and the package
``__version__``).

The port's native runtime is ``_native``'s g++ build of ``src/core``
(the record reader and writer, the prefetch thread); ``find_lib_path``
builds it on first use, as ``_native.get_lib`` does, and returns its
path.
"""
from __future__ import annotations

__all__ = ["find_lib_path", "__version__"]

__version__ = "0.1.0"


def find_lib_path():
    """``[path]`` of the native runtime library, built from the sources
    in the checkout if it is not built yet; raises ``MXNetError`` when it
    cannot be built (no g++, a compile error)."""
    from . import _native
    _native.get_lib()
    return [str(_native.library_path())]
