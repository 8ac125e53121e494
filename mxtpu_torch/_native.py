"""ctypes bridge to the native host runtime built from ``src/core``.

Counterpart of ``mxtpu/_native.py``: the record reader and writer
(``src/core/recordio.cc``), the bounded prefetch thread
(``src/core/threaded_iter.h``, dmlc's ThreadedIter) and the dependency
engine (``src/core/engine.cc``, driven by ``engine.ThreadedEngine``),
behind the C ABI of
``src/core/c_api.cc``. The port compiles ``storage.cc``, ``recordio.cc``,
``engine.cc`` and ``c_api.cc`` itself with the ``g++`` on ``PATH`` into
``build/mxtpu_torch/`` on first use (never at import), into a file named
by a digest of the sources, headers, flags and the compiler (its path
and ``--version``), as ``build.py`` names the kernels' libraries; another
toolchain gets a library of its own. It never runs ``src/Makefile``
and never writes into ``mxtpu/native/``. There is no pure-Python
fallback and no switch to disable the library or pick the compiler: a
failed build raises ``MXNetError`` with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from .base import MXNetError
from .build import BUILD_DIR

__all__ = ["SRC_DIR", "SOURCES", "CXX_FLAGS", "PRODUCE_FN", "ASYNC_FN",
           "library_path",
           "build", "get_lib", "check_call"]

SRC_DIR = Path(__file__).resolve().parent.parent / "src" / "core"
SOURCES = ("storage.cc", "recordio.cc", "engine.cc", "c_api.cc")
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-shared", "-pthread")

#: the prefetch thread's producer: int fn(void* ctx, void** out_item)
PRODUCE_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                              ctypes.POINTER(ctypes.c_void_p))
#: the dependency engine's op callback: void fn(void* ctx)
ASYNC_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p)

_lock = threading.Lock()
_lib = None


def _gxx():
    """(path, ``--version`` banner) of the ``g++`` on ``PATH``."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise MXNetError("g++ not found: it builds the native runtime from "
                         "%s" % SRC_DIR)
    banner = subprocess.run([gxx, "--version"], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True).stdout
    return gxx, banner


def library_path():
    """Where the library of the current sources, flags and g++ lives."""
    h = hashlib.sha1()
    for p in sorted(SRC_DIR.glob("*.h")) + [SRC_DIR / s for s in SOURCES]:
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update("\0".join(_gxx()).encode())
    return BUILD_DIR / ("libmxtpu_core-%s.so" % h.hexdigest()[:12])


def build():
    """Compile the library unless it is built already; returns its path.
    Raises MXNetError with the compiler's output when g++ fails or is
    missing."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(".%d.tmp" % os.getpid())
    proc = subprocess.run(
        [_gxx()[0], *CXX_FLAGS, *[str(SRC_DIR / s) for s in SOURCES], "-o",
         str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    if proc.returncode != 0:
        raise MXNetError("g++ failed to build the native runtime (rc %d):\n%s"
                         % (proc.returncode, proc.stdout))
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or none
    return out


def _declare(lib):
    lib.MXTPUGetLastError.restype = ctypes.c_char_p
    u64p = ctypes.POINTER(ctypes.c_uint64)
    vpp = ctypes.POINTER(ctypes.c_void_p)
    sigs = {
        "MXTPURecordWriterCreate": [ctypes.c_char_p, vpp],
        "MXTPURecordWriterWrite": [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_uint64],
        "MXTPURecordWriterTell": [ctypes.c_void_p, u64p],
        "MXTPURecordWriterFree": [ctypes.c_void_p],
        "MXTPURecordReaderCreate": [ctypes.c_char_p, vpp],
        "MXTPURecordReaderNext": [ctypes.c_void_p, vpp, u64p],
        "MXTPURecordReaderSeek": [ctypes.c_void_p, ctypes.c_uint64],
        "MXTPURecordReaderTell": [ctypes.c_void_p, u64p],
        "MXTPURecordReaderFree": [ctypes.c_void_p],
        "MXTPUEngineNewVar": [vpp],
        "MXTPUEngineDeleteVar": [ctypes.c_void_p],
        "MXTPUEnginePushAsync": [ASYNC_FN, ctypes.c_void_p, vpp,
                                 ctypes.c_int, vpp, ctypes.c_int,
                                 ctypes.c_int],
        "MXTPUEngineWaitForVar": [ctypes.c_void_p],
        "MXTPUEngineWaitForAll": [],
        "MXTPUEngineNumWorkers": [ctypes.POINTER(ctypes.c_int)],
        "MXTPUEngineOpsCompleted": [u64p],
        "MXTPUThreadedIterCreate": [PRODUCE_FN, ctypes.c_void_p,
                                    ctypes.c_int, vpp],
        "MXTPUThreadedIterNext": [ctypes.c_void_p, vpp],
        "MXTPUThreadedIterFree": [ctypes.c_void_p],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int


def get_lib():
    """The loaded library, built on first use. ctypes' CDLL releases the
    GIL for the length of every call, so a native thread blocked on a
    Python callback can always finish it."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib


def check_call(ret):
    """Raise MXNetError with the native message on a nonzero return."""
    if ret != 0:
        raise MXNetError(get_lib().MXTPUGetLastError().decode("utf-8"))
