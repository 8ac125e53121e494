"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file has a plain ``extern "C"`` launcher; it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/mxtpu_torch/`` at the root of the checkout, on first use, and
loaded with ``ctypes``. A library's file name carries a digest of its
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header builds anew and an unchanged one is reused. Nothing here
runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from .base import MXNetError

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "sources", "spawn", "build",
           "load", "build_log"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "mxtpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}
#: name -> {"seconds": build wall time (None when reused), "ptxas": text}
build_log = {}


def sources():
    """Names (file stems) of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise MXNetError("nvcc not found: the CUDA toolkit is needed to build "
                     "the kernels in %s" % CSRC_DIR)


def _target(name):
    """(source, library path) of kernel ``name``. The digest covers the
    source, every header of ``csrc/`` (a source may include any of them)
    and the flags."""
    src = CSRC_DIR / ("%s.cu" % name)
    if not src.exists():
        raise MXNetError("no kernel source %s" % src)
    h = hashlib.sha1(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / ("lib%s-%s.so" % (name, h.hexdigest()[:12]))


def spawn(src, out):
    """The ``nvcc`` process (started, not waited for; output and ptxas's
    figures on its stdout as text) that compiles ``src`` into the library
    ``out`` with NVCC_FLAGS."""
    return subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def build(names=None):
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` per source, all started together. Returns
    ``{name: seconds}`` for the ones compiled. Raises MXNetError with the
    compiler's output when one fails."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, out = _target(name)
        if out.exists():
            build_log.setdefault(name, {"seconds": None, "ptxas": ""})
            continue
        tmp = out.with_suffix(".%d.tmp" % os.getpid())
        procs[name] = (spawn(src, tmp), tmp, out, time.perf_counter())
    done = {}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        text, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append("%s (rc %d):\n%s" % (name, proc.returncode, text))
            continue
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or none
        build_log[name] = {"seconds": secs, "ptxas": text}
        done[name] = secs
    if failed:
        raise MXNetError("nvcc failed for " + "\n".join(failed))
    return done


def load(name):
    """The ctypes library of kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)[1]))
            _libs[name] = lib
        return lib
