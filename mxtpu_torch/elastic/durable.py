"""Shared durable-write primitives: the snapshot writer's fsync-rename
idiom, which the obs measurement corpus reuses so both keep one
crash-window contract (counterpart of ``mxtpu/elastic/durable.py``).

* :func:`write_atomic` — tmp + fsync + ``os.replace`` + dir fsync: the
  destination holds either the whole new content or the previous one,
  never a prefix. The ``elastic.snapshot.fsync_rename`` fault point sits
  between the tmp write and its rename: firing there IS a torn write.
* :func:`fsync_dir` — best-effort directory fsync, so a rename (or a
  freshly created append file) survives power loss, not just process
  death.

Stdlib and the faults guard only, so the lowest layers can import it.
"""
from __future__ import annotations

import os

from ..faults import injection as _faults

__all__ = ["fsync_dir", "write_atomic"]


def fsync_dir(path):
    """Best-effort fsync of ``path``'s directory, so the rename itself is
    durable."""
    try:
        fd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                     os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass  # a platform without directory fsync


def write_atomic(path, data_bytes):
    """tmp + fsync + rename: the file has either all of ``data_bytes`` or
    its previous content. Returns the byte count."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data_bytes)
        f.flush()
        os.fsync(f.fileno())
    # between the tmp write and its rename: firing here IS a torn write
    _faults.point("elastic.snapshot.fsync_rename")
    os.replace(tmp, path)
    fsync_dir(path)
    return len(data_bytes)
