"""AttrScope: scoped symbol attributes (parity: python/mxnet/attribute.py).

The port's own copy of ``mxtpu/attribute.py``. ``with
mx.AttrScope(ctx_group="dev1"):`` attaches ``__ctx_group__``-style attrs
to every variable and op symbol created inside the block: the mechanism
the reference's group2ctx model parallelism rides, which the port's
executor maps onto devices (``Executor(group2ctx=...)``).
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current_attrs"]


class AttrScope:
    """Attribute manager for scoping; user-defined attrs get the
    ``__key__`` dunder form like the reference."""

    _tls = threading.local()

    def __init__(self, **kwargs):
        self._attrs = {"__%s__" % k: str(v) for k, v in kwargs.items()}

    @classmethod
    def _stack(cls):
        if not hasattr(cls._tls, "stack"):
            cls._tls.stack = [{}]
        return cls._tls.stack

    @classmethod
    def current(cls):
        return cls._stack()[-1]

    def get(self, attrs=None):
        """Merge scope attrs under explicit attrs (explicit wins)."""
        merged = dict(self.current())
        if attrs:
            merged.update(attrs)
        return merged

    def __enter__(self):
        stack = self._stack()
        merged = dict(stack[-1])
        merged.update(self._attrs)
        stack.append(merged)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self._stack().pop()


def current_attrs(attrs=None):
    """The active scope's attrs merged under the explicit ones."""
    merged = dict(AttrScope.current())
    if attrs:
        merged.update(attrs)
    return merged
