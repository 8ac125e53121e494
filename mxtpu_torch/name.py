"""Automatic naming for the symbolic API (counterpart of mxtpu/name.py;
parity: python/mxnet/name.py —
NameManager.current stack + the Prefix scope every reference model definition
uses as ``with mx.name.Prefix('stage1_'):``)."""
from __future__ import annotations

from .symbol.symbol import NameManager

__all__ = ["NameManager", "Prefix"]


class Prefix(NameManager):
    """Auto-named symbols created inside this scope get ``prefix`` +
    the counter name (reference name.py Prefix)."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def _name(self, name, hint):
        return self._prefix + super()._name(name, hint)
