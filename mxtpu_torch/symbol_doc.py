"""Structured docstring carriers for the generated symbol functions
(parity: python/mxnet/symbol_doc.py — SymbolDoc and the per-op *Doc
classes whose docstrings the reference splices into ``mx.sym.<Op>``).

The port's own copy of ``mxtpu/symbol_doc.py`` (which uses no JAX); the
registry documents each op from its attrs, so these classes carry the
narrative text and ``SymbolDoc.get_output_shape``.
"""
from __future__ import annotations

__all__ = ["SymbolDoc", "ActivationDoc", "DropoutDoc", "EmbeddingDoc",
           "FlattenDoc", "FullyConnectedDoc", "ConcatDoc",
           "BroadcastPlusDoc"]


class SymbolDoc:
    """Doc container + the debug helpers the reference exposes here."""

    @staticmethod
    def get_output_shape(sym, **input_shapes):
        """Infer and return {output_name: shape} (parity
        symbol_doc.py SymbolDoc.get_output_shape)."""
        _, s_outputs, _ = sym.infer_shape(**input_shapes)
        return dict(zip(sym.list_outputs(), s_outputs))


class ActivationDoc(SymbolDoc):
    """Examples for mx.sym.Activation (relu/sigmoid/tanh/softrelu)."""


class DropoutDoc(SymbolDoc):
    """Examples for mx.sym.Dropout (train-time masking, eval identity)."""


class EmbeddingDoc(SymbolDoc):
    """Examples for mx.sym.Embedding (index -> dense vector lookup)."""


class FlattenDoc(SymbolDoc):
    """Examples for mx.sym.Flatten ((N, ...) -> (N, prod))."""


class FullyConnectedDoc(SymbolDoc):
    """Examples for mx.sym.FullyConnected (X W^T + b)."""


class ConcatDoc(SymbolDoc):
    """Examples for mx.sym.Concat (join along an existing axis)."""


class BroadcastPlusDoc(SymbolDoc):
    """Examples for broadcast_add semantics."""
