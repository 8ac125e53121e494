"""Symbol-level model factories ported so far."""
from . import transformer
from .transformer import get_symbol as get_transformer_lm

__all__ = ["transformer", "get_transformer_lm"]
