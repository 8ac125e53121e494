"""mxtpu_torch.serving.decode: stateful autoregressive decode serving.

Counterpart of ``mxtpu/serving/decode/``. Per-request state lives on the
device in an arena and rides across steps while sequences join and
leave the in-flight batch between steps:

  * ``arena``   — :class:`SequenceSlotArena` (fixed-shape recurrent
                  state per slot, ledger origin ``decode_state``) and
                  :class:`PagedArena` (KV blocks handed out as a sequence
                  grows, per-slot block tables, ledger origin
                  ``decode_kv``)
  * ``session`` — :class:`DecodeSession`'s step loop: admission into free
                  slots, chunked prefill interleaved with decode steps,
                  EOS / budget / deadline retirement, versioned
                  ``swap_model``, length-aware admission
                  (``DecodeAdmissionPolicy``)
  * ``model``   — the single-step graph builders and fixtures
  * ``stream``  — :class:`TokenStream`, behind ``POST
                  /v1/generate?stream=1``
"""
from .arena import PagedArena, SequenceSlotArena
from .model import (attn_decode_fixture, attn_prefill_symbol,
                    attn_step_symbol, lm_decode_fixture, lm_step_symbol)
from .session import (DecodeResult, DecodeSession, DecodeWorkerCrash,
                      serve_decode)
from .stream import TokenStream

__all__ = ["SequenceSlotArena", "PagedArena", "DecodeSession",
           "DecodeResult", "DecodeWorkerCrash", "TokenStream",
           "serve_decode", "lm_step_symbol", "lm_decode_fixture",
           "attn_step_symbol", "attn_prefill_symbol",
           "attn_decode_fixture"]
