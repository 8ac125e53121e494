"""Seeded deterministic exemplar sampling (``MXTPU_TRACE_SAMPLE``).

Counterpart of ``mxtpu/obs/sampler.py``, verbatim in its arithmetic, so
both packages sample the same ordinals.

Per-request exemplar traces must be *assertable*: the chaos/fuzz gates
need to know exactly which requests carry a trace, not "about 10% of
them". So the sampling decision for request ordinal ``n`` is a pure
function of ``(rate, seed, n)`` — a splitmix64-style integer hash mapped
to [0, 1) and compared against the rate. Two processes, or a test and
the assertion re-deriving the decision, always agree.

``MXTPU_TRACE_SAMPLE`` is ``"<rate>"`` or ``"<rate>:<seed>"`` with rate
in [0, 1]; unset or unparsable means 0 (no exemplars). ``1.0`` samples
every request — the form the gates use.
"""
from __future__ import annotations

import os

__all__ = ["TraceSampler"]

_M = 1 << 64


class TraceSampler:
    """Deterministic per-ordinal sampling decision."""

    __slots__ = ("rate", "seed")

    def __init__(self, rate=None, seed=0):
        if rate is None:
            spec = os.environ.get("MXTPU_TRACE_SAMPLE", "0")
            r, _, s = spec.partition(":")
            try:
                rate = float(r)
                seed = int(s) if s else 0
            except ValueError:
                rate, seed = 0.0, 0
        self.rate = min(1.0, max(0.0, float(rate)))
        self.seed = int(seed)

    def sampled(self, ordinal):
        """True when request ``ordinal`` (0-based admission order)
        carries an exemplar trace."""
        if self.rate >= 1.0:
            return True
        if self.rate <= 0.0:
            return False
        x = (int(ordinal) * 0x9E3779B97F4A7C15
             + self.seed * 0xD1B54A32D192ED03 + 1) % _M
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) % _M
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) % _M
        x ^= x >> 31
        return x / _M < self.rate

    def __repr__(self):
        return "TraceSampler(rate=%g, seed=%d)" % (self.rate, self.seed)
