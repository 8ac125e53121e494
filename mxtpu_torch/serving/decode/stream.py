"""TokenStream: incremental delivery of decode events to one consumer.

Counterpart of ``mxtpu/serving/decode/stream.py``. The decode worker
pushes into it at the emit sites (the final prefill chunk's first token,
every decode-step token, the terminal finish or error), and the HTTP
handler drains it into chunked ``POST /v1/generate?stream=1`` frames.

Events (one JSON line each on the wire):

* ``{"token": int, "index": int}``: one retired token;
* ``{"done": result_dict}``: terminal, the payload ``DecodeResult.wait``
  returns (closes the stream);
* ``{"error": str, "type": str}``: terminal failure (closes the stream).
  Every path that fails the result also closes its stream.

Single producer, single consumer; the lock and condition come from the
tracked ``concurrency`` factory (level ``decode-stream``).
"""
from __future__ import annotations

from collections import deque

from ...analysis import concurrency as _conc

__all__ = ["TokenStream"]


class TokenStream:
    """Closable event queue between the decode worker and one consumer.

    ``put`` after ``close`` is a no-op (a racing emit during teardown
    must not resurrect a terminated stream); ``events()`` yields until
    the terminal event has been consumed.
    """

    def __init__(self):
        self._lock = _conc.lock("TokenStream", "_lock")
        self._ready = _conc.condition(self._lock)
        self._events = deque()
        self._closed = False

    def put(self, event):
        """Producer side: enqueue one event dict (dropped if closed)."""
        with self._lock:
            if self._closed:
                return
            self._events.append(event)
            self._ready.notify_all()

    def close(self):
        """Mark the stream terminal — ``events()`` drains what is
        queued, then stops. Producers call this right after pushing the
        ``done``/``error`` event."""
        with self._lock:
            self._closed = True
            self._ready.notify_all()

    @property
    def closed(self):
        with self._lock:
            return self._closed and not self._events

    def get(self, timeout=None):
        """Consumer side: the next event, or ``None`` when the stream
        is closed and drained. Raises :class:`TimeoutError` when no
        event arrives within ``timeout`` seconds."""
        with self._lock:
            ok = self._ready.wait_for(
                lambda: self._events or self._closed, timeout)
            if self._events:
                return self._events.popleft()
            if self._closed:
                return None
            if not ok:
                raise TimeoutError(
                    "no stream event within %.1fs" % (timeout or 0.0))
            return None

    def events(self, timeout=None):
        """Iterate events until the stream closes; ``timeout`` bounds
        each individual wait (a stalled producer surfaces as
        :class:`TimeoutError`, not a hang)."""
        while True:
            ev = self.get(timeout)
            if ev is None:
                return
            yield ev
