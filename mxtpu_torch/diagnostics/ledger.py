"""Device-memory accounting: a process-wide storage ledger.

Counterpart of ``mxtpu/diagnostics/ledger.py``. The ledger answers the
runtime form of "how much memory does this session take": how many
device bytes are live right now, which subsystem allocated them, and
what the peak was, per ``(ctx, origin)``.

Two tracking modes feed one set of totals, as in mxtpu:

* **storage tracking** (``track``): the bytes of a tensor's *storage*
  are tied to the lifetimes of the tensors tracked over it. mxtpu dedups
  by buffer identity; here many NDArrays share one storage (a basic
  index is a write-through view, the executor group's gradients are
  views into one flat buffer), so the key is the storage's
  ``(device, data pointer)`` and every tracked tensor over it holds one
  reference: the bytes count once and are released when the last of
  them is collected (a weak reference per tensor whose callback parks
  the release, drained under the lock as mxtpu's finalizers are). A live storage's address
  cannot be reused while a tracked tensor over it lives, so a key never
  aliases two storages.
* **slot accounting** (``slot``): an owner-scoped byte count for state
  whose size is fixed while its tensors churn (the executor's outputs,
  the fused step's optimizer state). The slot dies with its owner.

Origins are attributed by allocation site through a contextvar
(``alloc_origin``): the outermost attribution wins.

``reconcile()`` compares the ledger with the CUDA caching allocator on
every card the ledger has bytes on: ``requested_bytes.all.current``
(the sizes asked for, before the allocator's 512-byte rounding and
block splitting) against the ledger's bytes there, so ``drift_bytes``
counts only allocations no seam tracked, and ``rounding_bytes``
(``memory_allocated`` minus requested) says what the allocator's
blocks add on top. On the CPU there is no allocator counter: reconcile
returns the ledger's bytes with ``live_bytes`` and ``drift_bytes``
None and ``allocator`` None, and says so (a deliberate delta from
mxtpu's ``jax.live_arrays()`` sum, which has a CPU backend).
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import weakref
from collections import deque

from .. import telemetry as _tel
from ..analysis import concurrency as _conc

__all__ = ["DeviceMemoryLedger", "ledger", "mem_enabled", "set_mem_enabled",
           "alloc_origin", "current_origin", "DEFAULT_ORIGIN",
           "device_label", "storage_key"]

DEFAULT_ORIGIN = "ndarray"

_ENABLED = os.environ.get("MXTPU_DIAG_MEM", "1") != "0"

_origin = contextvars.ContextVar("mxtpu_torch_alloc_origin", default=None)


def mem_enabled():
    """Whether the allocation seams feed the ledger."""
    return _ENABLED


def set_mem_enabled(flag):
    """Runtime toggle for the allocation seams (``MXTPU_DIAG_MEM=0`` sets
    the initial state). Storages already tracked keep their finalizers —
    disabling stops NEW registrations."""
    global _ENABLED
    _ENABLED = bool(flag)


def current_origin():
    """The allocation origin ambient on this thread (see alloc_origin)."""
    o = _origin.get()
    return o if o is not None else DEFAULT_ORIGIN


@contextlib.contextmanager
def alloc_origin(origin, override=False):
    """Attribute allocations inside the block to ``origin``. The OUTERMOST
    attribution wins by default (an executor bind inside a serving-pool
    block stays ``serving_pool``); pass ``override=True`` to re-tag."""
    if not override and _origin.get() is not None:
        yield
        return
    token = _origin.set(origin)
    try:
        yield
    finally:
        _origin.reset(token)


_LABELS = {}  # torch.device -> label (the seam runs at every creation)


def device_label(device):
    """Ledger context label for a ``torch.device`` — ``str(Context)``'s
    rendering (``gpu(0)``, ``cpu(0)``), so both seams land on one
    series."""
    label = _LABELS.get(device)
    if label is not None:
        return label
    try:
        if device.type == "cuda":
            idx = device.index
            if idx is None:  # the current card: not cached
                import torch
                return "gpu(%d)" % torch.cuda.current_device()
            label = "gpu(%d)" % idx
        else:
            label = "%s(%d)" % (device.type, device.index or 0)
    except Exception:
        return "unknown"
    _LABELS[device] = label
    return label


def storage_key(t):
    """``(device label, storage data pointer, storage bytes)`` of a
    tensor, or None for one without device memory (a meta or empty
    tensor)."""
    try:
        if t.device.type == "meta":
            return None
        st = t.untyped_storage()
        ptr = st.data_ptr()
        nbytes = st.nbytes()
    except Exception:
        return None
    if not ptr or not nbytes:
        return None
    return device_label(t.device), ptr, nbytes


class _Slot:
    """Owner-scoped byte count; freed when the owner is collected."""

    __slots__ = ("_ledger", "_key", "_nbytes", "__weakref__")

    def __init__(self, ledger_, key, nbytes):
        self._ledger = ledger_
        self._key = key
        self._nbytes = 0
        self.set(nbytes)

    def set(self, nbytes):
        # the delta is a read-modify-write: applied under the ledger lock
        self._ledger._slot_set(self, int(nbytes))

    def close(self):
        self.set(0)

    def _drain_close(self, apply):
        """Called by the ledger's drain, lock already held."""
        if self._nbytes:
            apply(self._key, -self._nbytes)
            self._nbytes = 0


class DeviceMemoryLedger:
    """Thread-safe live/peak device-byte totals per ``(ctx, origin)``.

    ``alloc``/``free`` are the primitive pair; ``track``/``slot`` build
    the automatic lifetimes on top (see the module docstring)."""

    def __init__(self, register_gauges=True):
        self._lock = _conc.lock("DeviceMemoryLedger", "_lock")
        self._live = {}        # (ctx, origin) -> bytes
        self._live_ctx = {}    # ctx -> bytes
        self._peak_ctx = {}    # ctx -> bytes
        # (ctx, ptr) -> [token, tensors tracked over the storage]
        self._tracked = {}
        # id(weakref to a tracked tensor) -> (the weakref, its key); by
        # id: weakrefs to live tensors compare by the tensors' ==
        self._refs = {}
        self._register_gauges = register_gauges
        self._gauged = set()
        # finalizers run inside the garbage collector, possibly while
        # this thread holds self._lock: they only append here (atomic)
        # and the entries are drained under the lock at the next use
        self._deferred = deque()
        park = self._deferred.append
        self._on_dead = lambda ref: park(("buf", ref))

    # ------------------------------------------------------------ primitives
    def _drain_locked(self, new_pairs):
        while True:
            try:
                kind, payload = self._deferred.popleft()
            except IndexError:
                return
            if kind == "buf":
                key = self._refs.pop(id(payload), (None, None))[1]
                entry = self._tracked.get(key)
                if entry is None:
                    continue
                entry[1] -= 1
                if entry[1] <= 0:
                    del self._tracked[key]
                    okey, nbytes = entry[0]
                    self._apply(okey, -nbytes, new_pairs)
            else:  # slot
                payload._drain_close(
                    lambda k, d: self._apply(k, d, new_pairs))

    def _apply(self, key, delta, new_pairs):
        ctx = key[0]
        if key not in self._live and self._register_gauges:
            new_pairs.append(key)
        self._live[key] = self._live.get(key, 0) + delta
        total = self._live_ctx.get(ctx, 0) + delta
        self._live_ctx[ctx] = total
        if total > self._peak_ctx.get(ctx, 0):
            self._peak_ctx[ctx] = total

    def _gauge_key(self, key):
        """The telemetry gauges of a new (ctx, origin) pair, registry-
        direct so the series exist under MXTPU_TELEMETRY=0."""
        if key in self._gauged:
            return
        ctx, origin = key
        reg = _tel.registry()
        reg.gauge("mem_live_bytes", labels={"ctx": ctx, "origin": origin},
                  fn=lambda k=key: self._gauge_live(k),
                  help="live device bytes the ledger attributes to "
                       "(ctx, origin)")
        if ctx not in {c for c, _ in self._gauged}:
            reg.gauge("mem_peak_bytes", labels={"ctx": ctx},
                      fn=lambda c=ctx: self._gauge_peak(c),
                      help="high-water mark of ledger-tracked live bytes")
        self._gauged.add(key)

    def _gauge_live(self, key):
        self._drain()
        return self._live.get(key, 0)

    def _gauge_peak(self, ctx):
        self._drain()
        return self._peak_ctx.get(ctx, 0)

    def _add(self, key, delta):
        new_pairs = []
        with self._lock:
            if self._deferred:
                self._drain_locked(new_pairs)
            self._apply(key, delta, new_pairs)
        for k in new_pairs:
            self._gauge_key(k)

    def _slot_set(self, slot, nbytes):
        new_pairs = []
        with self._lock:
            if self._deferred:
                self._drain_locked(new_pairs)
            delta = nbytes - slot._nbytes
            if delta:
                self._apply(slot._key, delta, new_pairs)
                slot._nbytes = nbytes
        for k in new_pairs:
            self._gauge_key(k)

    def alloc(self, nbytes, ctx="cpu(0)", origin=None):
        """Record ``nbytes`` live; returns the token to ``free`` later."""
        origin = origin or current_origin()
        key = (str(ctx), origin)
        nbytes = int(nbytes)
        self._add(key, nbytes)
        return (key, nbytes)

    def free(self, token):
        key, nbytes = token
        self._add(key, -nbytes)

    # ------------------------------------------------------------ lifetimes
    def track(self, tensor, origin=None, ctx=None):
        """Tie the bytes of ``tensor``'s storage to the lifetimes of the
        tensors tracked over it. The first registration of a storage
        counts its bytes under its origin (first origin wins); a later
        tensor over the same storage (a view, a second NDArray) only
        extends its lifetime. Returns True for a storage counted now."""
        info = storage_key(tensor)
        if info is None:
            return False
        label, ptr, nbytes = info
        key = (label, ptr)
        new_pairs = []
        with self._lock:
            # drain parked releases BEFORE the dedup check: a dead
            # storage's address may be this live one's
            if self._deferred:
                self._drain_locked(new_pairs)
            entry = self._tracked.get(key)
            fresh = entry is None
            if fresh:
                okey = (str(ctx) if ctx is not None else label,
                        origin or current_origin())
                entry = self._tracked[key] = [(okey, nbytes), 0]
                self._apply(okey, nbytes, new_pairs)
            entry[1] += 1
            # a weak reference whose callback parks the release (cheaper
            # than weakref.finalize at every creation)
            ref = weakref.ref(tensor, self._on_dead)
            self._refs[id(ref)] = (ref, key)
        for k in new_pairs:
            self._gauge_key(k)
        return fresh

    def slot(self, owner, nbytes, origin, ctx="cpu(0)"):
        """Owner-scoped byte count; returns the slot so the owner can
        ``set()`` a new size. Freed when ``owner`` is collected."""
        s = _Slot(self, (str(ctx), origin), nbytes)
        weakref.finalize(owner, self._deferred.append, ("slot", s))
        return s

    def _drain(self):
        new_pairs = []
        with self._lock:
            if self._deferred:
                self._drain_locked(new_pairs)
        for k in new_pairs:
            self._gauge_key(k)

    # ------------------------------------------------------------ reads
    def live_bytes(self, origin=None, ctx=None):
        self._drain()
        with self._lock:
            if origin is None and ctx is None:
                return sum(self._live_ctx.values())
            return sum(v for (c, o), v in self._live.items()
                       if (origin is None or o == origin)
                       and (ctx is None or c == str(ctx)))

    def shard_bytes(self, origin=None):
        """Per-device live bytes: {ctx: bytes}, optionally of one
        origin."""
        self._drain()
        with self._lock:
            if origin is None:
                return dict(sorted(self._live_ctx.items()))
            out = {}
            for (c, o), v in self._live.items():
                if o == origin and v:
                    out[c] = out.get(c, 0) + v
            return dict(sorted(out.items()))

    def peak_bytes(self, ctx=None):
        self._drain()
        with self._lock:
            if ctx is None:
                return max(self._peak_ctx.values(), default=0)
            return self._peak_ctx.get(str(ctx), 0)

    @property
    def tracked_buffers(self):
        """Storages with a live tracked tensor."""
        self._drain()
        return len(self._tracked)

    def snapshot(self):
        """JSON-ready view: per-(ctx, origin) live bytes, per-ctx totals
        and peaks, tracked-storage count (mxtpu's keys)."""
        self._drain()
        with self._lock:
            by_origin = {"%s/%s" % k: v for k, v in sorted(self._live.items())
                         if v}
            return {
                "live_bytes": by_origin,
                "live_bytes_total": sum(self._live_ctx.values()),
                "live_bytes_by_ctx": dict(sorted(self._live_ctx.items())),
                "peak_bytes_by_ctx": dict(sorted(self._peak_ctx.items())),
                "tracked_buffers": len(self._tracked),
            }

    def reconcile(self):
        """Drift check against the CUDA caching allocator, per card the
        ledger has bytes on (see the module docstring). ``drift_bytes`` =
        the allocator's requested bytes minus the ledger's, summed over
        the cards; ``by_ctx`` holds each card's figures. On the CPU (no
        card holds ledger bytes, or CUDA is absent) the allocator figures
        are None."""
        ledger_bytes = self.live_bytes()
        by_ctx_ledger = self.shard_bytes()
        cards = sorted(int(c[4:-1]) for c in by_ctx_ledger
                       if c.startswith("gpu("))
        import torch
        if not cards or not torch.cuda.is_available():
            return {"ledger_bytes": ledger_bytes, "live_bytes": None,
                    "live_arrays": None, "drift_bytes": None,
                    "allocator": None,
                    "note": "no CUDA allocator holds the ledger's bytes "
                            "(CPU): nothing to reconcile against"}
        by_ctx = {}
        live = drift = rounding = blocks = 0
        for i in cards:
            stats = torch.cuda.memory_stats(i)
            alloc = int(stats.get("allocated_bytes.all.current", 0))
            req = int(stats.get("requested_bytes.all.current", alloc))
            n = int(stats.get("active.all.current", 0))
            led = by_ctx_ledger.get("gpu(%d)" % i, 0)
            by_ctx["gpu(%d)" % i] = {
                "ledger_bytes": led, "requested_bytes": req,
                "allocated_bytes": alloc, "drift_bytes": req - led,
                "rounding_bytes": alloc - req, "blocks": n}
            live += req
            drift += req - led
            rounding += alloc - req
            blocks += n
        _tel.registry().gauge(
            "mem_drift_bytes",
            help="CUDA allocator requested bytes minus ledger total at "
                 "the last reconcile() — untracked allocations").set(drift)
        return {"ledger_bytes": ledger_bytes, "live_bytes": live,
                "live_arrays": blocks, "drift_bytes": drift,
                "rounding_bytes": rounding, "allocator": "cuda",
                "by_ctx": by_ctx}


_LEDGER = DeviceMemoryLedger()

_tel.registry().gauge("mem_tracked_buffers",
                      fn=lambda: _LEDGER.tracked_buffers,
                      help="device storages with a live ledger finalizer")


def ledger():
    """The process-wide DeviceMemoryLedger."""
    return _LEDGER

