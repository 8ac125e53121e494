"""Device-resident sequence state: ``SequenceSlotArena`` and ``PagedArena``.

Counterpart of ``mxtpu/serving/decode/arena.py``. Only slot indices and
block tables cross the host boundary; the state itself stays on the
device:

* :class:`SequenceSlotArena` keeps one tensor per state leaf, shaped
  ``(capacity,) + per_sequence_shape``. ``gather(slots, fresh)`` pulls
  the active rows into a ``(bucket, ...)`` batch, zeroing freshly
  admitted sequences (and pad rows) in the gathered batch;
  ``scatter(slots, states)`` writes the step's state back. Accounted in
  the device-memory ledger under ``decode_state``.
* :class:`PagedArena` keeps each leaf as one flat tensor of
  ``blocks_total x block_size`` token rows and hands blocks to sequences
  as they grow through host-side per-slot block tables (the vLLM
  recipe). ``gather_view`` assembles the bucketed ``(B, max_blocks,
  block, ...)`` view the attention step consumes; ``gather_rows`` /
  ``scatter_rows`` move single token rows by flat position. Accounted
  under ``decode_kv`` as live blocks x block bytes.

Two deltas from the JAX arenas, both because an out-of-range index on a
CUDA tensor is a device-side assert that poisons the process's CUDA
context, where XLA drops (``mode="drop"``) or clips (``mode="clip"``):

* pad rows carry the out-of-range index (``capacity`` /
  ``pad_flat_index``) exactly as in mxtpu, and a scatter drops them on
  the host before ``index_copy_``: a padded batch writes live rows only;
* a gather clamps its host-born indices into range before the device
  sees them (a pad row then reads the last row or block, garbage by
  design, made inert below).

Fresh and pad rows are zeroed with ``torch.where``, never by multiplying
by zero: a previous occupant's NaN must not reach the next one. The
gathers and scatters are eager indexing ops, so unlike the JAX arenas
they build no ``decode_state``/``decode_paged`` programs.
"""
from __future__ import annotations

import math

import numpy as _np
import torch

from ... import diagnostics as _diag
from ...analysis import concurrency as _conc
from ...base import MXNetError
from ...ops.registry import torch_dtype

__all__ = ["SequenceSlotArena", "PagedArena"]


def _index(idx, device):
    """A host index array as an int64 tensor on ``device``."""
    return torch.from_numpy(_np.ascontiguousarray(idx, dtype=_np.int64)) \
        .to(device)


def _zero_fresh(g, mask):
    """``g`` with the rows flagged in the 0/1 host ``mask`` replaced by
    exact zeros (select, not multiply)."""
    m = _index(mask > 0, g.device).to(torch.bool)
    m = m.reshape((-1,) + (1,) * (g.dim() - 1))
    return torch.where(m, torch.zeros((), dtype=g.dtype, device=g.device),
                       g)


def _scatter_live(arrays, idx, rows, n_rows):
    """``arrays[k][idx[i]] = rows[k][i]`` for every in-range ``idx[i]``;
    pad rows (``idx >= n_rows``) are dropped on the host."""
    idx = _np.asarray(idx, dtype=_np.int64)
    keep = _np.nonzero(idx < n_rows)[0]
    if keep.size == 0:
        return
    dev = arrays[0].device
    dst = _index(idx[keep], dev)
    sel = None if keep.size == idx.size else _index(keep, dev)
    with torch.no_grad():
        for a, r in zip(arrays, rows):
            r = getattr(r, "_data", r)
            if not isinstance(r, torch.Tensor):
                r = torch.as_tensor(_np.asarray(r))
            r = r.to(device=dev, dtype=a.dtype)
            if sel is not None:
                r = r.index_select(0, sel)
            a.index_copy_(0, dst, r.reshape((keep.size,) + a.shape[1:]))


class SequenceSlotArena:
    """Device-resident per-sequence state store with slot allocation.

    Parameters
    ----------
    capacity : int — maximum concurrently in-flight sequences
    state_specs : list of ``{"name", "shape", "dtype"}`` dicts with a
        leading (batch) dim of 1 (``BaseRNNCell.state_spec(1)``)
    ctx : Context the state lives on (default: current context)
    dtype : overrides every spec's dtype
    """

    def __init__(self, capacity, state_specs, ctx=None, dtype=None):
        from ...context import current_context
        if capacity < 1:
            raise MXNetError("SequenceSlotArena needs capacity >= 1")
        if not state_specs:
            raise MXNetError("SequenceSlotArena needs at least one "
                             "state spec")
        self.capacity = int(capacity)
        self._ctx = ctx or current_context()
        self.specs = []
        for s in state_specs:
            shape = tuple(int(d) for d in s["shape"])
            if len(shape) < 1:
                raise MXNetError("state spec %r needs a leading "
                                 "(batch) dim" % (s,))
            self.specs.append({"name": s["name"], "shape": shape[1:],
                               "dtype": str(dtype or s.get("dtype",
                                                           "float32"))})
        dev = self._ctx.torch_device
        self._arrays = [torch.zeros((self.capacity,) + s["shape"],
                                    dtype=torch_dtype(s["dtype"]),
                                    device=dev)
                        for s in self.specs]
        nbytes = sum(a.numel() * a.element_size() for a in self._arrays)
        self._mem_slot = _diag.ledger().slot(self, nbytes, "decode_state",
                                             ctx=str(self._ctx))
        self._free = list(range(self.capacity - 1, -1, -1))
        self._lock = _conc.lock("SequenceSlotArena", "_lock")
        self._closed = False

    @property
    def free_slots(self):
        with self._lock:
            return len(self._free)

    @property
    def occupancy(self):
        """Occupied-slot fraction (the ``decode_slot_occupancy`` gauge)."""
        with self._lock:
            return 1.0 - len(self._free) / self.capacity

    def allocate(self):
        """Claim a free slot id, or None when the arena is full. The rows
        are not cleared here: the first gather's ``fresh`` mask does it."""
        with self._lock:
            if self._closed or not self._free:
                return None
            return self._free.pop()

    def release(self, slot):
        """Return ``slot`` to the free list."""
        slot = int(slot)
        if not 0 <= slot < self.capacity:
            raise MXNetError("release: slot %d out of range [0, %d)"
                             % (slot, self.capacity))
        with self._lock:
            if slot in self._free:
                raise MXNetError("release: slot %d is already free" % slot)
            self._free.append(slot)

    def gather(self, slots, fresh):
        """The state rows of ``slots`` as ``(bucket, ...)`` device tensors,
        rows flagged in ``fresh`` (0/1) zeroed. Pad rows may carry any
        index, ``capacity`` included (clamped)."""
        idx = _np.clip(_np.asarray(slots, dtype=_np.int64), 0,
                       self.capacity - 1)
        mask = _np.asarray(fresh, dtype=_np.float32)
        t = _index(idx, self._arrays[0].device)
        return [_zero_fresh(a.index_select(0, t), mask)
                for a in self._arrays]

    def scatter(self, slots, new_states):
        """Write the step's state rows back at ``slots``; rows whose index
        is ``capacity`` (padding) are dropped."""
        _scatter_live(self._arrays, slots, new_states, self.capacity)

    def state_bytes(self):
        """Ledger-visible device bytes of the arena (``decode_state``)."""
        return sum(a.numel() * a.element_size() for a in self._arrays) \
            if self._arrays else 0

    def close(self):
        """Release the device tensors and zero the ledger entry."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._arrays = None
            self._free = []
        self._mem_slot.set(0)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class PagedArena:
    """Block-granular device-resident KV/state store.

    Parameters
    ----------
    capacity : int — maximum concurrently in-flight sequences
    block_size : int — token positions per KV block
    blocks_total : int — blocks in the shared device pool
    max_blocks_per_seq : int — per-slot table bound; fixes the gathered
        view's ``max_blocks`` axis
    kv_specs : list of ``{"name", "shape", "dtype"}`` — per-token trailing
        shape of each leaf (``(heads, head_dim)`` for a KV leaf)
    ctx / dtype : as :class:`SequenceSlotArena`
    """

    def __init__(self, capacity, block_size, blocks_total,
                 max_blocks_per_seq, kv_specs, ctx=None, dtype=None):
        from ...context import current_context
        if capacity < 1:
            raise MXNetError("PagedArena needs capacity >= 1")
        if block_size < 1 or blocks_total < 1 or max_blocks_per_seq < 1:
            raise MXNetError("PagedArena needs block_size, blocks_total "
                             "and max_blocks_per_seq >= 1")
        if not kv_specs:
            raise MXNetError("PagedArena needs at least one kv spec")
        self.capacity = int(capacity)
        self.block_size = int(block_size)
        self.blocks_total = int(blocks_total)
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        self._ctx = ctx or current_context()
        self.specs = [{"name": s["name"],
                       "shape": tuple(int(d) for d in s["shape"]),
                       "dtype": str(dtype or s.get("dtype", "float32"))}
                      for s in kv_specs]
        rows = self.blocks_total * self.block_size
        dev = self._ctx.torch_device
        self._arrays = [torch.zeros((rows,) + s["shape"],
                                    dtype=torch_dtype(s["dtype"]),
                                    device=dev)
                        for s in self.specs]
        #: device bytes one block holds across every leaf: the ledger's
        #: accounting quantum (live blocks x block_bytes, exact)
        self.block_bytes = sum(a.numel() * a.element_size()
                               // self.blocks_total for a in self._arrays)
        self._mem_slot = _diag.ledger().slot(self, 0, "decode_kv",
                                             ctx=str(self._ctx))
        self._free_slots = list(range(self.capacity - 1, -1, -1))
        self._free_blocks = list(range(self.blocks_total - 1, -1, -1))
        self._tables = [None] * self.capacity   # slot -> [block ids]
        self._lock = _conc.lock("PagedArena", "_lock")
        self._closed = False

    @property
    def free_slots(self):
        with self._lock:
            return len(self._free_slots)

    @property
    def occupancy(self):
        with self._lock:
            return 1.0 - len(self._free_slots) / self.capacity

    @property
    def blocks_free(self):
        with self._lock:
            return len(self._free_blocks)

    @property
    def blocks_live(self):
        with self._lock:
            return self.blocks_total - len(self._free_blocks)

    @property
    def block_occupancy(self):
        """Live-block fraction."""
        with self._lock:
            return 1.0 - len(self._free_blocks) / self.blocks_total

    def allocate(self):
        """Claim a free sequence slot (empty block table), or None."""
        with self._lock:
            if self._closed or not self._free_slots:
                return None
            slot = self._free_slots.pop()
            self._tables[slot] = []
            return slot

    def release(self, slot):
        """Return ``slot`` and every block of its table to the pools: the
        one release seam every eviction path reaches."""
        slot = int(slot)
        if not 0 <= slot < self.capacity:
            raise MXNetError("release: slot %d out of range [0, %d)"
                             % (slot, self.capacity))
        with self._lock:
            if self._tables[slot] is None:
                raise MXNetError("release: slot %d is already free" % slot)
            self._free_blocks.extend(reversed(self._tables[slot]))
            self._tables[slot] = None
            self._free_slots.append(slot)
            live = self.blocks_total - len(self._free_blocks)
        self._mem_slot.set(live * self.block_bytes)

    def ensure_tokens(self, slot, n_tokens):
        """Grow ``slot``'s table to cover ``n_tokens`` positions (host
        bookkeeping). Raises when the sequence would pass
        ``max_blocks_per_seq`` or the pool is dry. Returns the number of
        blocks appended."""
        need = math.ceil(int(n_tokens) / self.block_size)
        with self._lock:
            table = self._tables[slot]
            if table is None:
                raise MXNetError("ensure_tokens: slot %d is free" % slot)
            if need > self.max_blocks_per_seq:
                raise MXNetError(
                    "sequence needs %d KV blocks, over max_blocks_per_seq"
                    " %d (%d tokens at block_size %d)"
                    % (need, self.max_blocks_per_seq, n_tokens,
                       self.block_size))
            grew = 0
            while len(table) < need:
                if not self._free_blocks:
                    raise MXNetError(
                        "KV block pool exhausted (%d blocks live, %d "
                        "needed for slot %d)"
                        % (self.blocks_total, need, slot))
                table.append(self._free_blocks.pop())
                grew += 1
            live = self.blocks_total - len(self._free_blocks)
        self._mem_slot.set(live * self.block_bytes)
        return grew

    def tokens_capacity(self, slot):
        """Token positions ``slot``'s current table covers."""
        with self._lock:
            table = self._tables[slot]
            return len(table) * self.block_size if table else 0

    @property
    def pad_flat_index(self):
        """Out-of-range flat row index for padding (dropped by a scatter,
        clamped by a gather)."""
        return self.blocks_total * self.block_size

    def flat_index(self, slot, pos):
        """Flat storage row of token position ``pos`` in ``slot``."""
        pos = int(pos)
        with self._lock:
            table = self._tables[slot]
            if table is None or pos // self.block_size >= len(table):
                raise MXNetError(
                    "flat_index: position %d not covered by slot %d's "
                    "table" % (pos, slot))
            return table[pos // self.block_size] * self.block_size \
                + pos % self.block_size

    def block_table(self, slots):
        """``(len(slots), max_blocks)`` int32 table: row i holds slot
        ``slots[i]``'s block ids, padded (whole rows for ``None``) with
        the out-of-range id ``blocks_total``."""
        out = _np.full((len(slots), self.max_blocks_per_seq),
                       self.blocks_total, dtype=_np.int32)
        with self._lock:
            for i, slot in enumerate(slots):
                if slot is None:
                    continue
                table = self._tables[slot] or []
                out[i, :len(table)] = table
        return out

    def gather_view(self, slots):
        """The bucketed ``(B, max_blocks, block, ...)`` KV view of
        ``slots`` (``None`` = a pad row), one device gather per leaf. Table
        padding is clamped to the last block: garbage by design, which the
        step model's mask keeps inert."""
        tables = _np.minimum(self.block_table(slots), self.blocks_total - 1)
        t = _index(tables.reshape(-1), self._arrays[0].device)
        nblk, bs = self.blocks_total, self.block_size
        return [a.view((nblk, bs) + a.shape[1:]).index_select(0, t)
                .view(tables.shape + (bs,) + a.shape[1:])
                for a in self._arrays]

    def gather_rows(self, flat_idx, fresh):
        """Single token rows by flat position as ``(bucket, ...)``, rows
        flagged ``fresh`` (and pad rows, clamped) zeroed."""
        idx = _np.clip(_np.asarray(flat_idx, dtype=_np.int64), 0,
                       self.pad_flat_index - 1)
        mask = _np.asarray(fresh, dtype=_np.float32)
        t = _index(idx, self._arrays[0].device)
        return [_zero_fresh(a.index_select(0, t), mask)
                for a in self._arrays]

    def scatter_rows(self, flat_idx, rows):
        """Write one token row per leaf at each flat position; padding
        positions (``pad_flat_index``) are dropped."""
        _scatter_live(self._arrays, flat_idx, rows, self.pad_flat_index)

    def live_kv_bytes(self):
        """The ledger's ``decode_kv`` basis: blocks_live x block_bytes."""
        return self.blocks_live * self.block_bytes

    def state_bytes(self):
        """Physical device bytes of the preallocated pool."""
        return sum(a.numel() * a.element_size() for a in self._arrays) \
            if self._arrays else 0

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._arrays = None
            self._free_slots = []
            self._free_blocks = []
            self._tables = [None] * self.capacity
        self._mem_slot.set(0)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
