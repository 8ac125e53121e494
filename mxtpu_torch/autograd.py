"""Define-by-run autograd on torch's own tape.

Counterpart of ``mxtpu/autograd.py``: the ``record``/``pause`` scopes and
the training flag (:20-85), ``mark_variables`` (:116), ``backward``
(:178) and ``Function`` (:248). mxtpu keeps its own tape of op invokes
and replays it through ``jax.vjp``; here torch's autograd is the tape.
An op records only while ``record()`` is open: the imperative invoke
runs it under grad mode then, and under ``torch.no_grad()`` otherwise. A
marked array is a leaf tensor with ``requires_grad`` (none for grad_req
"null"), and carries its gradient buffer and grad_req on the tensor.
Each array on the tape carries the marked leaves it was computed from,
through any recorded op, differentiable or not. ``backward`` takes
``torch.autograd.grad`` of the heads (ones where a head gradient is
missing) with respect to the leaves that feed them, the variables mxtpu
puts through ``jax.vjp`` (:200-210), and writes each gradient into its
buffer by grad_req: "write" overwrites, "add" adds. A variable that
feeds a head only through a non-differentiable op (argmax, a 0/1
comparison, pick's index) gets zeros under "write", as mxtpu's zero
cotangent. torch's ``.grad`` is never touched, so nothing accumulates
there from one step into the next.

The tape has a generation: the arrays a recorded op consumed or
produced belong to the current one, ``backward`` (without
``retain_graph``) starts the next, and an array of an older generation is
off the tape. ``backward`` of an array not produced under ``record()`` in
the current generation raises, as mxtpu's does when its tape holds no
entry for it (:195); so does an in-place update of an array on the tape
while recording (``NDArray._inplace_guard``).
"""
from __future__ import annotations

import itertools
import threading

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training",
           "mark_variables", "backward", "Function"]

_tls = threading.local()
_generations = itertools.count(1)


def _st():
    if not hasattr(_tls, "recording"):
        _tls.recording = False
        _tls.training = False
        _tls.gen = next(_generations)
    return _tls


class _RecordingScope:
    def __init__(self, recording, training):
        self._rec = recording
        self._train = training

    def __enter__(self):
        st = _st()
        self._old = (st.recording, st.training)
        if self._rec is not None:
            st.recording = self._rec
        if self._train is not None:
            st.training = self._train
        return self

    def __exit__(self, *a):
        st = _st()
        st.recording, st.training = self._old


def record(train_mode=True):
    """Scope: record imperative ops onto the tape (parity autograd.py:121)."""
    return _RecordingScope(True, train_mode)


def pause(train_mode=False):
    return _RecordingScope(False, train_mode)


def train_mode():
    return _RecordingScope(None, True)


def predict_mode():
    return _RecordingScope(None, False)


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_recording(flag):
    st = _st()
    old = st.recording
    st.recording = bool(flag)
    return old


def set_training(flag):
    st = _st()
    old = st.training
    st.training = bool(flag)
    return old


def grad_mode():
    """torch's grad mode for an op run now: enabled while recording."""
    return torch.enable_grad() if _st().recording else torch.no_grad()


def record_arrays(inputs, outputs):
    """Put a recorded computation's arrays on the tape: the inputs and
    outputs join the current generation, and each output carries the
    marked leaves its inputs were computed from (``_tape_deps``, id ->
    leaf tensor; a dict is shared, never changed once assigned)."""
    gen = _st().gen
    deps, shared = {}, True
    for x in inputs:
        if x._tape_gen != gen:
            x._tape_gen = gen
            t = x._data
            x._tape_deps = ({id(t): t} if t.requires_grad
                            and hasattr(t, "_mx_grad") else {})
        xd = x._tape_deps
        if not xd or xd is deps:
            continue
        if not deps:
            deps = xd
        else:
            if shared:
                deps, shared = dict(deps), False
            deps.update(xd)
    for y in outputs:
        y._tape_gen = gen
        y._tape_deps = deps


def on_tape(arr):
    """Whether ``arr`` was consumed or produced by an op recorded in the
    current generation (the in-place guard's predicate)."""
    return arr._tape_gen == _st().gen


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach gradient buffers (parity autograd.py:196): each variable's
    tensor becomes a leaf (a detached view of the same storage) that
    requires grad unless its grad_req is "null"."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req %r: use write, add or null" % (req,))
        t = v._data.detach()
        t.requires_grad_(req != "null")
        t._mx_grad = g
        t._mx_req = req
        v._data = t
        v._tape_gen = 0  # a new leaf: it joins the tape when consumed
        v.grad = g
        v._grad_req = req


def backward(heads, head_grads=None, retain_graph=False,
             train_mode=True):
    """Gradients of ``heads`` with respect to every marked variable that
    feeds them, into their buffers by grad_req (parity autograd.py:227);
    ones where a head gradient is missing."""
    del train_mode
    from .ndarray import NDArray

    if isinstance(heads, NDArray):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    st = _st()
    if any(h._tape_gen != st.gen for h in heads):
        raise MXNetError("backward: outputs were not computed under "
                         "record()")
    outs, grads = [], []
    for h, g in zip(heads, head_grads):
        if h._data.requires_grad:
            outs.append(h._data)
            grads.append(torch.ones_like(h._data) if g is None else
                         g._data.to(h._data.device, h._data.dtype))
    variables = {}
    for h in heads:
        variables.update(h._tape_deps)
    leaves = [t for t in variables.values() if t.requires_grad]
    got = [None] * len(leaves)
    if outs and leaves:
        got = torch.autograd.grad(outs, leaves, grads,
                                  retain_graph=retain_graph,
                                  allow_unused=True)
    with torch.no_grad():
        for t, g in zip(leaves, got):
            buf = t._mx_grad._data
            if g is None:
                if t._mx_req == "write":
                    buf.zero_()
            elif t._mx_req == "add":
                buf.add_(g.to(buf.dtype))
            else:
                buf.copy_(g)
    if not retain_graph:
        st.gen = next(_generations)


class Function:
    """Custom differentiable function (parity autograd.py:292): subclass
    and override ``forward`` and ``backward``, both on NDArrays. While
    recording, a call runs as a ``torch.autograd.Function`` whose backward
    calls this ``backward`` on the head gradients."""

    def __init__(self):
        self._saved = None

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray import NDArray

        if not is_recording():
            with pause(is_training()):
                return self.forward(*inputs)
        fn = self
        single = []

        class _Op(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *raw):
                with pause(is_training()):
                    outs = fn.forward(*[NDArray(r, x.context)
                                        for r, x in zip(raw, inputs)])
                single.append(not isinstance(outs, (list, tuple)))
                outs = [outs] if single[0] else list(outs)
                ctx.contexts = [o.context for o in outs]
                return tuple(o._data for o in outs)

            @staticmethod
            def backward(ctx, *cts):
                with pause():
                    gin = fn.backward(*[NDArray(c, cx) for c, cx in
                                        zip(cts, ctx.contexts)])
                gin = gin if isinstance(gin, (list, tuple)) else [gin]
                return tuple(g._data for g in gin)

        raw = _Op.apply(*[x._data for x in inputs])
        raw = raw if isinstance(raw, tuple) else (raw,)
        outs = [NDArray(r) for r in raw]
        record_arrays(inputs, outs)
        return outs[0] if single[0] else outs
