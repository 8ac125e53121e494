"""Device contexts mapped onto torch devices.

Counterpart of ``mxtpu/context.py``. There ``gpu(i)`` aliases the i-th
TPU chip; here it is the real CUDA device ``cuda:i`` and ``tpu`` is gone.
The default context is ``gpu(0)``: an entry point given no context runs
on the card, and raises when there is none — it never carries on quietly
on the CPU. Pass ``cpu()`` explicitly (``with cpu():`` or ``ctx=cpu()``)
to run the plain PyTorch versions on the host.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "current_context", "num_gpus",
           "context_list"]


class Context:
    """A device context: devtype 'cpu' or 'gpu' (a CUDA device)."""

    devtype2id = {"cpu": 1, "gpu": 2}
    devid2type = {1: "cpu", 2: "gpu"}
    _default_ctx = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_id = device_type.device_id
            device_type = device_type.device_type
        if device_type not in self.devtype2id:
            raise MXNetError("unknown device type %s" % device_type)
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def device_typeid(self):
        return self.devtype2id[self.device_type]

    @property
    def torch_device(self):
        """The torch.device this context maps to. Raises for a gpu
        context when CUDA is absent or the id is out of range."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        n = num_gpus()
        if self.device_id >= n:
            raise MXNetError(
                "context gpu(%d): %d CUDA device(s) available"
                % (self.device_id, n))
        return torch.device("cuda", self.device_id)

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    def __enter__(self):
        if not hasattr(self._default_ctx, "stack"):
            self._default_ctx.stack = []
        self._default_ctx.stack.append(self)
        return self

    def __exit__(self, *args):
        self._default_ctx.stack.pop()

    @classmethod
    def default_ctx(cls):
        stack = getattr(cls._default_ctx, "stack", None)
        if stack:
            return stack[-1]
        if num_gpus() == 0:
            raise MXNetError(
                "no CUDA device: the default context is gpu(0); pass "
                "cpu() explicitly to run on the host")
        return Context("gpu", 0)


def cpu(device_id=0):
    return Context("cpu", device_id)


def gpu(device_id=0):
    """The i-th CUDA device."""
    return Context("gpu", device_id)


def current_context():
    """The innermost ``with ctx:`` scope, else gpu(0); raises when there
    is no scope and no CUDA device."""
    return Context.default_ctx()


def num_gpus():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def as_context(ctx):
    """Normalize a Context / torch.device / device string to a Context."""
    if isinstance(ctx, Context):
        return ctx
    dev = torch.device(ctx)
    if dev.type == "cpu":
        return cpu()
    if dev.type == "cuda":
        return gpu(dev.index or 0)
    raise MXNetError("unsupported device %s" % dev)


def context_list(contexts):
    """A list of distinct Contexts from one context or a list of them.
    A context named twice raises MXNetError that names it: mxtpu breaks
    on a repeated context (a resharding assertion), the port refuses it
    plainly. ``cpu(0)``, ``cpu(1)``, ... are distinct contexts on the one
    host device, as mxtpu's tests use XLA's host devices."""
    if not isinstance(contexts, (list, tuple)):
        contexts = [contexts]
    out = [as_context(c) for c in contexts]
    if not out:
        raise MXNetError("an empty context list")
    seen = set()
    for c in out:
        if c in seen:
            raise MXNetError("context %s is named twice in %s: each "
                             "context holds one replica" % (c, out))
        seen.add(c)
    return out
