"""Global random state: one torch.Generator chain per device.

Counterpart of ``mxtpu/random.py`` (``seed``, ``next_key``,
``get_state``/``set_state``). The JAX package keeps one splittable
threefry key; here each device has its own ``torch.Generator``, seeded by
``seed`` and advanced by every draw (Dropout in training). The streams are
not threefry's: the same seed gives other bits than the JAX package, so
tests that compare the two feed both the same noise. As in mxtpu,
``seed`` does not touch numpy's global RNG.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator", "get_state", "set_state"]

_lock = threading.Lock()
_seed = 0
_gens = {}  # torch.device -> torch.Generator


def _key(device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def seed(seed_state):
    """Seed every device's generator (parity ``mx.random.seed``):
    generators made later start from the same seed."""
    global _seed
    with _lock:
        _seed = int(seed_state)
        for gen in _gens.values():
            gen.manual_seed(_seed)


def generator(device):
    """The generator of ``device`` (a torch.device or string), made and
    seeded on first use."""
    key = _key(device)
    with _lock:
        gen = _gens.get(key)
        if gen is None:
            gen = torch.Generator(device=key)
            gen.manual_seed(_seed)
            _gens[key] = gen
        return gen


def get_state():
    """``{device string: generator state}`` of every generator made so
    far; ``set_state`` of it replays the same draws."""
    with _lock:
        return {"seed": _seed,
                "generators": {str(k): g.get_state()
                               for k, g in _gens.items()}}


def set_state(state):
    """Restore a ``get_state`` capture."""
    global _seed
    _seed = int(state["seed"])
    for dev, st in state["generators"].items():
        generator(dev).set_state(st)
