"""Global random state: one torch.Generator chain per device.

Counterpart of ``mxtpu/random.py`` (``seed``, ``next_key``,
``get_state``/``set_state``). The JAX package keeps one splittable
threefry key; here each device has its own ``torch.Generator``, seeded by
``seed`` and advanced by every draw (Dropout in training). The streams are
not threefry's: the same seed gives other bits than the JAX package, so
tests that compare the two feed both the same noise, or compare
statistics. As in mxtpu, ``seed`` does not touch numpy's global RNG.

The samplers ``uniform``, ``normal``, ``gamma``, ``exponential``,
``poisson``, ``negative_binomial``, ``generalized_negative_binomial``
and ``multinomial`` (mxtpu/random.py:77-126) call the ``_random_*`` and
``sample_multinomial`` ops (``ops/random_ops.py``) with mxtpu's
signatures; ``ctx`` (default: the current context) is where the values
are drawn and stay.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator", "get_state", "set_state", "uniform",
           "normal", "gamma", "exponential", "poisson", "negative_binomial",
           "generalized_negative_binomial", "multinomial"]

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


# ------------------------------------------------- module-level samplers
# (late imports: ndarray imports this module through the op registry)
def _draw(op, ctx, **attrs):
    from .ndarray import invoke_op
    return invoke_op(op, [], dict(attrs, ctx=ctx))[0]


def uniform(low=0.0, high=1.0, shape=(1,), dtype="float32", ctx=None):
    return _draw("_random_uniform", ctx, low=float(low), high=float(high),
                 shape=shape, dtype=dtype)


def normal(loc=0.0, scale=1.0, shape=(1,), dtype="float32", ctx=None):
    return _draw("_random_normal", ctx, loc=float(loc), scale=float(scale),
                 shape=shape, dtype=dtype)


def gamma(alpha=1.0, beta=1.0, shape=(1,), dtype="float32", ctx=None):
    return _draw("_random_gamma", ctx, alpha=float(alpha), beta=float(beta),
                 shape=shape, dtype=dtype)


def exponential(lam=1.0, shape=(1,), dtype="float32", ctx=None):
    return _draw("_random_exponential", ctx, lam=float(lam), shape=shape,
                 dtype=dtype)


def poisson(lam=1.0, shape=(1,), dtype="float32", ctx=None):
    return _draw("_random_poisson", ctx, lam=float(lam), shape=shape,
                 dtype=dtype)


def negative_binomial(k=1, p=1.0, shape=(1,), dtype="float32", ctx=None):
    return _draw("_random_negative_binomial", ctx, k=int(k), p=float(p),
                 shape=shape, dtype=dtype)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=(1,),
                                  dtype="float32", ctx=None):
    return _draw("_random_generalized_negative_binomial", ctx,
                 mu=float(mu), alpha=float(alpha), shape=shape, dtype=dtype)


def multinomial(data, shape=(), get_prob=False, dtype="int32"):
    """Class draws from each row of probabilities in ``data`` (an
    NDArray), on its device; with ``get_prob`` also their
    log-probabilities."""
    from .ndarray import invoke_op
    out = invoke_op("sample_multinomial", [data],
                    {"shape": shape, "get_prob": get_prob, "dtype": dtype})
    return out if get_prob else out[0]
