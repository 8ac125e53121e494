"""Random sampling ops, drawn from the port's generators.

Counterpart of ``mxtpu/ops/random_ops.py``: the seven scalar-parameter
samplers ``_random_{uniform, normal, gamma, exponential, poisson,
negative_binomial, generalized_negative_binomial}`` (:34-59), the
per-row samplers ``sample_{uniform, normal, gamma, exponential, poisson,
negative_binomial, generalized_negative_binomial}`` (:96-138) and
``sample_multinomial`` (:141-166), each with mxtpu's arg names, attrs and
defaults. mxtpu draws from a threefry key; these ops draw from the
``torch.Generator`` of the output's device (``random.generator``, which
``OpDef.apply`` hands to a ``needs_rng`` op), so the same seed gives other
values than mxtpu's and the two are compared by their statistics. The
draws are made on that device: ``torch.rand``/``randn``, the native
``torch._standard_gamma``, ``torch.poisson``, ``exponential_`` and
``torch.multinomial``, all of which take the generator. The negative
binomials are Poisson draws over gamma-distributed rates, as mxtpu's.
"""
from __future__ import annotations

import torch

from .registry import register, torch_dtype

_SAMPLER_DEFAULTS = {"low": 0.0, "high": 1.0, "loc": 0.0, "scale": 1.0,
                     "lam": 1.0, "alpha": 1.0, "beta": 1.0, "k": 1,
                     "p": 1.0, "mu": 1.0, "sigma": 1.0}


def _dtype(name, default):
    """The ``dtype`` attr as a torch dtype ("None" or empty: ``default``)."""
    return default if name in (None, "", "None") else torch_dtype(name)


def _work_dtype(dtype):
    """The type the draws are made in: float64 for float64 output, else
    float32 (cast to ``dtype`` after)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _gamma(gen, alpha):
    """Gamma(alpha, 1) draws of ``alpha``'s shape."""
    return torch._standard_gamma(alpha, generator=gen)


def _poisson(gen, lam):
    return torch.poisson(lam, generator=gen)


def _uniform(gen, shape, dt, dev):
    return torch.rand(shape, generator=gen, dtype=dt, device=dev)


def _normal(gen, shape, dt, dev):
    return torch.randn(shape, generator=gen, dtype=dt, device=dev)


def _exponential(gen, shape, dt, dev):
    return torch.empty(shape, dtype=dt, device=dev).exponential_(
        1.0, generator=gen)


def _full(v, shape, dt, dev):
    return torch.full(shape, float(v), dtype=dt, device=dev)


def _neg_binomial(gen, k, p):
    """Poisson draws over Gamma(k) rates scaled by (1 - p) / p."""
    return _poisson(gen, _gamma(gen, k) * ((1 - p) / p))


def _gen_neg_binomial(gen, mu, alpha):
    """Poisson draws over Gamma(1/alpha) rates scaled by mu·alpha; where
    alpha is 0 (clamped at 1e-8), Poisson(mu) itself, as mxtpu."""
    safe = torch.clamp(alpha, min=1e-8)
    lam = _gamma(gen, 1.0 / safe) * (mu * safe)
    return _poisson(gen, torch.where(alpha <= 1e-8, mu, lam))


# ------------------------------------------------ scalar-parameter samplers
_SCALAR_DRAWS = {
    "uniform": (("low", "high"), lambda g, a, s, dt, dev:
                a.low + (a.high - a.low) * _uniform(g, s, dt, dev)),
    "normal": (("loc", "scale"), lambda g, a, s, dt, dev:
               a.loc + a.scale * _normal(g, s, dt, dev)),
    "gamma": (("alpha", "beta"), lambda g, a, s, dt, dev:
              a.beta * _gamma(g, _full(a.alpha, s, dt, dev))),
    "exponential": (("lam",), lambda g, a, s, dt, dev:
                    _exponential(g, s, dt, dev) / a.lam),
    "poisson": (("lam",), lambda g, a, s, dt, dev:
                _poisson(g, _full(a.lam, s, dt, dev))),
    "negative_binomial": (("k", "p"), lambda g, a, s, dt, dev:
                          _neg_binomial(g, _full(a.k, s, dt, dev),
                                        float(a.p))),
    "generalized_negative_binomial": (
        ("mu", "alpha"), lambda g, a, s, dt, dev:
        _gen_neg_binomial(g, _full(a.mu, s, dt, dev),
                          _full(a.alpha, s, dt, dev))),
}


def _sampler(name, lead, draw):
    """``_random_<name>``: no tensor inputs, ``shape`` draws of ``dtype``
    on the device of ``ctx``. The distribution's own parameters come
    first in the attrs, then shape, ctx and dtype, as mxtpu registers
    them (so positional calls map as the reference's signature)."""
    attrs = {k: _SAMPLER_DEFAULTS[k] for k in lead}
    attrs.update({"shape": (), "ctx": "", "dtype": "float32"})
    for k, v in _SAMPLER_DEFAULTS.items():
        attrs.setdefault(k, v)

    def impl(a, gen, device):
        shape = tuple(a.shape) if a.shape else ()
        dtype = _dtype(a.dtype, torch.float32)
        if gen is None:  # shape inference on meta tensors
            return torch.empty(shape, dtype=dtype, device=device)
        return draw(gen, a, shape, _work_dtype(dtype), device).to(dtype)

    register("_random_" + name, impl, arg_names=[], needs_rng=True,
             attrs=attrs)


for _name, (_lead, _draw) in _SCALAR_DRAWS.items():
    _sampler(_name, _lead, _draw)


# ------------------------------------------------ per-row samplers
def _rs(p, out_shape):
    """A per-row parameter tensor broadcast against the trailing sample
    dims."""
    return p.reshape(tuple(p.shape) + (1,) * (len(out_shape) - p.ndim)
                     ).expand(out_shape)


_ROW_DRAWS = {
    "uniform": (2, lambda g, ps, s: _uniform(g, s, ps[0].dtype, ps[0].device)
                * (ps[1] - ps[0]) + ps[0]),
    "normal": (2, lambda g, ps, s: ps[0] + ps[1] *
               _normal(g, s, ps[0].dtype, ps[0].device)),
    "gamma": (2, lambda g, ps, s: _gamma(g, ps[0].contiguous()) * ps[1]),
    "exponential": (1, lambda g, ps, s: _exponential(
        g, s, ps[0].dtype, ps[0].device) / ps[0]),
    "poisson": (1, lambda g, ps, s: _poisson(g, ps[0].contiguous())),
    "negative_binomial": (2, lambda g, ps, s: _neg_binomial(
        g, ps[0].contiguous(), ps[1])),
    "generalized_negative_binomial": (2, lambda g, ps, s: _gen_neg_binomial(
        g, ps[0], ps[1])),
}


def _multisampler(name, n_params, draw):
    """``sample_<name>``: the distribution's parameters are tensors, one
    distribution an element, each drawn ``shape`` times; the output is
    the parameters' shape + ``shape``, of ``dtype`` (else of the first
    parameter's type)."""

    def impl(a, gen, *params):
        shape = tuple(a.shape) if a.shape else ()
        out_shape = tuple(params[0].shape) + shape
        dtype = _dtype(a.dtype, params[0].dtype)
        if gen is None:
            return torch.empty(out_shape, dtype=dtype,
                               device=params[0].device)
        work = _work_dtype(dtype)
        ps = [_rs(p.to(work), out_shape) for p in params]
        return draw(gen, ps, out_shape).to(dtype)

    register("sample_" + name, impl,
             arg_names=["lhs", "rhs"] if n_params == 2 else ["data"],
             needs_rng=True, attrs={"shape": (), "dtype": "None"})


for _name, (_n, _draw) in _ROW_DRAWS.items():
    _multisampler(_name, _n, _draw)


def _sample_multinomial(a, gen, data):
    """``shape`` class draws (one when ``shape`` is empty, without a
    trailing axis) from each row of probabilities in ``data`` (1-D, or
    rows along the last axis; weights clamped at 1e-30, as mxtpu's
    logits); with ``get_prob``, also the log-probability of each drawn
    class."""
    n = int(a.shape[0]) if a.shape else 1
    lead = tuple(data.shape[:-1])
    out_shape = lead + ((n,) if a.shape else ())
    dtype = torch_dtype(a.dtype)
    if gen is None:
        out = torch.empty(out_shape, dtype=dtype, device=data.device)
        return (out, torch.empty(out_shape, device=data.device)) \
            if a.get_prob else out
    probs = torch.clamp(data.detach().to(torch.float32), min=1e-30
                        ).reshape(-1, data.shape[-1])
    idx = torch.multinomial(probs, n, replacement=True, generator=gen)
    out = idx.reshape(out_shape).to(dtype)
    if not a.get_prob:
        return out
    logp = torch.log_softmax(torch.log(probs), dim=-1).gather(1, idx)
    return out, logp.reshape(out_shape)


register("sample_multinomial", _sample_multinomial, arg_names=["data"],
         needs_rng=True,
         attrs={"shape": (), "get_prob": False, "dtype": "int32"},
         num_outputs=lambda a: 2 if a.get_prob else 1)
