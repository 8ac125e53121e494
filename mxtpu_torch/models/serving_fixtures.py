"""Zoo models packaged as serving fixtures.

Counterpart of ``mxtpu/models/serving_fixtures.py``. Each fixture is
(symbol_json, params, example_shapes): an inference graph, random weights
in the checkpoint ``arg:``/``aux:`` naming as numpy arrays, and
per-request input shapes with a leading batch dim of 1, which is what
``ServingSession`` and ``Predictor`` take. The weights are drawn from the
same ``numpy.random.RandomState`` stream as the JAX package's, so one seed
gives both packages the same values.
"""
from __future__ import annotations

import numpy as _np

from . import lenet as _lenet
from . import mlp as _mlp
from . import resnet as _resnet

__all__ = ["FIXTURES", "get_fixture"]


def _init_params(symbol, example_shapes, seed=0):
    """Xavier-ish random weights for every non-input arg + aux state."""
    rng = _np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = symbol.infer_shape(**example_shapes)
    params = {}
    for name, shape in zip(symbol.list_arguments(), arg_shapes):
        if name in example_shapes:
            continue
        fan_in = int(_np.prod(shape[1:])) if len(shape) > 1 else shape[0]
        scale = 1.0 / max(1.0, _np.sqrt(fan_in))
        params["arg:" + name] = rng.uniform(
            -scale, scale, size=shape).astype(_np.float32)
    for name, shape in zip(symbol.list_auxiliary_states(), aux_shapes):
        # moving_var-style states must be positive
        params["aux:" + name] = _np.ones(shape, dtype=_np.float32) \
            if "var" in name else _np.zeros(shape, dtype=_np.float32)
    return params


def _mlp_fixture():
    return _mlp.get_symbol(num_classes=10), {"data": (1, 784)}


def _lenet_fixture():
    return _lenet.get_symbol(num_classes=10), {"data": (1, 1, 28, 28)}


def _resnet_fixture():
    # small-image resnet-8: the smallest legal (num_layers-2) % 6 == 0
    # depth on the <=28px three-stage path
    sym = _resnet.get_symbol(num_classes=10, num_layers=8,
                             image_shape=(3, 28, 28))
    return sym, {"data": (1, 3, 28, 28)}


FIXTURES = {
    "mlp": _mlp_fixture,
    "lenet": _lenet_fixture,
    "resnet": _resnet_fixture,
}


def get_fixture(name, seed=0):
    """(symbol_json, params, example_shapes) for a named zoo fixture."""
    if name not in FIXTURES:
        raise KeyError("unknown serving fixture %r (have %s)"
                       % (name, sorted(FIXTURES)))
    sym, shapes = FIXTURES[name]()
    params = _init_params(sym, shapes, seed=seed)
    return sym.tojson(), params, shapes
