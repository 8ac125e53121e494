"""The inputs of the eight update ops' cases (``mxtpu/ops/
optimizer_ops.py``), numpy only: ``(op, inputs, attrs)``, with rescaling,
clipping, weight decay and float16 weights with float32 masters, so that
``test_torch_optimizer_ops.py`` holds them against mxtpu on the CPU and
``test_torch_cuda.py`` runs them on the card against the CPU."""
import numpy as np


def _r(seed, scale=1.0, shape=(3, 5)):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _pos(seed):
    return np.abs(_r(seed)) + 0.1


_W, _G = _r(0), _r(1, 3.0)
_CLIP = {"rescale_grad": 0.5, "clip_gradient": 1.0, "wd": 0.01}

UPDATE_CASES = [
    ("sgd_update", [_W, _G], {"lr": 0.1}),
    ("sgd_update", [_W, _G], dict(_CLIP, lr=0.1)),
    ("sgd_mom_update", [_W, _G, _r(2)], {"lr": 0.1, "momentum": 0.9}),
    ("sgd_mom_update", [_W, _G, _r(2)], dict(_CLIP, lr=0.05, momentum=0.5)),
    ("mp_sgd_update", [_W.astype(np.float16), _G.astype(np.float16), _W],
     dict(_CLIP, lr=0.1)),
    ("mp_sgd_mom_update", [_W.astype(np.float16), _G.astype(np.float16),
                           _r(2), _W], {"lr": 0.1, "momentum": 0.9}),
    ("adam_update", [_W, _G, _r(3, 0.1), _pos(4)], {"lr": 0.01}),
    ("adam_update", [_W, _G, _r(3, 0.1), _pos(4)],
     dict(_CLIP, lr=0.01, beta1=0.8, beta2=0.99, epsilon=1e-6)),
    ("rmsprop_update", [_W, _G, _pos(5)], {"lr": 0.01}),
    ("rmsprop_update", [_W, _G, _pos(5)],
     dict(_CLIP, lr=0.01, gamma1=0.9, clip_weights=0.5)),
    ("rmspropalex_update", [_W, _G, _pos(5) + 1, _r(6, 0.1), _r(7, 0.1)],
     {"lr": 0.01}),
    ("rmspropalex_update", [_W, _G, _pos(5) + 1, _r(6, 0.1), _r(7, 0.1)],
     dict(_CLIP, lr=0.01, gamma2=0.8, clip_weights=0.5)),
    ("ftrl_update", [_W, _G, _r(8), _pos(9)], {"lr": 0.1}),
    ("ftrl_update", [_W, _G, _r(8), _pos(9)],
     dict(_CLIP, lr=0.1, lamda1=0.5, beta=2.0)),
]
