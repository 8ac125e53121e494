"""The rest of the image zoo in mxtpu_torch against mxtpu.

- The four symbolic models (googlenet, inception_v3, inception_v4,
  inception_resnet_v2) served at full width and B=1 through the port's
  ``Predictor`` on cpu() against ``mxtpu.predict.Predictor`` from the
  same weights and random, non-trivial BatchNorm statistics: atol 1e-5
  on the probabilities. Their graphs and fused-site counts are rows of
  ``test_torch_models.py``.
- Gluon's inceptionv3 at 299x299 as ``test_torch_zoo_gluon.py`` holds
  the other zoo nets (here, so that the two files' mxtpu compiles land
  on different test workers).
- ``get_model`` builds every name of mxtpu's table.
"""
import numpy as np
import pytest

import mxtpu as mx
from test_torch_zoo_gluon import check_gluon_net

ATOL = 1e-5


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


def _params(sym, shape, seed):
    """He-scaled weights and random BN parameters and statistics (numpy,
    mxtpu's checkpoint naming); the classifier at 1/fan_in."""
    rng = np.random.RandomState(seed)
    args, _, aux = sym.infer_shape(data=shape)
    params = {}
    for n, s in zip(sym.list_arguments(), args):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_gamma"):
            v = rng.uniform(0.5, 1.5, s)
        elif n.endswith(("_beta", "_bias")):
            v = rng.uniform(-0.1, 0.1, s)
        elif n.startswith("fc"):
            v = rng.randn(*s) / np.sqrt(np.prod(s[1:]))
        else:
            v = rng.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))
        params["arg:" + n] = v.astype(np.float32)
    for n, s in zip(sym.list_auxiliary_states(), aux):
        v = rng.randn(*s) * 0.1 if n.endswith("_moving_mean") else \
            rng.uniform(0.5, 1.5, s)
        params["aux:" + n] = v.astype(np.float32)
    return params


SYMBOLIC = [("googlenet", (1, 3, 224, 224), 0),
            ("inception_v3", (1, 3, 299, 299), 94),
            ("inception_v4", (1, 3, 299, 299), 149),
            ("inception_resnet_v2", (1, 3, 299, 299), 204)]


@pytest.mark.parametrize("name,shape,sites", SYMBOLIC,
                         ids=[s[0] for s in SYMBOLIC])
def test_symbolic_model_served_at_full_width_matches_mxtpu(mt, name, shape,
                                                           sites):
    jsym = getattr(mx.models, name).get_symbol(num_classes=1000)
    js = getattr(mt.models, name).get_symbol(num_classes=1000).tojson()
    params = _params(jsym, shape, seed=sites + 1)
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    ref = mx.predict.Predictor(jsym.tojson(),
                               {k: mx.nd.array(v) for k, v in params.items()},
                               ctx=mx.cpu(), input_shapes={"data": shape})
    ref.forward(data=x)
    want = ref.get_output(0)
    pred = mt.Predictor(js, mt.convert.params_from_mxtpu(params, mt.cpu()),
                        ctx=mt.cpu(), input_shapes={"data": shape})
    assert pred._executor.fused_sites == sites
    pred.forward(data=x)
    got = pred.get_output(0)
    assert got.shape == want.shape == (1, 1000)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_gluon_inceptionv3_matches_mxtpu(mt, tmp_path):
    check_gluon_net(mt, tmp_path, "inceptionv3", 299, 94)


def test_get_model_builds_every_name_of_mxtpus_table(mt):
    table = mx.gluon.model_zoo.vision._models
    v = mt.gluon.model_zoo.vision
    assert sorted(v._models) == sorted(table)
    for name in sorted(table):
        net = v.get_model(name.upper() if name == "alexnet" else name)
        assert type(net).__name__ == type(
            mx.gluon.model_zoo.vision.get_model(name)).__name__, name
    with pytest.raises(ValueError, match="not supported"):
        v.get_model("resnet19_v1")
