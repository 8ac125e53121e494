"""The Gluon zoo of ``get_model`` in mxtpu_torch against mxtpu's: each
net (alexnet, densenet121, mobilenet1.0, squeezenet1.0, vgg16_bn; the
inceptionv3 case is in ``test_torch_zoo.py``) at the smallest input its
layers take, imperative and hybridized, against mxtpu's hybridized net,
the weights carried once by ``convert.gluon_params_from_mxtpu`` and once
by a ``.params`` file that mxtpu's Gluon saved: outputs within 1e-5 of
the largest logit, and the hybridized net's fused BatchNorm->ReLU
sites. Then ``pretrained=True``: ``<root>/<name>.params`` from a local
root, ``MXNetError`` when the file is missing, and ``model_store``'s
helpers. Most of the time is mxtpu's first hybridized forward (its
compile: ~10-35 s a net on one CPU thread)."""
import os

import numpy as np
import pytest

import mxtpu as mx

ATOL = 1e-5


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


# (name, input edge, fused sites of the hybridized inference forward)
GLUON = [("alexnet", 63, 0), ("densenet121", 32, 121),
         ("mobilenet1.0", 32, 27), ("squeezenet1.0", 32, 0),
         ("vgg16_bn", 32, 13)]


def _mxtpu_net(name, edge, seed):
    """mxtpu's net, hybridized, with its shapes resolved by one forward
    (one compile: the weights are the program's inputs), then random BN
    statistics, betas and gammas; returns (net, input, output)."""
    net = mx.gluon.model_zoo.vision.get_model(name, classes=10)
    net.initialize(mx.init.Xavier())
    net.hybridize()
    x = np.random.RandomState(seed).rand(1, 3, edge, edge).astype(np.float32)
    net(mx.nd.array(x))
    rng = np.random.RandomState(seed + 1)
    for pname, p in net.collect_params().items():
        shape = p.data().shape
        if pname.endswith("running_mean") or pname.endswith("beta"):
            p.set_data(mx.nd.array(rng.uniform(-0.1, 0.1, shape)))
        elif pname.endswith("running_var") or pname.endswith("gamma"):
            p.set_data(mx.nd.array(rng.uniform(0.5, 1.5, shape)))
    return net, x, net(mx.nd.array(x)).asnumpy()


def _close(got, want):
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * scale)


def check_gluon_net(mt, tmp_path, name, edge, sites):
    """The port's ``name`` imperative (weights by
    ``gluon_params_from_mxtpu``) and hybridized (weights from mxtpu's
    ``.params`` file) against mxtpu's hybridized net."""
    jnet, x, want = _mxtpu_net(name, edge, seed=len(name))
    path = str(tmp_path / "net.params")
    jnet.save_params(path)
    prefix = jnet.prefix
    stripped = {k[len(prefix):]: v.data().asnumpy()
                for k, v in jnet.collect_params().items()}
    v = mt.gluon.model_zoo.vision
    with mt.cpu():
        imperative = v.get_model(name, classes=10)
        mt.convert.gluon_params_from_mxtpu(stripped, mt.cpu(), imperative)
        _close(imperative(mt.nd.array(x)).asnumpy(), want)
        hybrid = v.get_model(name, classes=10)
        hybrid.load_params(path, ctx=mt.cpu())
        hybrid.hybridize()
        _close(hybrid(mt.nd.array(x)).asnumpy(), want)
        assert hybrid.fused_sites == sites


@pytest.mark.parametrize("name,edge,sites", GLUON, ids=[g[0] for g in GLUON])
def test_gluon_zoo_net_matches_mxtpu(mt, tmp_path, name, edge, sites):
    check_gluon_net(mt, tmp_path, name, edge, sites)


def test_pretrained_loads_from_the_local_root(mt, tmp_path, monkeypatch):
    """``pretrained=True`` reads ``~/.mxnet/models/<name>.params`` (a file
    mxtpu's Gluon saved) and never downloads; a missing file raises."""
    jnet, x, want = _mxtpu_net("squeezenet1.1", 32, seed=5)
    root = tmp_path / ".mxnet" / "models"
    root.mkdir(parents=True)
    jnet.save_params(str(root / "squeezenet1.1.params"))
    monkeypatch.setenv("HOME", str(tmp_path))
    v = mt.gluon.model_zoo.vision
    store = mt.gluon.model_zoo.model_store
    with mt.cpu():
        net = v.get_model("squeezenet1.1", pretrained=True, classes=10,
                          ctx=mt.cpu())
        _close(net(mt.nd.array(x)).asnumpy(), want)
        with pytest.raises(mt.MXNetError, match="not found"):
            v.mobilenet0_25(pretrained=True, ctx=mt.cpu())
        with pytest.raises(mt.MXNetError, match="pretrained"):
            v.resnet18_v1(pretrained=True)
    assert store.get_model_file("squeezenet1.1") == \
        str(root / "squeezenet1.1.params")
    assert store.get_model_file("squeezenet1.1", root=str(root)) == \
        mx.gluon.model_zoo.model_store.get_model_file("squeezenet1.1",
                                                      root=str(root))
    store.purge(str(root))
    assert os.listdir(str(root)) == []
    with pytest.raises(mt.MXNetError, match="not found"):
        store.get_model_file("squeezenet1.1")
